"""Fused log-mel front end: host side of K1 (port of efficientat_tpu/ops/mel_pallas.py).

K1 (``csrc/mel_kernel.cu``) computes, for each clip and each tile of frames,
frames of the raw wave x the pre-emphasis-folded windowed rDFT basis (no
Nyquist bin) -> power -> x banks^T -> ``(log(x + 1e-5) + 4.5) / 5``, written
as (B, n_mels, n_frames). The frames whose window reaches the reflect pad (at
most 4 a clip) are recomputed here in plain PyTorch with the exact reference
math and patched in, as the JAX wrapper does. K1 runs the DFT on the
tensor cores as products of bf16 parts: it takes the basis's bf16 parts
transposed to (columns, samples) (``_folded_basis_t``), two for ``"bf16x3"``
(the JAX package's 3-pass split) and three for ``"fp32"`` (the 6-pass split
the TPU runs for ``Precision.HIGHEST``), and reads its frames from rows made
here (``_frame_rows``): the wave behind a zero pad, 16-byte aligned.

``stft_log_mel`` launches K1 for a CUDA tensor and runs its plain PyTorch
version, ``stft_log_mel_plain``, for a CPU tensor; nothing else chooses
between them. ``stft_log_mel_sharded`` is K1-dp, the port of
``stft_log_mel_pallas_sharded``: K1 on one data-parallel rank's rows.
``log_mel_spectrogram_fused`` picks K1 or the plain melspec path
(``ops.melspec``) from the config, the device and the clip's length only
(``auto_takes_kernel``). In training it feeds
K1 the jittered banks and masks K1's normalised output with 0.9, the value
a masked log-mel cell of 0 takes after ``(x + 4.5) / 5``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from efficientat_tpu_torch.ops.filterbank import kaldi_mel_banks
from efficientat_tpu_torch.ops.melspec import (
    PREEMPH,
    MelConfig,
    MelDraws,
    _edge_power,
    _folded_dft_basis,
    apply_masks,
    device_const,
    edge_frames,
    frame_signal,
    jittered_fmin_fmax,
    log_mel_spectrogram,
    true_fp32,
)

# bf16 parts of K1's split operands by dft_precision: the products of parts
# i and j, i + j < parts, make fp32's 6 passes and bf16x3's 3
PARTS = {"fp32": 3, "bf16x3": 2}
DFT_PRECISIONS = tuple(PARTS)
# the edge patch reads 2 * n_fft-sample slivers from both ends of the clip
MIN_SAMPLES = 4096
# mels a launch (K1's mel accumulators: 64 a thread, 64 or 128 frames a
# block); a wider bank takes one launch for each group of as many
MELS_A_LAUNCH = 256
MAX_ROWS = 65535  # clips a launch: the grid's y limit; a larger batch is sliced

# K1 launches in this process by dft_precision; a run sets them to 0 and
# reads them after
LAUNCHES = dict.fromkeys(DFT_PRECISIONS, 0)


def kernel_supported(cfg: MelConfig) -> bool:
    """Configs the JAX kernel computes: n_fft 1024 and hop 320 or 640."""
    return cfg.n_fft == 1024 and cfg.hopsize in (320, 640)


def auto_takes_kernel(cfg: MelConfig, device_type: str, n_samples: int) -> bool:
    """``log_mel_spectrogram_fused(backend="auto")``'s choice: K1 for a wave
    on CUDA, a config K1 computes (``kernel_supported``, any n_mels) and a
    clip of at least ``MIN_SAMPLES``; the melspec path otherwise."""
    return (device_type == "cuda" and kernel_supported(cfg)
            and n_samples >= MIN_SAMPLES)


@lru_cache(maxsize=8)
def _folded_basis_no_nyquist(n_fft: int, win_length: int,
                             coef: float = PREEMPH) -> np.ndarray:
    """Pre-emphasis-folded windowed rDFT basis, Nyquist bin dropped:
    (n_fft, n_fft), cos columns then sin columns, fp32 from float64."""
    full = _folded_dft_basis(n_fft, win_length, coef)
    n_freq = n_fft // 2 + 1
    return np.ascontiguousarray(np.concatenate(
        [full[:, :n_freq - 1], full[:, n_freq:2 * n_freq - 1]], axis=1))


def bf16_split(x: torch.Tensor, parts: int) -> list[torch.Tensor]:
    """K1's split of an fp32 operand into ``parts`` bf16 tensors: part 0 is
    bf16(x), part p the bf16 of what parts 0 .. p-1 leave (each difference
    is exact in fp32). Two parts, bf16x3's hi and lo, carry about 16
    significand bits; three, fp32's hi, mid and lo, all 24."""
    out = []
    for _ in range(parts):
        out.append(x.to(torch.bfloat16))
        x = x - out[-1].to(torch.float32)
    return out


def bf16_part(basis: np.ndarray, part: int) -> np.ndarray:
    """Part ``part`` of ``bf16_split(basis)``, as fp32 numpy holding bf16
    values."""
    return bf16_split(torch.from_numpy(basis), part + 1)[part].to(torch.float32).numpy()


@lru_cache(maxsize=8)
def _folded_basis_split(n_fft: int, win_length: int, part: int) -> np.ndarray:
    """``bf16_part`` of the folded basis."""
    return bf16_part(_folded_basis_no_nyquist(n_fft, win_length), part)


@lru_cache(maxsize=8)
def _folded_basis_t(n_fft: int, win_length: int, part: int) -> np.ndarray:
    """K1's basis operand: ``_folded_basis_split`` transposed to (columns,
    samples), so that a thread reads 8 samples of one column as one 16-byte
    copy."""
    return np.ascontiguousarray(_folded_basis_split(n_fft, win_length, part).T)


def _frame_rows(wave: torch.Tensor, cfg: MelConfig, n_frames: int) -> torch.Tensor:
    """K1's rows, frame i at ``hop * i``: the raw wave behind an
    ``n_fft // 2`` zero pad, zero-padded to hold the last frame whole and to
    a multiple of 4 samples (16-byte aligned rows). One copy of the wave."""
    pad = cfg.n_fft // 2
    need = max(cfg.hopsize * (n_frames - 1) + cfg.n_fft, pad + wave.shape[1])
    row_len = -(-need // 4) * 4
    return F.pad(wave, (pad, row_len - pad - wave.shape[1]))


def _edge_frames_logmel(wave: torch.Tensor, banks: torch.Tensor,
                        cfg: MelConfig, left_f, right_f) -> torch.Tensor:
    """Exact fp32 log-mel rows (B, n_edge, n_mels) for the frames whose
    window touches the reflect-pad region — the one place where the
    folded-basis kernel, which sees a zero pad, differs from the reference
    math. Computed on 2048-sample slivers; at most 4 frames a clip."""
    power = _edge_power(wave, cfg.n_fft, cfg.hopsize, cfg.win_length,
                        left_f, right_f)
    with true_fp32():
        mel = power @ banks.t()
    return (torch.log(mel + 1e-5) + 4.5) / 5.0


def _patch_edges(out: torch.Tensor, wave: torch.Tensor, banks: torch.Tensor,
                 cfg: MelConfig) -> torch.Tensor:
    """Overwrite the reflect-pad edge frames of ``out`` (B, n_mels, frames)."""
    n_frames = out.shape[2]
    left_f, right_f = edge_frames(n_frames, cfg.hopsize, cfg.n_fft,
                                  wave.shape[1] - 1)
    if left_f or right_f:
        edge = _edge_frames_logmel(wave, banks, cfg, left_f, right_f)
        edge = edge.transpose(1, 2)
        nl = len(left_f)
        out[:, :, :nl] = edge[:, :, :nl]
        if right_f:
            out[:, :, right_f[0]:right_f[-1] + 1] = edge[:, :, nl:]
    return out


def _check_args(wave: torch.Tensor, banks: torch.Tensor, cfg: MelConfig,
                dft_precision: str) -> None:
    if dft_precision not in DFT_PRECISIONS:
        raise ValueError(f"dft_precision must be one of {DFT_PRECISIONS}, "
                         f"got {dft_precision!r}")
    if not kernel_supported(cfg):
        raise ValueError(f"K1 supports n_fft 1024 and hop 320/640, got {cfg}")
    if wave.dim() != 2 or wave.shape[1] < MIN_SAMPLES:
        raise ValueError(f"K1 takes (B, S >= {MIN_SAMPLES}) waves, got "
                         f"{tuple(wave.shape)}")
    if banks.shape != (cfg.n_mels, cfg.n_freqs):
        raise ValueError(f"banks must be {(cfg.n_mels, cfg.n_freqs)}, got "
                         f"{tuple(banks.shape)}")


def stft_log_mel_plain(wave: torch.Tensor, banks: torch.Tensor, cfg: MelConfig,
                       dft_precision: str = "fp32") -> torch.Tensor:
    """K1's function in plain PyTorch: (B, S) f32 -> (B, n_mels, n_frames).

    The same function as the kernel, on any device: frames of the raw wave
    with a zero pad, the folded basis (split into bf16 hi/lo for
    ``"bf16x3"``, with the frames split the same way and hi*hi + (hi*lo +
    lo*hi) summed in fp32; one exact fp32 GEMM for ``"fp32"``, which the
    kernel's six bf16 products match), power, fp32 mel GEMM, log,
    normalisation, edge patch. The default is exact fp32, as
    ``stft_log_mel_pallas``'s is HIGHEST."""
    _check_args(wave, banks, cfg, dft_precision)
    n_fft, hop = cfg.n_fft, cfg.hopsize
    n_bins = n_fft // 2
    n_frames = cfg.num_frames(wave.shape[1])
    device = str(wave.device)
    frames = frame_signal(wave, n_fft, hop, n_frames, pad_mode="constant")
    banks_t = banks[:, :n_bins].t()
    with true_fp32():
        if dft_precision == "bf16x3":
            bhi, blo = (device_const(_folded_basis_split,
                                     (n_fft, cfg.win_length, p), device)
                        for p in (0, 1))
            fh, fl = (f.to(torch.float32) for f in bf16_split(frames, 2))
            proj = fh @ bhi + (fh @ blo + fl @ bhi)
        else:
            proj = frames @ device_const(_folded_basis_no_nyquist,
                                         (n_fft, cfg.win_length), device)
        power = proj[..., :n_bins] ** 2 + proj[..., n_bins:] ** 2
        mel = power @ banks_t
    out = ((torch.log(mel + 1e-5) + 4.5) / 5.0).transpose(1, 2).contiguous()
    return _patch_edges(out, wave, banks, cfg)


def stft_log_mel(wave: torch.Tensor, banks: torch.Tensor, cfg: MelConfig,
                 dft_precision: str = "fp32") -> torch.Tensor:
    """Raw waveform (B, S) f32 -> normalized log-mel (B, n_mels, n_frames).

    On a CUDA tensor this launches K1 or raises, once for each slice of at
    most ``MAX_ROWS`` clips; on a CPU tensor it runs ``stft_log_mel_plain``.
    ``banks`` is the (n_mels, n_fft//2+1) Kaldi bank; its zero Nyquist
    column is dropped inside. ``dft_precision`` defaults to exact fp32, as
    ``stft_log_mel_pallas``'s does. A bank of more than ``MELS_A_LAUNCH``
    mels takes one launch for each group of as many."""
    if wave.device.type == "cpu":
        return stft_log_mel_plain(wave, banks, cfg, dft_precision)
    _check_args(wave, banks, cfg, dft_precision)
    if wave.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors, got {wave.device}")
    if wave.dtype != torch.float32 or not wave.is_contiguous():
        raise ValueError("K1 takes a contiguous float32 wave, got "
                         f"{wave.dtype}, contiguous={wave.is_contiguous()}")
    if banks.device != wave.device or banks.dtype != torch.float32:
        raise ValueError("banks must be float32 on the wave's device")
    from efficientat_tpu_torch.ops._build import load_library

    lib = _bind(load_library("mel_kernel"))
    n_fft, hop = cfg.n_fft, cfg.hopsize
    n_bins = n_fft // 2
    batch, n_samples = wave.shape
    n_frames = cfg.num_frames(n_samples)
    device = str(wave.device)
    banks_t = banks[:, :n_bins].t()
    groups = [(m0, banks_t[:, m0:m0 + MELS_A_LAUNCH].contiguous())
              for m0 in range(0, cfg.n_mels, MELS_A_LAUNCH)]
    parts = PARTS[dft_precision]
    basis = [device_const(_folded_basis_t, (n_fft, cfg.win_length, p), device,
                          torch.bfloat16).data_ptr() for p in range(parts)]
    basis += [None] * (3 - parts)  # bf16x3 reads no third part
    x = _frame_rows(wave, cfg, n_frames)
    out = torch.empty((batch, cfg.n_mels, n_frames), device=wave.device,
                      dtype=torch.float32)
    stream = torch.cuda.current_stream(wave.device).cuda_stream
    for start in range(0, batch, MAX_ROWS):
        rows = min(MAX_ROWS, batch - start)
        for m0, bt in groups:
            err = lib.eat_mel_log(x[start].data_ptr(), rows, x.shape[1], hop,
                                  n_frames, *basis, parts, bt.data_ptr(),
                                  bt.shape[1], out[start, m0].data_ptr(),
                                  cfg.n_mels, stream)
            if err != 0:
                raise RuntimeError("K1 launch failed: "
                                   + lib.eat_error_string(err).decode())
            LAUNCHES[dft_precision] += 1
    return _patch_edges(out, wave, banks, cfg)


def stft_log_mel_sharded(wave_local: torch.Tensor, banks: torch.Tensor,
                         cfg: MelConfig,
                         dft_precision: str = "fp32") -> torch.Tensor:
    """K1-dp: K1 on this rank's rows of a batch split over the ranks of the
    default process group (port of ``stft_log_mel_pallas_sharded``, which
    ``shard_map``s K1 over the ``data`` mesh axis).

    ``wave_local`` holds this rank's rows; ``banks`` must be the same on
    every rank (the train step draws the jitter from identically seeded
    generators, so no broadcast is needed). The ranks' outputs, concatenated
    in rank order, equal ``stft_log_mel`` on the whole batch. On a CPU tensor
    it runs K1's plain version, as ``stft_log_mel`` does."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("stft_log_mel_sharded needs an initialised "
                           "torch.distributed process group")
    return stft_log_mel(wave_local, banks, cfg, dft_precision)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.eat_mel_log.argtypes = [p, i, i, i, i, p, p, p, i, p, i, p, i, p]
    lib.eat_mel_log.restype = i
    lib.eat_error_string.argtypes = [i]
    lib.eat_error_string.restype = ctypes.c_char_p
    return lib


def log_mel_spectrogram_fused(waveform: torch.Tensor,
                              cfg: MelConfig = MelConfig(), *,
                              training: bool = False,
                              draws: MelDraws | None = None,
                              backend: str = "auto",
                              dft_precision: str | None = None,
                              sharded: bool = False) -> torch.Tensor:
    """Drop-in for ``ops.melspec.log_mel_spectrogram`` with a K1 path.

    backend: ``"kernel"`` (``stft_log_mel``: K1 on CUDA, its plain version
    on CPU), ``"plain"`` (the melspec path), or ``"auto"``
    (``auto_takes_kernel``: K1 when the wave is on CUDA, the config is one
    K1 computes and the clip has at least 4096 samples, the melspec path
    otherwise).

    ``training=True`` needs ``draws`` (this call's rows of them): K1 gets the
    jittered fp32 banks as its runtime input and its output is masked with
    0.9. ``sharded=True`` runs K1 as K1-dp (``stft_log_mel_sharded``), as
    the JAX step does under a mesh of more than one device.

    dft_precision defaults to ``"bf16x3"``, the serving and training default
    of the JAX package's ``log_mel_spectrogram_fused``; ``"fp32"`` is exact
    fp32. The melspec path is always fp32.
    """
    if training and draws is None:
        raise ValueError("training=True requires draws (see draw_mel_augment)")
    if backend not in ("auto", "kernel", "plain"):
        raise ValueError(f"backend must be auto, kernel or plain, got {backend!r}")
    use_kernel = backend == "kernel" or (backend == "auto" and auto_takes_kernel(
        cfg, waveform.device.type, waveform.shape[-1]))
    if not use_kernel:
        return log_mel_spectrogram(waveform, cfg, training=training,
                                   draws=draws)
    fmin, fmax = (jittered_fmin_fmax(cfg, draws, waveform.device) if training
                  else (cfg.fmin, cfg.effective_fmax))
    banks = kaldi_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sr, fmin, fmax,
                            device=waveform.device)
    run = stft_log_mel_sharded if sharded else stft_log_mel
    mel = run(waveform.to(torch.float32).contiguous(), banks, cfg,
              dft_precision or "bf16x3")
    if training:
        mel = apply_masks(mel, cfg, draws, 0.9)
    return mel
