"""Fused log-mel front end: host side of K1 (port of efficientat_tpu/ops/mel_pallas.py).

K1 (``csrc/mel_kernel.cu``) computes, for each clip and each tile of frames,
frames of the caller's raw wave, read in place, x the pre-emphasis-folded
windowed rDFT basis (no Nyquist bin) -> power -> x banks^T -> ``(log(x +
1e-5) + 4.5) / 5``, written as (B, n_mels, n_frames). The frames whose window
reaches the reflect pad (at most 4 a clip) are recomputed from the fp32
operands of the reference math and written over K1's by ``mel_edges`` (the
``mel_edges`` kernel), as the JAX wrapper patches them. K1 runs the DFT on the
tensor cores as products of bf16 parts: bf16x3 (the JAX package's 3-pass
split, the serving and training default) or fp32 (the 6-pass split the TPU
runs for ``Precision.HIGHEST``), on ``eat_mel_log_wgmma``, the Hopper design
of ``csrc/mel_wgmma.cuh`` (``wgmma`` DFT, the basis through a bulk-copy
ring, the mel product on the tensor cores at fp32's precision: power and
banks in three bf16 parts, six products). Its instantiation holds 128 or
256 mels; a wider bank takes one launch for each group of ``MELS_A_LAUNCH``
mels, each on the narrowest instantiation that holds it (``mel_groups``).
A launch's route, picked from the arguments alone, names its instantiation:
``"wgmma"`` (bf16x3) and ``"wgmma_fp32"`` at up to 128 mels,
``"wgmma256"`` and ``"wgmma256_fp32"`` at 129-256; ``k1_route`` is a
call's widest. The operands are made here: the folded basis's bf16 parts
(two, or three for fp32) pre-tiled for the ring (``_tiled_basis``), each
group's banks^T in three bf16 parts, tiled (``_tiled_banks``, one tensor a
group, ``_tiled_groups``; the fixed serving banks once a config and
device on the host, ``tiled_serving_banks``; a training call's jittered
banks on the card by the ``tile_banks`` kernel, ``tile_banks``). The
probe's rows, which hold every frame of the last 128-frame block, are
``_block_rows``.

So a K1 call on a CUDA tensor launches only hand-written kernels:
``tile_banks`` (when the call tiles its banks), one ``mel_kernel_wgmma`` a
mel group, and ``mel_edges``; nothing else runs on the card but
``torch.empty`` for the outputs and scratch (and one copy of the wave where
its rows are not 16-byte aligned, ``_k1_rows``; once a stream, the zeroing
of ``mel_edges``' counts, ``_edge_done``).

``stft_log_mel`` launches K1 for a CUDA tensor and runs its plain PyTorch
version, ``stft_log_mel_plain``, for a CPU tensor; nothing else chooses
between them (``tile_banks`` and ``mel_edges`` the same: ``_tiled_groups``
and ``_patch_edges`` are their plain versions). ``stft_log_mel_sharded`` is
K1-dp, the port of ``stft_log_mel_pallas_sharded``: K1 on one data-parallel
rank's rows. ``log_mel_spectrogram_fused`` picks K1 or the plain melspec path
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
    _dft_basis,
    _edge_power,
    _folded_dft_basis,
    apply_masks,
    device_const,
    edge_frames,
    frame_signal,
    jittered_fmin_fmax,
    log_mel_spectrogram,
    preemphasis,
    true_fp32,
)
from efficientat_tpu_torch.utils.profiling import count, counter, span

# bf16 parts of K1's split operands by dft_precision: the products of parts
# i and j, i + j < parts, make fp32's 6 passes and bf16x3's 3
PARTS = {"fp32": 3, "bf16x3": 2}
DFT_PRECISIONS = tuple(PARTS)
# the edge patch reads 2 * n_fft-sample slivers from both ends of the clip
MIN_SAMPLES = 4096
# mels a launch (the kernel's widest instantiation); a wider bank takes one
# launch for each group of as many
MELS_A_LAUNCH = 256
MAX_ROWS = 65535  # clips a launch: the grid's y limit; a larger batch is sliced

# The kernel's design (csrc/mel_wgmma.cuh): frames a block (two warpgroups
# of 64), a chunk's basis columns (32 cos + the 32 matching sin), bf16 parts
# of the power and of banks^T in the mel product, and the mel product's N:
# the mels of a half of banks^T, the narrow instantiation's most
BLOCK = 128
CHUNK_COLS = 64
MEL_SPLIT = 3
WGMMA_MAX_MELS = 128
# K1's kernel by route (``mel_groups``)
ROUTE_KERNELS = {
    "wgmma": "mel_wgmma::mel_kernel_wgmma<2, false, 3, 128>",
    "wgmma_fp32": "mel_wgmma::mel_kernel_wgmma<2, false, 6, 128>",
    "wgmma256": "mel_wgmma::mel_kernel_wgmma<2, false, 3, 128, 256>",
    "wgmma256_fp32": "mel_wgmma::mel_kernel_wgmma<2, false, 6, 128, 256>",
}
# the routes by dft_precision: up to WGMMA_MAX_MELS mels, and up to
# MELS_A_LAUNCH
WGMMA_ROUTES = {"bf16x3": "wgmma", "fp32": "wgmma_fp32"}
WIDE_ROUTES = {"bf16x3": "wgmma256", "fp32": "wgmma256_fp32"}

# the call's kernels besides K1's, by name; each launch of K1 and of them
# is counted in utils/profiling's COUNTERS as k1.launch.<route or name>
CALL_KERNELS = ("mel_edges", "tile_banks")


def k1_launches(dft_precision: str | None = None) -> int:
    """K1's launches in this process (``k1.launch.<route>``), on the routes
    of ``dft_precision``, or on every route."""
    routes = (ROUTE_KERNELS if dft_precision is None else
              (WGMMA_ROUTES[dft_precision], WIDE_ROUTES[dft_precision]))
    return sum(counter(f"k1.launch.{route}") for route in routes)


def kernel_supported(cfg) -> bool:
    """Configs the JAX kernel computes: EfficientAT's front end
    (``MelConfig``) at n_fft 1024 and hop 320 or 640. torchlibrosa's
    (``LibrosaMelConfig``, HTS-AT's) is another function of the wave: no
    pre-emphasis, another window, a Slaney bank and decibels."""
    return isinstance(cfg, MelConfig) and cfg.n_fft == 1024 and cfg.hopsize in (320, 640)


def launch_mels(n_mels: int) -> int:
    """The mels of the narrowest instantiation that holds a launch of
    ``n_mels``: ``WGMMA_MAX_MELS`` or ``MELS_A_LAUNCH``."""
    return WGMMA_MAX_MELS if n_mels <= WGMMA_MAX_MELS else MELS_A_LAUNCH


def mel_groups(n_mels: int, dft_precision: str) -> list[tuple[int, int, str]]:
    """K1's launches for an ``n_mels`` bank: (first mel, mels, route) of each
    group of at most ``MELS_A_LAUNCH`` mels, on the narrowest instantiation
    that holds it: ``WGMMA_ROUTES`` up to ``WGMMA_MAX_MELS`` mels, else
    ``WIDE_ROUTES``."""
    if dft_precision not in DFT_PRECISIONS:
        raise ValueError(f"dft_precision must be one of {DFT_PRECISIONS}, "
                         f"got {dft_precision!r}")
    groups = []
    for m0 in range(0, n_mels, MELS_A_LAUNCH):
        n = min(MELS_A_LAUNCH, n_mels - m0)
        routes = WGMMA_ROUTES if launch_mels(n) == WGMMA_MAX_MELS else WIDE_ROUTES
        groups.append((m0, n, routes[dft_precision]))
    return groups


def k1_route(cfg: MelConfig, dft_precision: str) -> str:
    """The kernel ``stft_log_mel`` launches for ``cfg`` and ``dft_precision``
    (a key of ``ROUTE_KERNELS``), for its first and widest group of mels:
    ``"wgmma"`` (bf16x3) or ``"wgmma_fp32"`` at up to ``WGMMA_MAX_MELS``
    mels, ``"wgmma256"`` or ``"wgmma256_fp32"`` at more (``mel_groups``)."""
    return mel_groups(cfg.n_mels, dft_precision)[0][2]


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
def _basis_no_nyquist(n_fft: int, win_length: int) -> np.ndarray:
    """(n_fft, n_fft) = [cos | sin] windowed basis, Nyquist bin dropped
    (port of ``mel_pallas._basis_no_nyquist``): the probe's unfolded basis."""
    full = _dft_basis(n_fft, win_length)
    n_freq = n_fft // 2 + 1
    return np.ascontiguousarray(np.concatenate(
        [full[:, :n_freq - 1], full[:, n_freq:2 * n_freq - 1]], axis=1))


@lru_cache(maxsize=8)
def _basis_split(n_fft: int, win_length: int, part: int) -> np.ndarray:
    """``bf16_part`` of the unfolded basis."""
    return bf16_part(_basis_no_nyquist(n_fft, win_length), part)


@lru_cache(maxsize=None)
def _k_perm() -> np.ndarray:
    """(64, 16): sample of k16 product ``P`` at k position ``kk``. A thread
    of an ``mma.m16n8k16`` A fragment (wgmma's register A has its layout a
    warp) holds k pairs 2t and 2t + 8; it loads samples 8t .. 8t + 7 of a
    32-sample step and gives product ``P % 2`` its samples 4 (P % 2) + {0,
    1} and {2, 3}, so the basis rows follow the same order."""
    kk = np.arange(16)
    s = np.arange(64)[:, None]
    return (32 * (s // 2) + 8 * (kk % 8 // 2) + 4 * (s % 2) + 2 * (kk // 8)
            + kk % 2)


@lru_cache(maxsize=8)
def _tiled_basis(n_fft: int, win_length: int, folded: bool,
                 part: int) -> np.ndarray:
    """The wgmma kernel's basis operand, pre-tiled: (16 chunks, 64 k16
    products, 8 column groups, 2 k halves, 8 columns, 8 k), element
    ``[c, P, ng, h, r, e]`` = basis[sample _k_perm()[P, 8h + e], column n =
    8ng + r of chunk c] (n < 32: cos bin 32c + n, else sin bin 32c + n -
    32), of the folded basis's part (K1) or the unfolded one's (the probe).
    Each (column group, k half) is one 8 x 16-byte core matrix of the
    canonical K-major layout without swizzle, so a ring stage of KC samples,
    KC / 16 products of a chunk, is one contiguous block."""
    split = _folded_basis_split if folded else _basis_split
    basis = split(n_fft, win_length, part)  # (samples, columns)
    n_bins = n_fft // 2
    n = np.arange(CHUNK_COLS)
    c = np.arange(n_bins // (CHUNK_COLS // 2))[:, None]
    cols = np.where(n < 32, 32 * c + n, n_bins + 32 * c + n - 32)  # (16, 64)
    t = basis[_k_perm()][:, :, cols]  # (P, kk, c, n)
    t = t.reshape(64, 2, 8, 16, 8, 8)  # (P, h, e, c, ng, r)
    return np.ascontiguousarray(t.transpose(3, 0, 4, 1, 5, 2))


def _tiled_banks(banks: torch.Tensor, n_fft: int,
                 mels: int = WGMMA_MAX_MELS) -> torch.Tensor:
    """The kernel's mel operand at ``mels`` (128 or 256): banks^T (n_fft //
    2 bins x mels, zero past n_mels) split into MEL_SPLIT bf16 parts
    (``bf16_split``) and tiled as (16 chunks, mels / 128 halves x 3 parts, 2
    k16 products, 16 mel groups, 2 k halves, 8 mels, 8 bins): element ``[c,
    3 a + p, s, mg, h, r, e]`` = part p of banks^T[bin 32c + 16s + 8h + e,
    mel 128a + 8mg + r], the layout of ``_tiled_basis`` with mels for
    columns, so that a chunk's parts are contiguous blocks of 8 KB, half by
    half."""
    bins = n_fft // 2
    bt = banks.new_zeros((bins, mels))
    bt[:, :banks.shape[0]] = banks[:, :bins].t()
    halves = mels // WGMMA_MAX_MELS
    parts = [part.reshape(bins // 32, 2, 2, 8, halves, WGMMA_MAX_MELS // 8, 8)
             .permute(0, 4, 1, 5, 2, 6, 3) for part in bf16_split(bt, MEL_SPLIT)]
    tiled = torch.stack(parts, 2)  # (c, half, part, s, mg, h, r, e)
    return tiled.reshape(bins // 32, halves * MEL_SPLIT, *tiled.shape[3:]).contiguous()


def _tiled_groups(banks: torch.Tensor, n_fft: int) -> tuple[torch.Tensor, ...]:
    """``_tiled_banks`` of each of ``mel_groups``' launches (the same groups
    at either precision), at its instantiation's width: the ``tiled_banks``
    of ``stft_log_mel``."""
    return tuple(_tiled_banks(banks[m0:m0 + n], n_fft, launch_mels(n))
                 for m0, n, _ in mel_groups(banks.shape[0], "bf16x3"))


def _tiled_shape(n: int, n_fft: int) -> tuple[int, ...]:
    """``_tiled_banks``' shape for a launch of ``n`` mels."""
    return (n_fft // 64, launch_mels(n) // WGMMA_MAX_MELS * MEL_SPLIT, 2,
            WGMMA_MAX_MELS // 8, 2, 8, 8)


def tile_banks(banks: torch.Tensor, n_fft: int) -> tuple[torch.Tensor, ...]:
    """``_tiled_groups(banks, n_fft)``, bit for bit: on a CUDA tensor one
    launch of the ``tile_banks`` kernel writes every group's tiled tensor
    (views of one buffer); on a CPU tensor ``_tiled_groups`` itself."""
    if banks.device.type == "cpu":
        return _tiled_groups(banks, n_fft)
    n_mels = banks.shape[0]
    if (n_fft != 1024 or banks.dim() != 2 or banks.shape[1] != n_fft // 2 + 1
            or banks.dtype != torch.float32 or not banks.is_contiguous()):
        raise ValueError("tile_banks takes contiguous float32 (n_mels, 513) banks, "
                         f"got {banks.dtype} {tuple(banks.shape)}")
    shapes = [_tiled_shape(n, n_fft) for _, n, _ in mel_groups(n_mels, "bf16x3")]
    sizes = [int(np.prod(shape)) for shape in shapes]
    flat = torch.empty(sum(sizes), device=banks.device, dtype=torch.bfloat16)
    lib = _library()
    err = lib.eat_tile_banks(banks.data_ptr(), n_mels, flat.data_ptr(), flat.numel(),
                             torch.cuda.current_stream(banks.device).cuda_stream)
    if err != 0:
        raise RuntimeError("tile_banks launch failed: " + lib.eat_error_string(err).decode())
    count("k1.launch.tile_banks")
    return tuple(part.view(shape) for part, shape in zip(flat.split(sizes), shapes))


@lru_cache(maxsize=16)
def _serving_tiled_banks(n_mels: int, n_fft: int, sr: int, fmin: float,
                         fmax: float, device: str) -> tuple[torch.Tensor, ...]:
    """``_tiled_groups`` of the fixed banks (made on the host in float64),
    on ``device``."""
    count("k1.const_miss")
    banks = kaldi_mel_banks(n_mels, n_fft, sr, fmin, fmax)
    return tuple(t.to(device) for t in _tiled_groups(banks, n_fft))


def tiled_serving_banks(cfg: MelConfig, device) -> tuple[torch.Tensor, ...]:
    """K1's mel operand for ``cfg``'s fixed banks (fmin, effective fmax:
    every eval and serving call), one tensor a launch, tiled once a (n_mels,
    n_fft, sr, fmin, fmax, device) and kept there, as ``device_const``
    keeps the basis."""
    return _serving_tiled_banks(cfg.n_mels, cfg.n_fft, cfg.sr, float(cfg.fmin),
                                float(cfg.effective_fmax), str(device))


def _block_rows(wave: torch.Tensor, cfg: MelConfig, n_frames: int,
                folded: bool = True) -> torch.Tensor:
    """The probe's rows, frame i at ``hop * i``: the raw wave behind
    an ``n_fft // 2`` zero pad (folded), or the pre-emphasised wave with the
    reflect pad (the probe's unfolded variant). Zero-padded to hold every
    frame of the last ``BLOCK``-frame block, to a multiple of 64 samples
    (16-byte aligned rows). K1 reads the caller's wave instead
    (``_k1_rows``)."""
    pad = cfg.n_fft // 2
    if folded:
        src, lead = wave, pad
    else:
        src, lead = F.pad(preemphasis(wave), (pad, pad), mode="reflect"), 0
    sub_frames = -(-n_frames // BLOCK) * BLOCK
    need = max(cfg.hopsize * (sub_frames - 1) + cfg.n_fft, lead + src.shape[1])
    row_len = -(-need // 64) * 64
    return F.pad(src, (lead, row_len - lead - src.shape[1])).contiguous()


def k1_window(n_samples: int, n_fft: int = 1024) -> tuple[int, int]:
    """K1's frame window on a clip of ``n_samples``: (lead, max_start),
    frame f read from ``clamp(hop * f - lead, 0, max_start)`` of the raw
    wave. lead is the centring pad, ``n_fft // 2``; max_start the largest
    multiple of 8 at or below ``n_samples - n_fft`` (16-byte aligned
    frames). Exact for every frame the call keeps from K1: a frame that is
    not an edge frame (``edge_frames``) has its window inside the clip, the
    edge frames are ``mel_edges``', and frames past the clip are never
    written."""
    return n_fft // 2, (n_samples - n_fft) // 8 * 8


def _k1_rows(wave: torch.Tensor) -> torch.Tensor:
    """K1's (B, row_len) rows: the caller's wave itself where its rows are
    16-byte aligned (S a multiple of 4, as every whole clip at 32 kHz and
    ``bucket_pad_collate``'s batches are), else one copy into rows of S
    rounded up to a multiple of 4, the at most 3 samples past S left unset:
    ``k1_window`` reads none of them. (The JAX wrapper also pays a pad only
    for odd lengths, mel_pallas.py:283-289.)"""
    n_samples = wave.shape[1]
    if n_samples % 4 == 0 and wave.data_ptr() % 16 == 0:
        return wave
    rows = wave.new_empty((wave.shape[0], -(-n_samples // 4) * 4))
    rows[:, :n_samples] = wave
    return rows


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
    """Overwrite the reflect-pad edge frames of ``out`` (B, n_mels, frames):
    the plain version of ``mel_edges``."""
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


# mel_edges' counts of a clip's finished blocks, by (device, stream): int32,
# zero between launches (the clip's last block sets its count back), made
# once and grown with the batch
_EDGE_DONE = {}


def _edge_done(device: torch.device, stream, batch: int) -> torch.Tensor:
    """``mel_edges``' zeroed counts for ``batch`` clips on ``stream``: one
    buffer a stream, so that launches in flight on two streams never share
    a count."""
    key = (device, stream.cuda_stream)
    done = _EDGE_DONE.get(key)
    if done is None or done.numel() < batch:
        with torch.cuda.stream(stream):
            done = _EDGE_DONE[key] = torch.zeros(max(batch, 256), dtype=torch.int32,
                                                 device=device)
    return done


def mel_edges(out: torch.Tensor, wave: torch.Tensor, banks: torch.Tensor,
              cfg: MelConfig) -> torch.Tensor:
    """Overwrite the reflect-pad edge frames of ``out`` (B, n_mels, n_frames)
    with their log-mel from the fp32 operands of the reference math, in
    place, and return it: on a CUDA tensor one launch of the ``mel_edges``
    kernel (any n_mels; its sums in fp64, each clip's bins in up to 8
    blocks), on a CPU tensor ``_patch_edges``. ``wave`` is
    the (B, S) raw wave, ``banks`` the (n_mels, n_fft // 2 + 1) fp32
    banks."""
    if out.device.type == "cpu":
        return _patch_edges(out, wave, banks, cfg)
    batch, n_samples = wave.shape
    n_frames = out.shape[2]
    if (cfg.n_fft != 1024 or n_samples < MIN_SAMPLES
            or out.shape != (batch, banks.shape[0], n_frames)
            or banks.shape[1] != cfg.n_freqs
            or any(t.device != out.device or t.dtype != torch.float32
                   or not t.is_contiguous() for t in (out, wave, banks))):
        raise ValueError("mel_edges takes contiguous float32 out (B, n_mels, frames), "
                         f"wave (B, S >= {MIN_SAMPLES}) and banks (n_mels, "
                         f"{cfg.n_freqs}) on one device, n_fft 1024")
    left_f, right_f = edge_frames(n_frames, cfg.hopsize, cfg.n_fft, n_samples - 1)
    if not (left_f or right_f):
        return out
    basis = device_const(_dft_basis, (cfg.n_fft, cfg.win_length), str(out.device))
    stream = torch.cuda.current_stream(out.device)
    power = out.new_empty((batch, len(left_f) + len(right_f), cfg.n_freqs))
    lib = _library()
    err = lib.eat_mel_edges(wave.data_ptr(), batch, n_samples, cfg.hopsize, n_frames,
                            len(left_f), right_f[0] if right_f else n_frames,
                            basis.data_ptr(), banks.data_ptr(), banks.shape[0],
                            out.data_ptr(), power.data_ptr(),
                            _edge_done(out.device, stream, batch).data_ptr(),
                            stream.cuda_stream)
    if err != 0:
        raise RuntimeError("mel_edges launch failed: " + lib.eat_error_string(err).decode())
    count("k1.launch.mel_edges")
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
                 dft_precision: str = "fp32", *,
                 tiled_banks: tuple[torch.Tensor, ...] | None = None) -> torch.Tensor:
    """Raw waveform (B, S) f32 -> normalized log-mel (B, n_mels, n_frames).

    On a CUDA tensor this launches only hand-written kernels, or raises:
    ``tile_banks`` when ``tiled_banks`` is None, K1's kernel for each of
    ``mel_groups``' launches (a bank of more than ``MELS_A_LAUNCH`` mels takes
    one for each group of as many) on the caller's wave in place, once for
    each slice of at most ``MAX_ROWS`` clips, then ``mel_edges``; nothing
    falls back to another kernel. On a CPU tensor it runs
    ``stft_log_mel_plain``. ``banks`` is the (n_mels, n_fft//2+1) Kaldi bank;
    its zero Nyquist column is dropped inside. ``dft_precision`` defaults to
    exact fp32, as ``stft_log_mel_pallas``'s does. ``tiled_banks`` is
    ``_tiled_groups(banks)`` made beforehand (the serving banks',
    ``tiled_serving_banks``)."""
    if wave.device.type == "cpu":
        return stft_log_mel_plain(wave, banks, cfg, dft_precision)
    _check_args(wave, banks, cfg, dft_precision)
    if wave.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors, got {wave.device}")
    if wave.dtype != torch.float32 or not wave.is_contiguous():
        raise ValueError("K1 takes a contiguous float32 wave, got "
                         f"{wave.dtype}, contiguous={wave.is_contiguous()}")
    if (banks.device != wave.device or banks.dtype != torch.float32
            or not banks.is_contiguous()):
        raise ValueError("banks must be contiguous float32 on the wave's device")
    groups = mel_groups(cfg.n_mels, dft_precision)
    if tiled_banks is None:
        tiled_banks = tile_banks(banks, cfg.n_fft)
    _check_tiled(tiled_banks, groups, cfg.n_fft, wave.device)
    lib = _library()
    n_fft, hop = cfg.n_fft, cfg.hopsize
    batch, n_samples = wave.shape
    n_frames = cfg.num_frames(n_samples)
    lead, max_start = k1_window(n_samples, n_fft)
    out = torch.empty((batch, cfg.n_mels, n_frames), device=wave.device,
                      dtype=torch.float32)
    stream = torch.cuda.current_stream(wave.device).cuda_stream
    parts = PARTS[dft_precision]
    basis = [device_const(_tiled_basis, (n_fft, cfg.win_length, True, p),
                          str(wave.device), torch.bfloat16).data_ptr()
             for p in range(parts)]
    basis += [None] * (3 - parts)  # bf16x3 reads no third part
    x = _k1_rows(wave)
    for start in range(0, batch, MAX_ROWS):
        rows = min(MAX_ROWS, batch - start)
        for (m0, n, route), tiled in zip(groups, tiled_banks):
            err = lib.eat_mel_log_wgmma(x[start].data_ptr(), rows, x.shape[1], hop,
                                        n_frames, lead, max_start, *basis, parts,
                                        tiled.data_ptr(), n, out[start, m0].data_ptr(),
                                        cfg.n_mels, stream)
            if err != 0:
                raise RuntimeError(f"K1 launch failed ({ROUTE_KERNELS[route]}): "
                                   + lib.eat_error_string(err).decode())
            count(f"k1.launch.{route}")
    return mel_edges(out, wave, banks, cfg)


def _check_tiled(tiled_banks, groups, n_fft: int, device) -> None:
    """Raise unless ``tiled_banks`` holds, for each launch of ``groups``, a
    contiguous bfloat16 tensor on ``device`` of ``_tiled_banks``' shape at
    its instantiation's width."""
    want = [_tiled_shape(n, n_fft) for _, n, _ in groups]
    if (not isinstance(tiled_banks, tuple) or len(tiled_banks) != len(want)
            or any(t.shape != w or t.dtype != torch.bfloat16 or t.device != device
                   or not t.is_contiguous() for t, w in zip(tiled_banks, want))):
        raise ValueError(f"tiled_banks must be a tuple of contiguous bfloat16 "
                         f"tensors of shapes {want} on the wave's device "
                         "(_tiled_groups)")


def stft_log_mel_sharded(wave_local: torch.Tensor, banks: torch.Tensor,
                         cfg: MelConfig, dft_precision: str = "fp32", *,
                         tiled_banks: torch.Tensor | None = None) -> torch.Tensor:
    """K1-dp: K1 on this rank's rows of a batch split over the ranks of the
    default process group (port of ``stft_log_mel_pallas_sharded``, which
    ``shard_map``s K1 over the ``data`` mesh axis).

    ``wave_local`` holds this rank's rows; ``banks`` must be the same on
    every rank (the train step draws the jitter from identically seeded
    generators, so no broadcast is needed). The ranks' outputs, concatenated
    in rank order, equal ``stft_log_mel`` on the whole batch. On a CPU tensor
    it runs K1's plain version, as ``stft_log_mel`` does; ``tiled_banks`` is
    ``stft_log_mel``'s."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("stft_log_mel_sharded needs an initialised "
                           "torch.distributed process group")
    return stft_log_mel(wave_local, banks, cfg, dft_precision,
                        tiled_banks=tiled_banks)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.eat_mel_log_wgmma.argtypes = [p, i, i, i, i, i, i, p, p, p, i, p, i, p, i, p]
    lib.eat_mel_edges.argtypes = [p, i, i, i, i, i, i, p, p, i, p, p, p, p]
    lib.eat_tile_banks.argtypes = [p, i, p, ctypes.c_longlong, p]
    lib.eat_error_string.argtypes = [i]
    lib.eat_error_string.restype = ctypes.c_char_p
    for fn in (lib.eat_mel_log_wgmma, lib.eat_mel_edges, lib.eat_tile_banks):
        fn.restype = i
    return lib


def _library() -> ctypes.CDLL:
    """K1's library (``csrc/mel_kernel.cu``), built at first use, each
    library object bound once (a variant put in ``_build._LIBS`` is bound
    at its first call)."""
    from efficientat_tpu_torch.ops._build import load_library

    lib = load_library("mel_kernel")
    if not getattr(lib, "eat_bound", False):
        _bind(lib).eat_bound = True
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
    otherwise, which also takes HTS-AT's ``LibrosaMelConfig``).

    ``training=True`` needs ``draws`` (this call's rows of them): K1 gets the
    jittered fp32 banks as its runtime input and its output is masked with
    0.9. Otherwise the banks are fixed, and K1 takes them tiled once
    (``tiled_serving_banks``). ``sharded=True`` runs K1 as K1-dp (``stft_log_mel_sharded``), as
    the JAX step does under a mesh of more than one device.

    dft_precision defaults to ``"bf16x3"``, the serving and training default
    of the JAX package's ``log_mel_spectrogram_fused``; ``"fp32"`` is exact
    fp32. The melspec path is always fp32.
    """
    if training and draws is None:
        raise ValueError("training=True requires draws (see draw_mel_augment)")
    if backend not in ("auto", "kernel", "plain"):
        raise ValueError(f"backend must be auto, kernel or plain, got {backend!r}")
    if backend == "kernel" and not isinstance(cfg, MelConfig):
        raise ValueError(f"K1 computes EfficientAT's front end (a MelConfig), not {cfg}")
    use_kernel = backend == "kernel" or (backend == "auto" and auto_takes_kernel(
        cfg, waveform.device.type, waveform.shape[-1]))
    if not use_kernel:
        return log_mel_spectrogram(waveform, cfg, training=training,
                                   draws=draws)
    on_card = waveform.device.type == "cuda" and kernel_supported(cfg)
    if training:
        with span("mel.banks"):
            fmin, fmax = jittered_fmin_fmax(cfg, draws, waveform.device)
            banks = kaldi_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sr, fmin, fmax,
                                    device=waveform.device)
            tiled = tile_banks(banks, cfg.n_fft) if on_card else None
    else:
        banks = kaldi_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sr, cfg.fmin,
                                cfg.effective_fmax, device=waveform.device)
        tiled = tiled_serving_banks(cfg, waveform.device) if on_card else None
    dft_precision = dft_precision or "bf16x3"
    run = stft_log_mel_sharded if sharded else stft_log_mel
    mel = run(waveform.to(torch.float32).contiguous(), banks, cfg,
              dft_precision, tiled_banks=tiled)
    if training:
        mel = apply_masks(mel, cfg, draws, 0.9)
    return mel
