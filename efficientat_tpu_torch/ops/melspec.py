"""Log-mel spectrogram, plain PyTorch path (port of efficientat_tpu/ops/melspec.py).

Reference behaviour (upstream models/preprocess.py:6-67, ``AugmentMelSTFT``),
eval mode:

1. pre-emphasis ``x[t+1] - 0.97 * x[t]``;
2. STFT with n_fft=1024, hop=320, win=800, a symmetric (periodic=False) Hann
   window, center=True with reflect pad, power re^2 + im^2;
3. Kaldi mel bank (``ops.filterbank``), fp32 mel GEMM, ``log(mel + 1e-5)``;
4. fixed normalisation ``(x + 4.5) / 5``.

HTS-AT's front end is another one, torchlibrosa's (``LibrosaMelConfig``,
``librosa_log_mel``): no pre-emphasis, a periodic Hann window of n_fft, a
Slaney mel bank and decibels. ``log_mel_spectrogram`` takes either config.

As in the JAX package, the STFT is a GEMM against a windowed rDFT basis built
in float64, and clips of at least ``2 * n_fft`` samples multiply frames of the
RAW wave by a basis with the pre-emphasis folded in (``stft_power_folded``),
which keeps the cancellation of the difference signal out of fp32. Every
GEMM here runs in IEEE fp32 (``true_fp32``).

Training mode (upstream models/preprocess.py:45-63) adds the fmin/fmax
jitter of the filterbank and SpecAugment (frequency then time mask, fill 0.0
before normalisation). Its random numbers come in as explicit ``MelDraws``
(``draw_mel_augment`` makes them from a ``torch.Generator``), so a test can
replay the JAX key's draws and a data-parallel rank can take its rows of a
global batch's draws.
"""

from __future__ import annotations

import contextlib
import dataclasses
from functools import lru_cache
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from efficientat_tpu_torch.ops.filterbank import kaldi_mel_banks
from efficientat_tpu_torch.utils.profiling import count

PREEMPH = 0.97
# torchlibrosa's floor of the mel power before its decibels
AMIN = 1e-10


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Front-end configuration (defaults mirror models/preprocess.py:7)."""

    n_mels: int = 128
    sr: int = 32000
    win_length: int = 800
    hopsize: int = 320
    n_fft: int = 1024
    freqm: int = 48
    timem: int = 192
    fmin: float = 0.0
    fmax: Optional[float] = None
    fmin_aug_range: int = 10
    fmax_aug_range: int = 2000

    def __post_init__(self):
        if self.fmin_aug_range < 1 or self.fmax_aug_range < 1:
            raise ValueError("fmin_aug_range and fmax_aug_range must be >= 1 "
                             "(1 == no augmentation)")

    @property
    def effective_fmax(self) -> float:
        # models/preprocess.py:17-19 — None means "Nyquist minus half the jitter range".
        if self.fmax is None:
            return float(self.sr // 2 - self.fmax_aug_range // 2)
        return float(self.fmax)

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        """Frames for ``num_samples`` samples: pre-emphasis shortens by 1 and
        the centered STFT yields ``1 + L // hop`` frames."""
        return (num_samples - 1) // self.hopsize + 1


@dataclasses.dataclass(frozen=True)
class LibrosaMelConfig:
    """torchlibrosa's front end, ``Spectrogram`` then ``LogmelFilterBank``,
    as HTS-AT builds it (github.com/RetroCirce/HTS-Audio-Transformer,
    model/htsat.py and config.py): a centred STFT of ``n_fft`` with reflect
    pad and a periodic Hann window of ``n_fft``, power 2; a Slaney-scale,
    Slaney-normalised mel bank from ``fmin`` to ``fmax`` (librosa's
    ``filters.mel`` default); ``10 log10(max(x, AMIN))``, HTS-AT's
    ``LogmelFilterBank`` at ref 1 and no ``top_db``. No pre-emphasis, no
    normalisation, no training augmentation. K1 does not compute it
    (``mel_kernel.kernel_supported``)."""

    n_mels: int = 64
    sr: int = 32000
    n_fft: int = 1024
    hopsize: int = 320
    fmin: float = 50.0
    fmax: float = 14000.0

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        """Frames of the centred STFT: ``1 + L // hop``."""
        return num_samples // self.hopsize + 1


def hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    """Slaney's mel scale (librosa's ``hz_to_mel``, htk=False), float64:
    linear at 3 mels a 200 Hz below 1 kHz (15 mels at 1 kHz), logarithmic
    above at 27 mels a factor of 6.4."""
    f = np.asarray(f, dtype=np.float64)
    lin = 3.0 * f / 200.0
    log = 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) * (27.0 / np.log(6.4))
    return np.where(f >= 1000.0, log, lin)


def mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    """The inverse of ``hz_to_mel_slaney``, float64."""
    m = np.asarray(m, dtype=np.float64)
    lin = 200.0 * m / 3.0
    log = 1000.0 * np.exp((np.log(6.4) / 27.0) * (np.maximum(m, 15.0) - 15.0))
    return np.where(m >= 15.0, log, lin)


@lru_cache(maxsize=8)
def slaney_mel_banks(n_mels: int, n_fft: int, sr: int, fmin: float,
                     fmax: float) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) float64 Slaney bank (librosa's
    ``filters.mel``, htk=False, norm="slaney"): triangles between
    ``n_mels + 2`` edges equally spaced on the Slaney scale from ``fmin`` to
    ``fmax``, on the bins' frequencies ``k sr / n_fft``, each scaled by
    2 / (f[i+2] - f[i]) to unit area in Hz."""
    bins = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    edges = mel_to_hz_slaney(np.linspace(hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax),
                                         n_mels + 2))
    width = np.diff(edges)
    ramps = edges[:, None] - bins[None, :]
    up = -ramps[:-2] / width[:-1, None]
    down = ramps[2:] / width[1:, None]
    weights = np.maximum(0.0, np.minimum(up, down))
    return weights * (2.0 / (edges[2:] - edges[:-2]))[:, None]


@lru_cache(maxsize=8)
def _librosa_consts(cfg: LibrosaMelConfig, device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The periodic Hann window and the transposed Slaney bank (n_freqs,
    n_mels), float32 on ``device``, made once a config and device."""
    window = torch.hann_window(cfg.n_fft, periodic=True, dtype=torch.float64)
    banks = slaney_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sr, cfg.fmin, cfg.fmax)
    return (window.to(device=device, dtype=torch.float32),
            torch.from_numpy(np.ascontiguousarray(banks.T)).to(device=device,
                                                                dtype=torch.float32))


def librosa_log_mel(waveform: torch.Tensor, cfg: LibrosaMelConfig) -> torch.Tensor:
    """torchlibrosa's log-mel in float32: (B, num_samples) -> (B, n_frames,
    n_mels), torchlibrosa's layout (time before mels). The STFT is
    ``torch.stft`` (cuFFT on the card), the mel product an IEEE fp32 GEMM
    (``true_fp32``)."""
    x = waveform.to(torch.float32)
    window, banks = _librosa_consts(cfg, str(x.device))
    spec = torch.stft(x, cfg.n_fft, cfg.hopsize, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = torch.view_as_real(spec).square().sum(-1)  # (B, n_freqs, frames)
    with true_fp32():
        mel = power.transpose(1, 2) @ banks
    return 10.0 * torch.log10(torch.clamp(mel, min=AMIN))


@contextlib.contextmanager
def true_fp32():
    """Run the GEMMs inside in IEEE fp32 on the card.

    TF32 keeps about three decimal digits, and the log near the 1e-5 mel
    floor turns that into visible error (the JAX package pins
    ``Precision.HIGHEST`` for the same reason). The previous setting is
    restored on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def hann_window(win_length: int) -> np.ndarray:
    """Symmetric (periodic=False) Hann window, float64."""
    n = np.arange(win_length, dtype=np.float64)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * n / (win_length - 1)))


def _windowed_basis_f64(n_fft: int, win_length: int) -> np.ndarray:
    """(n_fft, 2*(n_fft//2+1)) float64: cos columns, then sin columns, times
    the window zero-padded to the centre of the n_fft frame (torch.stft's
    handling of win < n_fft)."""
    n_freq = n_fft // 2 + 1
    w = np.zeros(n_fft, dtype=np.float64)
    left = (n_fft - win_length) // 2
    w[left:left + win_length] = hann_window(win_length)
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_freq, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    return np.concatenate([np.cos(ang) * w[:, None], np.sin(ang) * w[:, None]],
                          axis=1)


@lru_cache(maxsize=8)
def _dft_basis(n_fft: int, win_length: int) -> np.ndarray:
    """Windowed rDFT basis (n_fft, 2*(n_fft//2+1)), built in float64, fp32."""
    return _windowed_basis_f64(n_fft, win_length).astype(np.float32)


@lru_cache(maxsize=8)
def _folded_dft_basis(n_fft: int, win_length: int,
                      coef: float = PREEMPH) -> np.ndarray:
    """Pre-emphasis-folded windowed rDFT basis (n_fft, 2*(n_fft//2+1)).

    For xe[t] = x[t+1] - coef*x[t] and a windowed basis b whose centered
    window is zero at the frame edges (win_length < n_fft),
    ``sum_m b[m,k]*xe[s+m] == sum_j B'[j,k]*x[s+j]`` with
    ``B'[j,k] = b[j-1,k] - coef*b[j,k]`` (b[-1] := 0). Built in float64."""
    basis = _windowed_basis_f64(n_fft, win_length)
    shifted = np.vstack([np.zeros((1, basis.shape[1])), basis[:-1]])
    return (shifted - coef * basis).astype(np.float32)


@lru_cache(maxsize=64)
def device_const(make, args: tuple, device: str,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``make(*args)`` (a cached numpy constant) as a ``dtype`` tensor on
    ``device``, copied there once per process (``k1.const_miss`` counts each
    copy)."""
    count("k1.const_miss")
    return torch.from_numpy(np.ascontiguousarray(make(*args))).to(
        device=device, dtype=dtype)


def frame_signal(x: torch.Tensor, n_fft: int, hop: int, n_frames: int,
                 pad_mode: str = "reflect") -> torch.Tensor:
    """Centered frames: (B, L) -> (B, n_frames, n_fft), a strided view of
    the padded signal. ``"reflect"`` matches torch.stft(center=True); the
    folded-basis path uses ``"constant"`` and patches the edge frames."""
    pad = n_fft // 2
    x = F.pad(x, (pad, pad), mode=pad_mode)
    return x.unfold(1, n_fft, hop)[:, :n_frames]


def preemphasis(x: torch.Tensor, coef: float = PREEMPH) -> torch.Tensor:
    """Valid-mode pre-emphasis filter: y[t] = x[t+1] - coef * x[t]."""
    return x[:, 1:] - coef * x[:, :-1]


def stft_power(x: torch.Tensor, n_fft: int, hop: int,
               win_length: int) -> torch.Tensor:
    """Power spectrogram |STFT|^2: (B, L) -> (B, L//hop + 1, n_fft//2+1)."""
    n_frames = x.shape[1] // hop + 1
    frames = frame_signal(x, n_fft, hop, n_frames)
    basis = device_const(_dft_basis, (n_fft, win_length), str(x.device))
    with true_fp32():
        proj = frames @ basis
    n_freq = n_fft // 2 + 1
    return proj[..., :n_freq] ** 2 + proj[..., n_freq:] ** 2


def _edge_power(x_raw: torch.Tensor, n_fft: int, hop: int, win_length: int,
                left_f, right_f, coef: float = PREEMPH) -> torch.Tensor:
    """Exact reference-math power rows for the frames whose window overlaps
    the reflect-pad region (the one place where the folded-basis frames,
    which see a zero pad, differ): pre-emphasis, reflect pad and the
    unfolded basis on ``2 * n_fft``-sample slivers. (B, n_edge, n_freq)."""
    pad = n_fft // 2
    seg = 2 * n_fft
    frames = []
    if left_f:
        s = x_raw[:, :seg]
        xep = F.pad(s[:, 1:] - coef * s[:, :-1], (pad, 0), mode="reflect")
        for f in left_f:
            frames.append(xep[:, f * hop: f * hop + n_fft])
    if right_f:
        s = x_raw[:, -seg:]
        xep = F.pad(s[:, 1:] - coef * s[:, :-1], (0, pad), mode="reflect")
        base = x_raw.shape[1] - seg  # xe here starts at global xe index base
        for f in right_f:
            off = f * hop - pad - base
            frames.append(xep[:, off: off + n_fft])
    fr = torch.stack(frames, dim=1)
    basis = device_const(_dft_basis, (n_fft, win_length), str(x_raw.device))
    with true_fp32():
        proj = fr @ basis
    n_freq = n_fft // 2 + 1
    return proj[..., :n_freq] ** 2 + proj[..., n_freq:] ** 2


def edge_frames(n_frames: int, hop: int, n_fft: int, len_xe: int):
    """Frames whose window reaches into the reflect pad, left and right:
    the f of ``range(n_frames)`` with ``f * hop < n_fft // 2``, and those with
    ``f * hop + n_fft // 2 > len_xe``, in closed form."""
    pad = n_fft // 2
    left_f = list(range(min(n_frames, -(-pad // hop))))
    right_f = list(range(max(0, (len_xe - pad) // hop + 1), n_frames))
    return left_f, right_f


def stft_power_folded(x_raw: torch.Tensor, n_fft: int, hop: int,
                      win_length: int, coef: float = PREEMPH) -> torch.Tensor:
    """Power spectrogram of ``preemphasis(x_raw)`` from frames of the RAW
    wave against the folded basis, with the reflect-pad edge frames patched
    by the exact reference math. (B, L) -> (B, (L-1)//hop + 1, n_fft//2+1)."""
    len_xe = x_raw.shape[1] - 1
    n_frames = len_xe // hop + 1
    frames = frame_signal(x_raw, n_fft, hop, n_frames, pad_mode="constant")
    basis = device_const(_folded_dft_basis, (n_fft, win_length, coef),
                         str(x_raw.device))
    with true_fp32():
        proj = frames @ basis
    n_freq = n_fft // 2 + 1
    power = proj[..., :n_freq] ** 2 + proj[..., n_freq:] ** 2

    left_f, right_f = edge_frames(n_frames, hop, n_fft, len_xe)
    if left_f or right_f:
        edge = _edge_power(x_raw, n_fft, hop, win_length, left_f, right_f,
                           coef)
        nl = len(left_f)
        power[:, :nl] = edge[:, :nl]
        if right_f:
            power[:, right_f[0]:right_f[-1] + 1] = edge[:, nl:]
    return power


@dataclasses.dataclass(frozen=True)
class MelDraws:
    """The random numbers of one training-mode mel call on a batch.

    ``fmin_offset`` is added to ``cfg.fmin`` (U{0..fmin_aug_range-1});
    ``fmax_offset`` to ``cfg.effective_fmax`` (fmax_aug_range//2 -
    U{0..fmax_aug_range-1}). The masks are per clip, (B,) fp32 on the CPU:
    width ~ U[0, param), start ~ U[0, D - width), cells [start, start +
    width) masked; ``None`` where the config's mask parameter is 0.
    """

    fmin_offset: int
    fmax_offset: int
    freq_width: Optional[torch.Tensor] = None
    freq_start: Optional[torch.Tensor] = None
    time_width: Optional[torch.Tensor] = None
    time_start: Optional[torch.Tensor] = None

    def rows(self, rows: slice) -> "MelDraws":
        """The draws of the clips ``rows`` (a data-parallel rank's share)."""
        per_clip = ("freq_width", "freq_start", "time_width", "time_start")
        return dataclasses.replace(self, **{
            name: getattr(self, name)[rows] for name in per_clip
            if getattr(self, name) is not None})


def draw_mel_augment(cfg: MelConfig, batch: int, n_frames: int,
                     generator: torch.Generator) -> MelDraws:
    """Draw one batch's jitter and masks from ``generator`` (on the CPU)."""
    def draw_int(high):
        return int(torch.randint(high, (), generator=generator))

    def draw_mask(param, size):
        if param <= 0:
            return None, None
        width = torch.rand(batch, generator=generator) * param
        return width, torch.rand(batch, generator=generator) * (size - width)

    fmin_offset = draw_int(cfg.fmin_aug_range)
    fmax_offset = cfg.fmax_aug_range // 2 - draw_int(cfg.fmax_aug_range)
    freq = draw_mask(cfg.freqm, cfg.n_mels)
    time = draw_mask(cfg.timem, n_frames)
    return MelDraws(fmin_offset, fmax_offset, *freq, *time)


def jittered_fmin_fmax(cfg: MelConfig, draws: MelDraws,
                       device) -> Tuple[torch.Tensor, torch.Tensor]:
    """fmin and fmax of a training call as fp32 tensors on ``device``, as the
    JAX step forms them (melspec.py:311-315); tensors select the fp32 bank
    construction of ``kaldi_mel_banks``."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.tensor(cfg.fmin, **f32) + float(draws.fmin_offset),
            torch.tensor(cfg.effective_fmax, **f32) + float(draws.fmax_offset))


def _mask_axis(x: torch.Tensor, width: torch.Tensor, start: torch.Tensor,
               axis: int, value: float) -> torch.Tensor:
    """SpecAugment mask along ``axis`` (1 mels, 2 frames) of (B, F, T),
    per clip: cells ``start <= pos < start + width`` become ``value``
    (torchaudio ``_mask_along_axis_iid``)."""
    size = x.shape[axis]
    pos = torch.arange(size, dtype=torch.float32, device=x.device)
    start = start.to(x.device)
    end = start + width.to(x.device)
    mask = (pos[None, :] >= start[:, None]) & (pos[None, :] < end[:, None])
    shape = [x.shape[0], 1, 1]
    shape[axis] = size
    return x.masked_fill(mask.reshape(shape), value)


def apply_masks(mel: torch.Tensor, cfg: MelConfig, draws: MelDraws,
                value: float) -> torch.Tensor:
    """Frequency mask, then time mask, as the config asks for them."""
    if cfg.freqm > 0:
        mel = _mask_axis(mel, draws.freq_width, draws.freq_start, 1, value)
    if cfg.timem > 0:
        mel = _mask_axis(mel, draws.time_width, draws.time_start, 2, value)
    return mel


def log_mel_spectrogram(waveform: torch.Tensor,
                        cfg: Union[MelConfig, LibrosaMelConfig] = MelConfig(),
                        *, training: bool = False,
                        draws: Optional[MelDraws] = None) -> torch.Tensor:
    """Waveform (B, num_samples) -> normalized log-mel (B, n_mels, n_frames);
    for a ``LibrosaMelConfig``, torchlibrosa's log-mel in decibels, (B,
    n_frames, n_mels) (``librosa_log_mel``; serving only).

    ``training=True`` jitters fmin/fmax and applies SpecAugment with
    ``draws`` (required)."""
    if isinstance(cfg, LibrosaMelConfig):
        if training:
            raise ValueError("torchlibrosa's front end is served only: training=True "
                             "takes a MelConfig")
        return librosa_log_mel(waveform, cfg)
    if training and draws is None:
        raise ValueError("training=True requires draws (see draw_mel_augment)")
    x32 = waveform.to(torch.float32)
    if x32.shape[1] >= 2 * cfg.n_fft:
        spec = stft_power_folded(x32, cfg.n_fft, cfg.hopsize, cfg.win_length)
    else:
        # clips shorter than the edge-patch slivers: reference-order math
        spec = stft_power(preemphasis(x32), cfg.n_fft, cfg.hopsize,
                          cfg.win_length)
    fmin, fmax = (jittered_fmin_fmax(cfg, draws, x32.device) if training
                  else (cfg.fmin, cfg.effective_fmax))
    banks = kaldi_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sr, fmin, fmax,
                            device=x32.device)
    with true_fp32():
        mel = torch.einsum("mf,btf->bmt", banks, spec)
    mel = torch.log(mel + 1e-5)
    if training:
        mel = apply_masks(mel, cfg, draws, 0.0)
    return (mel + 4.5) / 5.0


def mel_oracle_f64(waves: np.ndarray, cfg: MelConfig,
                   banks32: np.ndarray) -> np.ndarray:
    """Float64 host oracle of the reference mel math: pre-emphasis, reflect
    pad, Hann window, rfft power, the fp32-valued banks applied in float64,
    log, (x+4.5)/5. The banks enter as the same fp32 values the device
    paths use, so the oracle isolates arithmetic error, not bank
    construction. (B, S) -> (B, n_mels, n_frames)."""
    x = waves.astype(np.float64)
    x = x[:, 1:] - PREEMPH * x[:, :-1]
    pad = cfg.n_fft // 2
    xp = np.pad(x, ((0, 0), (pad, pad)), mode="reflect")
    n_frames = x.shape[1] // cfg.hopsize + 1
    frames = np.lib.stride_tricks.sliding_window_view(
        xp, cfg.n_fft, axis=1)[:, ::cfg.hopsize][:, :n_frames]
    w = np.zeros(cfg.n_fft, np.float64)
    left = (cfg.n_fft - cfg.win_length) // 2
    w[left:left + cfg.win_length] = hann_window(cfg.win_length)
    spec = np.abs(np.fft.rfft(frames * w, axis=-1)) ** 2
    mel = np.einsum("mf,btf->bmt", banks32.astype(np.float64), spec)
    return (np.log(mel + 1e-5) + 4.5) / 5.0
