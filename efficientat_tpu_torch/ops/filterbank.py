"""Kaldi-style triangular mel filterbank (port of efficientat_tpu/ops/filterbank.py).

HTK mel scale ``1127 * ln(1 + f/700)``, ``n_mels`` triangles spanning
[fmin, fmax], weights on the first ``n_fft/2`` FFT bins and a zero column for
the Nyquist bin (upstream models/preprocess.py:52-55).

Two branches, as in the JAX package:
- fmin/fmax as Python floats (every eval and serving call): the banks are
  built on the host in float64 and cast to fp32 once, bit-identical to the
  JAX package's ``_mel_banks_np``;
- fmin or fmax as a tensor (the training-time jitter): the banks are built
  in fp32 on that tensor's device, as the JAX traced branch builds them
  inside the compiled step.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=64)
def _mel_banks_np(n_mels: int, n_fft: int, sample_rate: int,
                  fmin: float, fmax: float) -> np.ndarray:
    """Float64 host construction, cast to fp32 once at the end."""
    def mel(f):
        return 1127.0 * np.log1p(np.asarray(f, np.float64) / 700.0)

    num_fft_bins = n_fft // 2
    lo, hi = mel(fmin), mel(fmax)
    delta = (hi - lo) / (n_mels + 1)
    left = lo + np.arange(n_mels, dtype=np.float64)[:, None] * delta
    center = left + delta
    right = center + delta
    fft_mels = mel(sample_rate / n_fft * np.arange(num_fft_bins))[None, :]
    up = (fft_mels - left) / (center - left)
    down = (right - fft_mels) / (right - center)
    weights = np.maximum(0.0, np.minimum(up, down))
    return np.concatenate(
        [weights, np.zeros((n_mels, 1))], axis=1).astype(np.float32)


def _mel_scale(freq: torch.Tensor) -> torch.Tensor:
    return 1127.0 * torch.log(1.0 + freq / 700.0)


def _mel_banks_fp32(n_mels: int, n_fft: int, sample_rate: int,
                    fmin: torch.Tensor, fmax: torch.Tensor) -> torch.Tensor:
    """fp32 construction on the device of ``fmin``/``fmax``, the same
    operations in the same order as the JAX traced branch (filterbank.py:68-88)."""
    device = fmin.device
    f32 = dict(dtype=torch.float32, device=device)
    mel_low = _mel_scale(fmin.to(**f32))
    mel_high = _mel_scale(fmax.to(**f32))
    mel_delta = (mel_high - mel_low) / (n_mels + 1)
    left = mel_low + torch.arange(n_mels, **f32)[:, None] * mel_delta
    center = left + mel_delta
    right = center + mel_delta
    fft_mels = _mel_scale(sample_rate / n_fft
                          * torch.arange(n_fft // 2, **f32))[None, :]
    up = (fft_mels - left) / (center - left)
    down = (right - fft_mels) / (right - center)
    weights = torch.clamp(torch.minimum(up, down), min=0.0)
    return torch.cat([weights, torch.zeros(n_mels, 1, **f32)], dim=1)


def kaldi_mel_banks(n_mels: int, n_fft: int, sample_rate: int, fmin, fmax,
                    device="cpu") -> torch.Tensor:
    """Triangular mel filterbank ``(n_mels, n_fft // 2 + 1)`` fp32.

    Python-float fmin/fmax give the host-float64 banks on ``device``; a
    tensor fmin or fmax (the training jitter) gives the fp32 banks built on
    that tensor's device. The final (Nyquist) column is always zero,
    matching the reference's explicit zero-pad of the Kaldi bank
    (models/preprocess.py:54).
    """
    if isinstance(fmin, torch.Tensor) or isinstance(fmax, torch.Tensor):
        ref = fmin if isinstance(fmin, torch.Tensor) else fmax
        fmin, fmax = (torch.as_tensor(f, dtype=torch.float32, device=ref.device)
                      for f in (fmin, fmax))
        return _mel_banks_fp32(n_mels, n_fft, sample_rate, fmin, fmax)
    banks = _mel_banks_np(n_mels, n_fft, sample_rate, float(fmin), float(fmax))
    return torch.from_numpy(banks).to(device)
