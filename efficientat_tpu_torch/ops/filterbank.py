"""Kaldi-style triangular mel filterbank (port of efficientat_tpu/ops/filterbank.py).

HTK mel scale ``1127 * ln(1 + f/700)``, ``n_mels`` triangles spanning
[fmin, fmax], weights on the first ``n_fft/2`` FFT bins and a zero column for
the Nyquist bin (upstream models/preprocess.py:52-55).

Only the static branch is ported: every eval and serving call has fixed
fmin/fmax, and the banks are built on the host in float64 and cast to fp32
once, bit-identical to the JAX package's ``_mel_banks_np``. The jittered fp32
branch belongs to the training step and is not ported yet.
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


def kaldi_mel_banks(n_mels: int, n_fft: int, sample_rate: int, fmin: float,
                    fmax: float, device="cpu") -> torch.Tensor:
    """Triangular mel filterbank ``(n_mels, n_fft // 2 + 1)`` fp32 on ``device``.

    The final (Nyquist) column is always zero, matching the reference's
    explicit zero-pad of the Kaldi bank (models/preprocess.py:54).
    """
    banks = _mel_banks_np(n_mels, n_fft, sample_rate, float(fmin), float(fmax))
    return torch.from_numpy(banks).to(device)
