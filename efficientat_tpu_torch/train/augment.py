"""Batch augmentations of the train step (port of efficientat_tpu/train/augment.py).

- mixup: permutation + Beta(a, a) coefficients with lam = max(l, 1 - l)
  (helpers/utils.py:90-95), applied to the log-mels and the targets as the
  training loops do (ex_audioset.py:141-148).
- mixstyle: frequency-wise feature-statistics mixing (helpers/utils.py:101-121,
  used by ex_dcase20.py:104-107): statistics over (channel, time) of NCHW,
  i.e. per (clip, mel bin).

A ``torch.Generator`` cannot drive a Beta draw, so the draws come from a
seeded ``numpy.random.Generator`` on the host: B scalars a step. Every
function also takes its draws explicitly, so a test can replay the JAX key's
draws and a data-parallel rank can apply the global batch's draws.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def mixup_coefficients(rng: np.random.Generator, batch_size: int,
                       alpha: float):
    """Returns (perm (B,) int64, lam (B,) float32) with lam >= 0.5."""
    perm = rng.permutation(batch_size)
    lam = rng.beta(alpha, alpha, batch_size).astype(np.float32)
    return perm, np.maximum(lam, 1.0 - lam)


def _tensor(a, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """A draw (numpy array or tensor) as a tensor on ``like``'s device."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))  # a copy: draws may be read-only
    return a.to(like.device, dtype)


def apply_mixup(x: torch.Tensor, perm, lam) -> torch.Tensor:
    """Convex-combine x with x[perm]; lam broadcasts over trailing dims."""
    perm = _tensor(perm, x)
    lam = _tensor(lam, x, x.dtype).reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    return x * lam + x[perm] * (1.0 - lam)


@dataclasses.dataclass(frozen=True)
class MixStyleDraws:
    apply: bool         # the per-batch gate: uniform <= p
    lam: np.ndarray     # (B,) float32 Beta(alpha, alpha)
    perm: np.ndarray    # (B,) int64


def mixstyle_draws(rng: np.random.Generator, batch_size: int, p: float,
                   alpha: float) -> MixStyleDraws:
    return MixStyleDraws(apply=bool(rng.random() <= p),
                         lam=rng.beta(alpha, alpha, batch_size).astype(np.float32),
                         perm=rng.permutation(batch_size))


def mixstyle(x: torch.Tensor, draws: MixStyleDraws,
             eps: float = 1e-6) -> torch.Tensor:
    """Frequency-wise MixStyle on (B, C, F, T): per-(clip, bin) mean and std
    over (C, T) are mixed with the permuted batch's. The statistics carry no
    gradient, as the reference's ``.detach()``."""
    if not draws.apply:
        return x
    mu = x.mean(dim=(1, 3), keepdim=True).detach()          # (B, 1, F, 1)
    var = x.var(dim=(1, 3), keepdim=True, correction=1).detach()
    sig = torch.sqrt(var + eps)
    x_normed = (x - mu) / sig
    lam = _tensor(draws.lam, x, x.dtype).reshape(-1, 1, 1, 1)
    perm = _tensor(draws.perm, x)
    mu_mix = mu * lam + mu[perm] * (1.0 - lam)
    sig_mix = sig * lam + sig[perm] * (1.0 - lam)
    return x_normed * sig_mix + mu_mix
