"""Plain log-mel front end in float64 (upstream models/preprocess.py,
``AugmentMelSTFT``): pre-emphasis ``x[t+1] - 0.97 x[t]``, a centred STFT
(n_fft, hop, a symmetric Hann window of ``win_length`` in the middle of the
frame, reflect pad), power, a Kaldi triangular mel bank on the HTK scale
with a zero Nyquist column, ``log(x + 1e-5)``, ``(x + 4.5) / 5``.

The bank is applied in float64 as float32 values. Serving builds it at
fmin and fmax in float64 and rounds it once; training builds it at the
jittered fmin and fmax in float32, as the training step does (upstream's
torchaudio ``get_mel_banks`` builds in float32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

PREEMPH = 0.97


def effective_fmax(mel) -> float:
    """fmax, or Nyquist less half the fmax jitter where it is null."""
    if mel["fmax"] is None:
        return float(mel["sr"] // 2 - mel["fmax_aug_range"] // 2)
    return float(mel["fmax"])


def mel_banks(mel, fmin: float, fmax: float, device,
              build: torch.dtype = torch.float32) -> torch.Tensor:
    """(n_mels, n_fft // 2 + 1) float32 Kaldi bank between fmin and fmax,
    computed in ``build``."""
    f32 = dict(dtype=build, device=device)

    def scale(f):
        return 1127.0 * torch.log(1.0 + f / 700.0)

    n_mels, n_fft = mel["n_mels"], mel["n_fft"]
    lo = scale(torch.tensor(float(fmin), **f32))
    hi = scale(torch.tensor(float(fmax), **f32))
    delta = (hi - lo) / (n_mels + 1)
    left = lo + torch.arange(n_mels, **f32)[:, None] * delta
    center = left + delta
    right = center + delta
    bins = scale(mel["sr"] / n_fft * torch.arange(n_fft // 2, **f32))[None, :]
    up = (bins - left) / (center - left)
    down = (right - bins) / (right - center)
    weights = torch.clamp(torch.minimum(up, down), min=0.0)
    return torch.cat([weights, torch.zeros(n_mels, 1, **f32)], dim=1).to(torch.float32)


def log_mel(wave: torch.Tensor, mel, banks: torch.Tensor, dft_dtype=None) -> torch.Tensor:
    """(B, samples) -> (B, n_mels, frames) float32, computed in float64.
    ``dft_dtype=torch.bfloat16`` computes the DFT instead as one product of
    frames and windowed basis rounded to bf16, summed in float32, and the
    mel product in float32 (a control's lower precision)."""
    n_fft, hop, win = mel["n_fft"], mel["hopsize"], mel["win_length"]
    x = wave.to(torch.float64)
    x = x[:, 1:] - PREEMPH * x[:, :-1]
    frames = x.shape[1] // hop + 1
    x = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    window = torch.zeros(n_fft, dtype=torch.float64, device=x.device)
    left = (n_fft - win) // 2
    window[left:left + win] = torch.hann_window(win, periodic=False,
                                                dtype=torch.float64, device=x.device)
    framed = x.unfold(1, n_fft, hop)[:, :frames]
    if dft_dtype is None:
        spec = torch.fft.rfft(framed * window, dim=-1)
        power = spec.real ** 2 + spec.imag ** 2
        out = torch.einsum("mf,btf->bmt", banks.to(torch.float64), power)
    else:
        k = torch.arange(n_fft // 2 + 1, dtype=torch.float64, device=x.device)
        ang = 2.0 * torch.pi * torch.arange(n_fft, dtype=torch.float64, device=x.device)[:, None] * k / n_fft
        basis = torch.cat([torch.cos(ang), torch.sin(ang)], dim=1) * window[:, None]
        proj = (framed.to(dft_dtype).float() @ basis.to(dft_dtype).float())
        power = proj[..., :n_fft // 2 + 1] ** 2 + proj[..., n_fft // 2 + 1:] ** 2
        out = torch.einsum("mf,btf->bmt", banks.float(), power)
    return ((torch.log(out + 1e-5) + 4.5) / 5.0).to(torch.float32)
