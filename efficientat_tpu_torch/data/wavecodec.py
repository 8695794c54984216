"""Wave transport decode on the device (port of efficientat_tpu/data/wavecodec.py).

Waves travel as float32, int16 PCM or mu-law uint8 (mu = 255, mid-tread at
code 128, so silence decodes to exactly 0.0). The host side, ``encode``, is
numpy only and is reused from the JAX package unchanged:
``efficientat_tpu.data.wavecodec.encode``.
"""

from __future__ import annotations

import math

import torch

_MU = 255.0


def decode(wave: torch.Tensor) -> torch.Tensor:
    """Decode a transported wave to float32 on its own device, by dtype:
    int16 is PCM, uint8 is mu-law, float32 passes through."""
    if wave.dtype == torch.int16:
        return wave.to(torch.float32) * (1.0 / 32768.0)
    if wave.dtype == torch.uint8:
        y = (wave.to(torch.float32) - 128.0) * (1.0 / 127.5)
        scale = math.log1p(_MU)
        return torch.sign(y) * (torch.expm1(torch.abs(y) * scale) * (1.0 / _MU))
    if wave.dtype != torch.float32:
        raise TypeError(f"waves travel as float32, int16 or uint8, got {wave.dtype}")
    return wave
