"""Wave transport codecs: encode on the host, decode on the device (port of
efficientat_tpu/data/wavecodec.py).

Waves travel as float32 (``f32``), int16 PCM (``i16``) or mu-law uint8
(``mulaw8``: mu = 255, mid-tread at code 128, so silence decodes to exactly
0.0). The host side, ``encode`` and its helpers, is numpy only and is a copy
of the JAX package's, verbatim; ``decode`` is the device side in PyTorch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CODECS = ("f32", "i16", "mulaw8")
_MU = 255.0

# int16 -> mu-law uint8 lookup (the common storage format), built lazily:
# 64K table, exact vs the float formula by construction
_I16_TO_MULAW = None


def mulaw_encode(x: np.ndarray) -> np.ndarray:
    """float32 [-1, 1] -> uint8 mu-law code.

    Mid-tread mapping centered at code 128 so SILENCE IS EXACT: encoded
    zeros decode to exactly 0.0 (zero-padded clip tails and masked eval
    regions must stay zero through the transport). Costs one code level
    at positive full scale (+1.0 clips to 0.9961 pre-compander)."""
    x = np.clip(x, -1.0, 1.0)
    y = np.sign(x) * np.log1p(_MU * np.abs(x)) / np.log1p(_MU)
    return np.clip(np.round(y * 127.5) + 128.0, 0.0, 255.0).astype(np.uint8)


def mulaw_decode(u: np.ndarray) -> np.ndarray:
    """uint8 mu-law code -> float32 (host-side oracle for the device op)."""
    y = (u.astype(np.float32) - 128.0) / 127.5
    return np.sign(y) * (np.expm1(np.abs(y) * np.log1p(_MU)) / _MU)


def _i16_mulaw_table() -> np.ndarray:
    # indexed by the int16 value REINTERPRETED as uint16 (a free .view),
    # so the hot path is one fancy-index with no cast or offset add
    global _I16_TO_MULAW
    if _I16_TO_MULAW is None:
        pcm = np.arange(65536, dtype=np.uint16).view(np.int16).astype(np.float32)
        _I16_TO_MULAW = mulaw_encode(pcm / 32768.0)
    return _I16_TO_MULAW


def encode(wave: np.ndarray, codec: str) -> np.ndarray:
    """Encode a float32 or int16 wave for transport."""
    if codec == "f32":
        return wave.astype(np.float32) if wave.dtype != np.float32 else wave
    if codec == "i16":
        if wave.dtype == np.int16:
            return wave
        return np.clip(wave * 32768.0, -32768, 32767).astype(np.int16)
    if codec == "mulaw8":
        if wave.dtype == np.int16:  # table path: no float conversion
            return _i16_mulaw_table()[wave.view(np.uint16)]
        return mulaw_encode(wave)
    raise ValueError(f"unknown wave codec {codec!r}; pick one of {CODECS}")


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
