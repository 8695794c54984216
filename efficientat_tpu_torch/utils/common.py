"""Shared numeric helpers.

Copy of ``efficientat_tpu/utils/common.py``, verbatim but for import paths:
the port imports nothing of the JAX package. ``host_init``, which runs a
flax init, is left out.

Behavior parity notes reference the upstream repo:
- ``make_divisible``: models/mn/utils.py:8-21 (round channel counts to a
  divisor, never shrinking by more than 10%).
- ``cnn_out_size``: models/mn/utils.py:24-26.
- ``NAME_TO_WIDTH``: helpers/utils.py:1-32.
"""

from __future__ import annotations

import math
from typing import Optional


def make_divisible(v: float, divisor: int, min_value: Optional[int] = None) -> int:
    """Round ``v`` to the nearest multiple of ``divisor`` (>= 90% of ``v``)."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def cnn_out_size(in_size: int, padding: int, dilation: int, kernel: int, stride: int) -> int:
    """Spatial output size of a conv with torch-style explicit padding."""
    s = in_size + 2 * padding - dilation * (kernel - 1) - 1
    return math.floor(s / stride + 1)


_MN_WIDTHS = {
    "mn01": 0.1,
    "mn02": 0.2,
    "mn04": 0.4,
    "mn05": 0.5,
    "mn06": 0.6,
    "mn08": 0.8,
    "mn10": 1.0,
    "mn12": 1.2,
    "mn14": 1.4,
    "mn16": 1.6,
    "mn20": 2.0,
    "mn30": 3.0,
    "mn40": 4.0,
}

_DYMN_WIDTHS = {
    "dymn04": 0.4,
    "dymn10": 1.0,
    "dymn20": 2.0,
}


def NAME_TO_WIDTH(name: str) -> float:
    """Map a model name prefix to its width multiplier (default 1.0)."""
    try:
        if name.startswith("dymn"):
            return _DYMN_WIDTHS[name[:6]]
        return _MN_WIDTHS[name[:4]]
    except (KeyError, AttributeError):
        return 1.0
