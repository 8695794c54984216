"""The least time of a transformer call's attention on an H100, from the
work itself, whatever implements it.

Operations: q k^T and p v, 2 x N^2 x embed_dim multiply-adds a clip and a
block, so 4 x B x N^2 x embed_dim FLOPs a block, each priced once at the
bf16 dense peak (the softmax's exponentials are left out). Bytes: q, k and v
read once and o written once, each B x N x embed_dim float32 values a
block, at the HBM peak. The bound is the larger. A later attention kernel,
at bf16x3 or any other precision, is read on the same yardstick, and no
implementation can beat it.
"""

from portbench.count.peaks import FLOPS, HBM_BYTES_PER_S
from portbench.reference.passt import grid


def tokens(cfg, frames: int) -> int:
    """Tokens of a clip of ``frames`` mel frames through the configuration's
    patch grid: F' x T' patches, T' cut to the time embedding's columns,
    and the class token and, where distilled, the distillation token."""
    f, t = grid(cfg, min(frames, cfg["input_tdim"]))
    return f * t + (2 if cfg["distilled"] else 1)


def bound_s(batch: int, n: int, cfg) -> float:
    """Seconds: the larger of the operations and the bytes of a call's
    attention over every block, ``n`` tokens a clip."""
    e, depth = cfg["embed_dim"], cfg["depth"]
    flops = depth * 4 * batch * n * n * e
    nbytes = depth * 4 * 4 * batch * n * e
    return max(flops / FLOPS["bfloat16"], nbytes / HBM_BYTES_PER_S)
