"""The least time of HTS-AT's windowed attention in a serving call on an
H100, from the work itself, whatever implements it.

Operations: q k^T and p v inside each window of N = window^2 tokens, 2 x
tokens x N x C multiply-adds a clip and a block, so 4 x B x tokens x N x C
FLOPs a block, each priced once at the bf16 dense peak (the softmax's
exponentials are left out). Bytes: q, k and v read once and o written once,
each B x tokens x C float32 values a block, and the block's combined bias
once (float32: heads x N^2 values where every window shares it, an
unshifted block's relative-position bias; windows x heads x N^2 where the
shift mask makes it differ by window), at the HBM peak. The bound is the
larger: at the published widths, bytes. A clip of up to 1,024 frames is
stretched to them, so the work does not depend on the clip's length.
"""

from portbench.count.peaks import FLOPS, HBM_BYTES_PER_S
from portbench.reference.htsat import stages


def work(batch: int, cfg):
    """(FLOPs, bytes) of a call's windowed attention over every block."""
    flops = nbytes = 0
    for dim, res, heads, depth, window, shift in stages(cfg):
        n, tokens = window * window, res * res
        windows = (res // window) ** 2
        for j in range(depth):
            flops += 4 * batch * tokens * n * dim
            shared = 1 if not (shift and j % 2) else windows
            nbytes += 4 * (4 * batch * tokens * dim + shared * heads * n * n)
    return flops, nbytes


def bound_s(batch: int, cfg) -> float:
    """Seconds: the larger of the operations and the bytes of a call."""
    flops, nbytes = work(batch, cfg)
    return max(flops / FLOPS["bfloat16"], nbytes / HBM_BYTES_PER_S)
