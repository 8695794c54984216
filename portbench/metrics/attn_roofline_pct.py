"""Attention's share of its roofline: the count's least time of a call's
attention (``count/attn.py``: every block, the cell's batch, the tokens of
its clips) over ``attn_ms``, the CUDA-event time of the program's
``passt.attn`` spans a call. None where ``attn_ms`` reads nothing."""

from portbench import spans
from portbench.count import attn, k1


def read(ctx, path):
    if ctx.session.kind != path:
        return None
    ms = spans.mean(spans.by_call(ctx, "passt.attn", "device_ms"))
    if ms is None:
        return None
    samples = int(ctx.traffic["clip_seconds"] * ctx.traffic["sr"])
    n = attn.tokens(ctx.cfg, k1.frames(samples, ctx.cfg["mel"]["hopsize"]))
    return 100.0 * attn.bound_s(ctx.traffic["batch"], n, ctx.cfg) / (ms / 1e3)
