"""HTS-AT's windowed attention's share of its roofline: the count's least
time of a call's windowed attention (``count/win_attn.py``: every block,
the cell's batch) over ``win_attn_ms``, the CUDA-event time of the
program's ``htsat.attn`` spans a call. None where ``win_attn_ms`` reads
nothing."""

from portbench import spans
from portbench.count import win_attn


def read(ctx, path):
    if ctx.session.kind != path:
        return None
    ms = spans.mean(spans.by_call(ctx, "htsat.attn", "device_ms"))
    if ms is None:
        return None
    return 100.0 * win_attn.bound_s(ctx.traffic["batch"], ctx.cfg) / (ms / 1e3)
