"""HTS-AT's windowed attention inside a real serving call, ms a call: the
CUDA-event time of the program's ``htsat.attn`` spans (one around each
block's windowed-attention call, q, k, v and bias in and o out), summed a
call, over the spans pass's calls (``portbench/spans.py``). None without a
card, and where the program records no such span."""

from portbench import spans


def read(ctx, path):
    if ctx.session.kind != path:
        return None
    return spans.mean(spans.by_call(ctx, "htsat.attn", "device_ms"))
