"""HTS-AT's window data movement inside a real serving call, ms a call: the
CUDA-event time of the program's ``htsat.window`` spans (around each
block's roll and window partition before its attention, and around its
window reverse and roll back after it), summed a call, over the spans
pass's calls (``portbench/spans.py``). None without a card, and where the
program records no such span."""

from portbench import spans


def read(ctx, path):
    if ctx.session.kind != path:
        return None
    return spans.mean(spans.by_call(ctx, "htsat.window", "device_ms"))
