"""PaSST's MLPs inside a real serving call, ms a call: the CUDA-event time
of the program's ``passt.mlp`` spans (one around each block's ``fc1``,
GELU and ``fc2``), summed a call, over the spans pass's calls
(``portbench/spans.py``). None without a card, and where the program
records no such span."""

from portbench import spans


def read(ctx, path):
    if ctx.session.kind != path:
        return None
    return spans.mean(spans.by_call(ctx, "passt.mlp", "device_ms"))
