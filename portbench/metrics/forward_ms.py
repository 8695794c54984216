"""The train step's forward, ms a step: the CUDA-event time of the program's
``train.forward`` span (the model forward in train mode), over the spans
pass's steps (``portbench/spans.py``). None without a card."""

from portbench import spans


def read(ctx, path):
    if ctx.session.kind != path:
        return None
    return spans.mean(spans.by_call(ctx, "train.forward", "device_ms"))
