"""The train step's backward, ms a step: the CUDA-event time of the program's
``train.backward`` span (``zero_grad`` and ``loss.backward``), over the
spans pass's steps (``portbench/spans.py``). None without a card."""

from portbench import spans


def read(ctx, path):
    if ctx.session.kind != path:
        return None
    return spans.mean(spans.by_call(ctx, "train.backward", "device_ms"))
