"""The train step's optimizer, ms a step: the CUDA-event time of the program's
``train.optimizer`` span (``optimizer.step`` and the scheduler), over the
spans pass's steps (``portbench/spans.py``). None without a card."""

from portbench import spans


def read(ctx, path):
    if ctx.session.kind != path:
        return None
    return spans.mean(spans.by_call(ctx, "train.optimizer", "device_ms"))
