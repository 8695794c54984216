"""The host's enqueueing of a serving call, ms a call: the program's
``tag.predict`` span less its ``tag.stage`` and ``tag.readback`` spans (the
host launching the copy, the decode, K1, the members and the sigmoid), over
the spans pass's calls (``portbench/spans.py``)."""

from portbench import spans


def read(ctx, path):
    if ctx.session.kind != path:
        return None
    predict = spans.by_call(ctx, "tag.predict")
    stage = spans.by_call(ctx, "tag.stage")
    readback = spans.by_call(ctx, "tag.readback")
    return spans.mean({c: ms - stage.get(c, 0.0) - readback.get(c, 0.0)
                       for c, ms in predict.items()})
