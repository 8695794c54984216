"""The host's wait for the device in a serving call, ms a call: the
program's ``tag.readback`` span (``probs.cpu()``, which waits for every
kernel of the call), over the spans pass's calls (``portbench/spans.py``)."""

from portbench import spans


def read(ctx, path):
    if ctx.session.kind != path:
        return None
    return spans.mean(spans.by_call(ctx, "tag.readback"))
