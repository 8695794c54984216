"""The host's staging of a serving call, ms a call: the self time of the
program's ``tag.stage`` span (the batch made contiguous and copied into the
pinned buffer), over the spans pass's calls (``portbench/spans.py``)."""

from portbench import spans


def read(ctx, path):
    if ctx.session.kind != path:
        return None
    return spans.mean(spans.by_call(ctx, "tag.stage", "self_ms"))
