"""The members inside a real serving call, ms a call: the CUDA-event time
of the program's ``tag.members`` span (events on the call's stream before
the first member kernel and after the last), over the spans pass's calls
(``portbench/spans.py``). The in-call counterpart of ``model_ms``; None
without a card."""

from portbench import spans


def read(ctx, path):
    if ctx.session.kind != path:
        return None
    return spans.mean(spans.by_call(ctx, "tag.members", "device_ms"))
