"""The ensemble's DyMN member inside a real serving call, ms a call: the
CUDA-event time of the program's ``tag.member.dymn`` spans (one a member of
that family, inside ``tag.members``), summed a call, over the spans pass's
calls (``portbench/spans.py``). None without a card, and where the program
records no such span."""

from portbench import spans


def read(ctx, path):
    if ctx.session.kind != path:
        return None
    return spans.mean(spans.by_call(ctx, "tag.member.dymn", "device_ms"))
