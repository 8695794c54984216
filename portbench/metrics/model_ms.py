"""The served member's forward alone on the cell's log-mels, in inference
mode (a DyMN at its ``t_max``): ms a call, from CUDA events around
back-to-back calls."""

from portbench.device import event_seconds

CALLS = 10


def read(ctx, path):
    if ctx.session.kind != path:
        return None
    seconds = event_seconds(ctx.session.model_call(), CALLS)
    return None if seconds is None else 1e3 * seconds
