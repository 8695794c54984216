"""Share of the profiled calls' host-clock span in which no kernel, copy
or memset ran on the device: 100 x (1 - union of the device rows / span)."""


def read(ctx, path):
    prof = ctx.profile
    if ctx.session.kind != path or not prof["rows"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
