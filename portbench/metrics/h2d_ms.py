"""Host-to-device copy time a call: the profiler's HtoD memcpy rows over
the profiled calls, summed, over the calls."""


def read(ctx, path):
    prof = ctx.profile
    if ctx.session.kind != path:
        return None
    rows = [end - start for start, end, name in prof["rows"] if "HtoD" in name]
    return sum(rows) / 1e3 / prof["calls"] if rows else None
