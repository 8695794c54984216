"""K1's share of its roofline: the count's least time of a log-mel call
(``count/k1.py``) over the device time that the call's kernels take in the
traced run: the union of the profiler's rows of K1's kernels (the program's
own names: the DFT and mel kernel of each route, ``mel_edges``,
``tile_banks``) over the profiled calls, per call. A serving call and a
train step each make one log-mel call of the cell's batch."""

from portbench.count import k1
from portbench.device import merge


def kernel_names() -> tuple:
    """The names of K1's kernels as the program gives them; a profiler row
    is K1's where one of them is part of its name."""
    from efficientat_tpu_torch.ops import mel_kernel

    routes = {name.split("<")[0] for name in mel_kernel.ROUTE_KERNELS.values()}
    return tuple(sorted(routes)) + tuple(mel_kernel.CALL_KERNELS)


def read(ctx, path):
    prof = ctx.profile
    if ctx.session.kind != path:
        return None
    names = kernel_names()
    rows = [(start, end) for start, end, name in prof["rows"]
            if any(n in name for n in names)]
    if not rows:
        return None
    seconds = sum(end - start for start, end in merge(rows)) / 1e6 / prof["calls"]
    samples = int(ctx.traffic["clip_seconds"] * ctx.traffic["sr"])
    return 100.0 * k1.bound_s(ctx.traffic["batch"], samples, ctx.cfg["mel"]) / seconds
