"""The whole call's share of the card's dense peak in the configuration's
precision: 2 (serving) or 3 x 2 (a train step: forward and backward) x the
configuration's MACs a 10 s clip x the clips a second of the traced run's
unprofiled window, over the peak."""

from portbench.count.peaks import FLOPS

FLOPS_A_MAC = {"serve": 2, "train": 6}


def read(ctx, path):
    if ctx.session.kind != path or ctx.traffic["clip_seconds"] != 10 or ctx.device != "cuda":
        return None
    rate = ctx.window["clips"] / ctx.window["wall_s"]
    flops = FLOPS_A_MAC[path] * ctx.cfg["macs_per_10s_clip"] * rate
    return 100.0 * flops / FLOPS[ctx.cfg["precision"]]
