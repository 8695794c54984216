"""Run one cell of the benchmark on the card this process starts on.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic (``spec``), sets up its driver
(``mixes/<kind>.py``: the program, seeded weights and inputs, the warm-up),
measures for ``--seconds`` with tracing off, and with ``--trace 1`` then
profiles a few calls and reads the cell's per-layer metrics
(``metrics/<base>.py``). Last, with the program's state freed, it compares
what the timed path produced with the plain reference (``reference/``).
The numbers compared go to standard error, each beside its limit, as the
last lines there; the result is standard output's last line, one JSON
object. Without a CUDA card, or with fewer than the cell asks for, it
prints no result and exits 2; with JAX or the JAX package loaded once the
window has closed, it exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "efficientat_tpu")


class Context:
    """What a per-layer reader sees: the cell's driver session, the
    unprofiled window's counts, the profile of the traced calls, the
    configuration, the traffic and the device type."""

    def __init__(self, session, window, profile, cfg, traffic, device):
        self.session, self.window, self.profile = session, window, profile
        self.cfg, self.traffic, self.device = cfg, traffic, device


def banned_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({name.partition(".")[0] for name in sys.modules} & set(BANNED))


def run_cell(bench, name: str, seed: int, seconds: float, trace: bool, device: str,
             traffic=None, limits=None, t_start=T_START) -> dict:
    """One run of cell ``name``; returns the result object. ``traffic`` and
    ``limits`` replace the cell's files (the CPU tests run a small cell)."""
    import torch

    from portbench import device as dev
    from portbench import spec

    dev.no_tf32()
    cell = bench.cell(name)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"]) if traffic is None else traffic
    limits = bench.limits(name) if limits is None else limits
    start = time.perf_counter()
    session = spec.mix(traffic["kind"]).Session(cfg, traffic, seed, device)
    setup_s = time.perf_counter() - t_start
    phases = {"before_driver": start - t_start, **session.setup_phases}
    window = session.window(seconds)
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(0) if cuda else 0

    result = {"correct": False, "attempted": window["attempted"], "failed": 0}
    if trace:
        prof = dev.profile_calls(session.call, traffic["profiled_calls"], device)
        result["attempted"] += traffic["profiled_calls"]
        ctx = Context(session, window, prof, cfg, traffic, torch.device(device).type)
        metrics = {}
        for m in bench.per_layer(name):
            read, path = spec.reader(m["name"])
            value = read(ctx, path)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        card = dev.card(device, cell["chips"], peak)
        card.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
    else:
        values = session.end_to_end(window, setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in bench.end_to_end(name)}
        card = dev.card(device, cell["chips"], peak)
    numbers, failed = session.check(limits)
    result.update(failed=failed, metrics=metrics, device=card)
    result["correct"] = failed == 0 and all(v <= lim for v, lim in numbers.values())
    if trace:
        result["breakdown"] = dev.breakdown(prof)
    result["setup_phases_s"] = phases
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Run one cell of the benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import spec

    bench = spec.Bench()
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    found = banned_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
