"""The readings that an HTS-AT cell's limit is set from, on the card, in one
process:

    python3 -m portbench.calibrate_htsat --workload <cell> --seeds <n> ...

On each seed: the program, a run of the cell (``run.run_cell``, tracing
off, a ``SECONDS`` window, no limit), its largest prob gap; then, over the
cell's pool of batches, each against the reference (``reference/htsat.py``,
TF32 off) by the cell's comparison, the largest gap of a prob:

- controls, the reference one precision below the float32 that the
  configuration states: TF32 on (``control_tf32``), and the front end's DFT
  and mel products in float32 with TF32 on (``control_frontend_tf32``);
- faults: every block unshifted and unmasked (``fault_no_shift``), the
  relative-position bias left out (``fault_no_rel_bias``), the 1001 frames
  padded to 1024 with zeros in place of the bicubic stretch
  (``fault_zero_pad``), the merges' x1 and x2 swapped
  (``fault_merge_swap``), and the GELU in its tanh form
  (``fault_gelu_tanh``).

One JSON line a reading, then a summary line: the program's largest, each
control's and fault's smallest. Lines also go to
``chiprun_out/calibrate_<cell>.jsonl``.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
from pathlib import Path

import torch

from portbench import device as dev
from portbench import gen, spec
from portbench.calibrate import tf32
from portbench.mixes.serve_htsat import weights
from portbench.reference import htsat as rhtsat
from portbench.run import run_cell

# the window of the program's run on each seed
SECONDS = 5.0
# each fault: the reference's keywords that plant it
FAULTS = {"fault_no_shift": {"shift": False}, "fault_no_rel_bias": {"rel_bias": False},
          "fault_zero_pad": {"stretch": "zero_pad"},
          "fault_merge_swap": {"merge_order": (0, 2, 1, 3)},
          "fault_gelu_tanh": {"gelu": "tanh"}}


def batch_readings(cfg, sd, wave: torch.Tensor) -> dict:
    """{who: largest prob gap} of every control and fault on one batch."""
    ref = rhtsat.serve_probs(cfg, sd, wave)
    probs = {who: rhtsat.serve_probs(cfg, sd, wave, **kw) for who, kw in FAULTS.items()}
    probs["control_frontend_tf32"] = rhtsat.serve_probs(cfg, sd, wave, frontend="tf32")
    with tf32():
        probs["control_tf32"] = rhtsat.serve_probs(cfg, sd, wave)
    return {who: float((p - ref).abs().max()) for who, p in probs.items()}


def readings(bench, cell, seed: int, device) -> dict:
    """{who: largest prob gap over the cell's pool} of every control and
    fault on ``seed``."""
    dev.no_tf32()
    cfg = bench.config(cell["config"])
    sd = weights(cfg, seed, device)
    gap = collections.defaultdict(float)
    for x in gen.serve_pool(bench.traffic(cell["traffic"]), seed, device):
        for who, g in batch_readings(cfg, sd, torch.from_numpy(x).to(device)).items():
            gap[who] = max(gap[who], g)
    return dict(gap)


def main(argv=None):
    p = argparse.ArgumentParser(description="Program, control and fault readings of an "
                                            "HTS-AT cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate_htsat needs a CUDA card")
    bench = spec.Bench()
    cell = bench.cell(args.workload)
    out = Path("chiprun_out") / f"calibrate_{args.workload}.jsonl"
    out.parent.mkdir(exist_ok=True)
    summary = {}

    def emit(seed, who, numbers, **extra):
        line = json.dumps({"workload": args.workload, "seed": seed, "who": who,
                           "numbers": numbers, **extra})
        print(line, flush=True)
        with out.open("a") as f:
            f.write(line + "\n")

    def keep(who, g):
        pick = max if who == "program" else min
        key = f"{who}.prob_gap"
        summary[key] = pick(g, summary.get(key, g))

    no_limit = collections.defaultdict(lambda: math.inf)
    for seed in args.seeds:
        r = run_cell(bench, args.workload, seed, SECONDS, False, "cuda", limits=no_limit)
        g = r["checks"]["prob_gap"]["value"]
        emit(seed, "program", {"prob_gap": g}, attempted=r["attempted"],
             metrics={k: m["value"] for k, m in r["metrics"].items()})
        keep("program", g)
        torch.cuda.empty_cache()
        for who, g in readings(bench, cell, seed, "cuda").items():
            emit(seed, who, {"prob_gap": g})
            keep(who, g)
        torch.cuda.empty_cache()
    emit(None, "summary", summary, card=torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
