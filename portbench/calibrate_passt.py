"""The readings that a PaSST cell's limit is set from, on the card, in one
process:

    python3 -m portbench.calibrate_passt --workload <cell> --seeds <n> ...

On each seed: the program, a run of the cell (``run.run_cell``, tracing
off, a ``SECONDS`` window, no limit), its largest prob gap; then, over the cell's
pool of batches, each against the reference (``reference/passt.py``, TF32
off) by the cell's comparison, the largest gap of a prob:

- controls, the reference one precision below each that the configuration
  states: TF32 on (``control_tf32_only``), and TF32 on with the DFT as one
  bf16 product (``control``);
- faults: the GELU in its tanh form (``fault_gelu_tanh``), the head on the
  class token alone (``fault_cls_only``), the time embedding rolled by
  one patch (``fault_time_shift``), and two in attention: every query kept
  from the last ``TAIL_KEYS`` keys, the tail that a 64-key tile leaves at
  1,190 tokens (``fault_attn_tail``), and the scores scaled by 1/64 in
  place of 1/8 (``fault_attn_scale``).

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
from portbench.mixes.serve_passt import weights
from portbench.reference import passt as rpasst
from portbench.run import run_cell

# the window of the program's run on each seed
SECONDS = 5.0
# the keys past the last whole 64-key tile at 1,190 tokens (1190 = 18 x 64 + 38)
TAIL_KEYS = 38


def batch_readings(cfg, sd, wave: torch.Tensor) -> dict:
    """{who: largest prob gap} of every control and fault on one batch."""
    ref = rpasst.serve_probs(cfg, sd, wave)
    shifted = dict(sd, time_new_pos_embed=torch.roll(sd["time_new_pos_embed"], 1, -1))
    probs = {"fault_gelu_tanh": rpasst.serve_probs(cfg, sd, wave, gelu="tanh"),
             "fault_cls_only": rpasst.serve_probs(cfg, sd, wave, head_tokens=(0,)),
             "fault_time_shift": rpasst.serve_probs(cfg, shifted, wave),
             "fault_attn_tail": rpasst.serve_probs(cfg, sd, wave, drop_keys=TAIL_KEYS),
             "fault_attn_scale": rpasst.serve_probs(cfg, sd, wave, attn_scale=1 / 64)}
    with tf32():
        probs["control"] = rpasst.serve_probs(cfg, sd, wave, dft_dtype=torch.bfloat16)
        probs["control_tf32_only"] = rpasst.serve_probs(cfg, sd, wave)
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
    p = argparse.ArgumentParser(description="Program, control and fault readings of a "
                                            "PaSST cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate_passt needs a CUDA card")
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
