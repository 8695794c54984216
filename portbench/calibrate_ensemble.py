"""The control and fault readings that an ensemble cell's limit is set
from, on the card, in one process (the program's own come from
``portbench.calibrate``, which runs any serving cell):

    python3 -m portbench.calibrate_ensemble --workload <cell> --seeds <n> ...

On each seed, over the cell's pool of batches, each against the reference
ensemble (``reference/ensemble.py``, TF32 off) by the cell's comparison,
the largest gap of a prob:

- controls, the reference one precision below each that the configuration
  states: TF32 on (``control_tf32_only``), and TF32 on with the DFT as one
  bf16 product (``control``);
- faults: one member left out (``fault_without_<member>``, each member in
  turn), the DyMN at temperature 30 in place of its ``t_max``
  (``fault_dymn_at_t30``), and the mean of the members' probs in place of
  the sigmoid of their mean logit (``fault_mean_of_probs``).

One JSON line a reading, then a summary line of each reading's smallest.
Lines also go to ``chiprun_out/calibrate_<cell>.jsonl``.
"""

from __future__ import annotations

import argparse
import collections
import json
from pathlib import Path

import torch

from portbench import device as dev
from portbench import gen, spec
from portbench.calibrate import tf32
from portbench.mixes.serve_ensemble import member_weights
from portbench.reference import ensemble as rens

T_FAULT = 30.0


def batch_readings(cfg, weights, wave: torch.Tensor) -> dict:
    """{who: largest prob gap} of every control and fault on one batch."""
    names = [m["registry_name"] for m in cfg["members"]]
    hot = [T_FAULT if m["family"] == "dymn" else None for m in cfg["members"]]
    logits = rens.member_logits(cfg, weights, wave)
    ref = rens.mean_sigmoid(logits)
    with tf32():
        probs = {"control": rens.serve_probs(cfg, weights, wave, dft_dtype=torch.bfloat16),
                 "control_tf32_only": rens.serve_probs(cfg, weights, wave)}
    for k, name in enumerate(names):
        probs[f"fault_without_{name}"] = rens.mean_sigmoid(logits[:k] + logits[k + 1:])
    probs["fault_dymn_at_t30"] = rens.mean_sigmoid(
        rens.member_logits(cfg, weights, wave, temperatures=hot))
    probs["fault_mean_of_probs"] = torch.stack([torch.sigmoid(lg) for lg in logits]).mean(0)
    return {who: float((p - ref).abs().max()) for who, p in probs.items()}


def readings(bench, cell, seed: int, device) -> dict:
    """{who: largest prob gap over the cell's pool} of every control and
    fault on ``seed``."""
    dev.no_tf32()
    cfg = bench.config(cell["config"])
    weights = member_weights(cfg, seed, device)
    gap = collections.defaultdict(float)
    for x in gen.serve_pool(bench.traffic(cell["traffic"]), seed, device):
        for who, g in batch_readings(cfg, weights, torch.from_numpy(x).to(device)).items():
            gap[who] = max(gap[who], g)
    return dict(gap)


def main(argv=None):
    p = argparse.ArgumentParser(description="Control and fault readings of an ensemble cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate_ensemble needs a CUDA card")
    bench = spec.Bench()
    cell = bench.cell(args.workload)
    out = Path("chiprun_out") / f"calibrate_{args.workload}.jsonl"
    out.parent.mkdir(exist_ok=True)
    smallest = {}

    def emit(seed, who, numbers, **extra):
        line = json.dumps({"workload": args.workload, "seed": seed, "who": who,
                           "numbers": numbers, **extra})
        print(line, flush=True)
        with out.open("a") as f:
            f.write(line + "\n")

    for seed in args.seeds:
        for who, g in readings(bench, cell, seed, "cuda").items():
            emit(seed, who, {"prob_gap": g})
            smallest[f"{who}.prob_gap"] = min(g, smallest.get(f"{who}.prob_gap", g))
        torch.cuda.empty_cache()
    emit(None, "summary", smallest, card=torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
