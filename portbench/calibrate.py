"""The readings that a cell's limits are set from, on the card, in one
process: the program's numbers over many seeds (the lower reading), the
control's, and for a train cell the planted faults' (the upper reading).

    python3 -m portbench.calibrate --workload <cell> --seeds <n> ... \\
        [--control_seeds <n> ...] [--seconds 5]

Program: a run of the cell (``run.run_cell``, tracing off, a short window)
on each of ``--seeds``, its numbers printed. Control: the reference in the
program's place one precision below each that the configuration states:
TF32 on for the model (float32 with TF32 off) and the DFT as one bf16
product (bf16x3), judged against the reference by the same comparison, on
each of ``--control_seeds``; for a train cell also the reference with half
of the batch left out of the loss (the mean over the rest). One JSON line
a reading, then a summary line: the largest program reading and the
smallest control and fault readings of each number. Lines also go to
``chiprun_out/calibrate_<cell>.jsonl``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
from pathlib import Path

import torch
import torch.nn.functional as F

from portbench import device as dev
from portbench import gen, spec
from portbench.run import run_cell


@contextlib.contextmanager
def tf32():
    """TF32 on for cuDNN and cuBLAS inside, restored after."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def half_batch_loss(logits, batch, perm, lam, kd_lambda):
    """``kd_loss`` over the first half of the rows only."""
    h = logits.shape[0] // 2
    lam_ = lam[:, None]
    y = batch["target"] * lam_ + batch["target"][perm] * (1.0 - lam_)
    label = F.binary_cross_entropy_with_logits(logits[:h], y[:h])

    def soft(t):
        return F.binary_cross_entropy_with_logits(logits, t, reduction="none").mean(dim=1)

    kd = soft(batch["teacher"]) * lam + soft(batch["teacher"][perm]) * (1.0 - lam)
    kd = (kd * batch["teacher_valid"])[:h].mean()
    return kd_lambda * label + (1.0 - kd_lambda) * kd


def serve_control(bench, cell, seed, device):
    from portbench.reference.steps import serve_probs

    dev.no_tf32()
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    weights = gen.weights(cfg, seed, device)
    gap = {"control": 0.0, "control_tf32_only": 0.0}
    for x in gen.serve_pool(traffic, seed, device):
        wave = torch.from_numpy(x).to(device)
        ref = serve_probs(cfg, weights, wave)
        with tf32():
            ctl = {"control": serve_probs(cfg, weights, wave, dft_dtype=torch.bfloat16),
                   "control_tf32_only": serve_probs(cfg, weights, wave)}
        for who, probs in ctl.items():
            gap[who] = max(gap[who], float((probs - ref).abs().max()))
    return [(who, {"prob_gap": g}) for who, g in gap.items()]


def train_readings(bench, cell, seed, device, control: bool):
    """The program's numbers on ``seed`` and, with ``control``, the
    control's and the half-batch fault's against the same reference."""
    from portbench.mixes import train
    from portbench.reference.steps import train_steps

    dev.no_tf32()
    session = train.Session(bench.config(cell["config"]), bench.traffic(cell["traffic"]),
                            seed, device)
    prog = (session.checked_losses, session.first_grad, session.change)
    del session.model, session.optimizer
    torch.cuda.empty_cache()
    inputs = session.reference_inputs()
    ref = train.readings(session.weights, *train_steps(*inputs))
    def numbers(side):
        return {**train.compare(side, ref), **train.worst_leaf(side, ref)}

    out = [("program", numbers(prog))]
    if control:
        with tf32():
            ctl = train.readings(session.weights,
                                 *train_steps(*inputs, dft_dtype=torch.bfloat16))
            tf32_only = train.readings(session.weights, *train_steps(*inputs))
        half = train.readings(session.weights, *train_steps(*inputs, loss_fn=half_batch_loss))
        out += [("control", numbers(ctl)), ("control_tf32_only", numbers(tf32_only)),
                ("fault_half_batch", numbers(half))]
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Readings for a cell's limits.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control_seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate needs a CUDA card")
    bench = spec.Bench()
    cell = bench.cell(args.workload)
    kind = bench.traffic(cell["traffic"])["kind"]
    out = Path("chiprun_out") / f"calibrate_{args.workload}.jsonl"
    out.parent.mkdir(exist_ok=True)
    summary = collections.defaultdict(lambda: collections.defaultdict(list))

    def emit(seed, who, numbers, **extra):
        line = json.dumps({"workload": args.workload, "seed": seed, "who": who,
                           "numbers": numbers, **extra})
        print(line, flush=True)
        with out.open("a") as f:
            f.write(line + "\n")
        for k, v in numbers.items():
            summary[who][k].append(v)

    no_limit = collections.defaultdict(lambda: math.inf)
    for seed in args.seeds:
        if kind == "train":
            for who, numbers in train_readings(bench, cell, seed, "cuda",
                                               seed in args.control_seeds):
                emit(seed, who, numbers)
            continue
        r = run_cell(bench, args.workload, seed, args.seconds, False, "cuda", limits=no_limit)
        emit(seed, "program", {k: c["value"] for k, c in r["checks"].items()},
             attempted=r["attempted"], metrics={k: m["value"] for k, m in r["metrics"].items()})
        torch.cuda.empty_cache()
    if kind == "serve":
        for seed in args.control_seeds:
            for who, numbers in serve_control(bench, cell, seed, "cuda"):
                emit(seed, who, numbers)
    pick = {"program": max}
    emit(None, "summary", {f"{who}.{k}": pick.get(who, min)(v)
                           for who, nums in summary.items() for k, v in nums.items()},
         card=torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
