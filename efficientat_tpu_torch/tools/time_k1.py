"""Time K1 against its plain version on the card.

    python -m efficientat_tpu_torch.tools.time_k1 [--batch 64 120] [--n_mels 128 256]
        [--precision fp32 bf16x3] [--turns 2] [--replace OLD NEW ...]

The inputs are the probe's (``tools.probe_mel_kernel.inputs``): at each
``--batch`` B, B random 10 s waves from seed 0 at hop 320, with the Kaldi
bank over 0-15 kHz at each ``--n_mels``. For each precision and bank: K1's
largest gap to its plain version, then ``stft_log_mel`` and
``stft_log_mel_plain`` timed in turns, each a median of CUDA events:
plain, kernel, serving, serving, kernel, plain, ``--turns`` times.
``kernel_ms`` tiles the banks in each call, as a training call does;
``serving_ms`` times the call with the banks tiled beforehand, as the
Tagger's (``tiled_serving_banks``). One JSON line each, naming the kernel
of the call's first launch (``mel_kernel.k1_route``; a bank over 256 mels
takes a launch for each group of 256, ``mel_groups``), and the kernels
alone (``kernel_alone_ms``: their device time a serving call in
``torch.profiler``, over 5 calls). First a line with K1's ptxas registers
and spills, when this process built it, and last the card's name and power
limit as ``nvidia-smi`` gives them. It uses only K1's public entry points,
so one copy of it times two checkouts of the package in one run; in a
checkout whose route for a bank takes no tiled banks (the ``tc_*`` routes
of the package before the kernel held 256 mels), ``serving_ms`` times the
call as it is.

``--replace OLD NEW`` (repeatable) times a variant of the kernels: K1 is
built from a copy of ``csrc/`` under ``build/time_k1/`` in which each OLD,
found exactly once in one of its files, reads NEW (say, another ring depth).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import shutil
import subprocess

import torch

from efficientat_tpu_torch.ops import _build, mel_kernel
from efficientat_tpu_torch.ops.filterbank import kaldi_mel_banks
from efficientat_tpu_torch.tools.probe_mel_kernel import inputs, median_ms


def time_k1(batch: int, n_mels: int, precision: str, turns: int) -> dict:
    """One record: K1 against its plain version at ``batch`` clips and an
    ``n_mels`` bank, in ``precision``."""
    waves, _, cfg = inputs(torch.device("cuda"), batch)
    cfg = dataclasses.replace(cfg, n_mels=n_mels)
    banks = kaldi_mel_banks(n_mels, cfg.n_fft, cfg.sr, 0.0, 15000.0, device="cuda")
    err = float((mel_kernel.stft_log_mel(waves, banks, cfg, precision)
                 - mel_kernel.stft_log_mel_plain(waves, banks, cfg, precision))
                .abs().max())
    route = mel_kernel.k1_route(cfg, precision)
    tiled = (None if route.startswith("tc_")
             else mel_kernel.tiled_serving_banks(cfg, waves.device))
    calls = {"plain": lambda: mel_kernel.stft_log_mel_plain(waves, banks, cfg, precision),
             "kernel": lambda: mel_kernel.stft_log_mel(waves, banks, cfg, precision),
             "serving": lambda: mel_kernel.stft_log_mel(waves, banks, cfg, precision,
                                                        tiled_banks=tiled)}
    runs = {which: [] for which in calls}
    for _ in range(turns):
        for which in ("plain", "kernel", "serving", "serving", "kernel", "plain"):
            runs[which].append(median_ms(calls[which]))
    return {"precision": precision, "batch": batch, "n_mels": n_mels,
            "kernel": mel_kernel.ROUTE_KERNELS[route], "max_abs": err,
            "kernel_ms": runs["kernel"], "serving_ms": runs["serving"],
            "plain_ms": runs["plain"], "kernel_alone_ms": kernel_alone_ms(calls["serving"])}


def kernel_alone_ms(fn, calls: int = 5):
    """The device time of K1's kernels a call of ``fn``: the mean of their
    ``torch.profiler`` events (``mel_kernel*``) times the launches a call,
    over ``calls`` calls after a warm-up; None where the profiler kept no
    event. The mean, since a process profiled before can lose its first
    device records (``utils/profiling.trace``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    before = sum(mel_kernel.LAUNCHES.values())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    launches = sum(mel_kernel.LAUNCHES.values()) - before
    events = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == DeviceType.CUDA and "mel_kernel" in e.name]
    return sum(events) / len(events) / 1e3 * launches / calls if events else None


def use_variant(replacements) -> str:
    """Point the build at a copy of ``csrc/`` with each (OLD, NEW) of
    ``replacements`` made; returns the copy's directory."""
    digest = hashlib.sha256(json.dumps(replacements).encode()).hexdigest()[:12]
    dst = _build.BUILD_DIR.parent / "time_k1" / digest
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.CSRC, dst)
    for old, new in replacements:
        hits = [f for f in sorted(dst.iterdir()) if old in f.read_text()]
        if len(hits) != 1 or hits[0].read_text().count(old) != 1:
            raise ValueError(f"{old!r} is not in exactly one place of csrc/")
        hits[0].write_text(hits[0].read_text().replace(old, new))
    _build.CSRC = dst
    return str(dst)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, nargs="+", default=[64])
    p.add_argument("--n_mels", type=int, nargs="+", default=[128, 256])
    p.add_argument("--precision", nargs="+", choices=("fp32", "bf16x3"),
                   default=["fp32", "bf16x3"])
    p.add_argument("--turns", type=int, default=2)
    p.add_argument("--replace", nargs=2, action="append", default=[],
                   metavar=("OLD", "NEW"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_k1 needs a CUDA device; none is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.replace:
        print(json.dumps({"variant": args.replace, "csrc": use_variant(args.replace)}),
              flush=True)
    _build.load_library("mel_kernel")
    print(json.dumps({"ptxas": [ln.split(":", 1)[-1].strip() for ln in
                                _build.BUILD_LOG.get("mel_kernel", "").splitlines()
                                if "registers" in ln or "spill" in ln
                                or "Compiling entry" in ln]}), flush=True)
    for batch in args.batch:
        for n_mels in args.n_mels:
            for precision in args.precision:
                print(json.dumps(time_k1(batch, n_mels, precision, args.turns)),
                      flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
