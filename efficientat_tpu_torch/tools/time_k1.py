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
``torch.profiler``, over 5 calls), and what a serving call and a call that
tiles its banks launch on the card (``serving_kernels``,
``kernel_kernels``: the device events of one call by kernel) and their
device time by kernel (``serving_device_ms``, ``kernel_device_ms``, with
the call's ``total``). After each bank's records, one for the edge
kernel at that batch and bank (``time_edges``): ``mel_edges`` and its plain
version, ``_patch_edges``, their device times and their largest gaps to
each other and to the float64 value of their function (``edge_oracle``).
First a line with K1's ptxas registers
and spills, when this process built it, and last the card's name and power
limit as ``nvidia-smi`` gives them. It uses only K1's public entry points
and ``utils/profiling``'s ``device_rows`` and ``median_ms``, so one copy of it
times two checkouts of the package that have them in one run; in a
checkout whose route for a bank takes no tiled banks (the ``tc_*`` routes
of the package before the kernel held 256 mels), ``serving_ms`` times the
call as it is.

``--replace OLD NEW`` (repeatable) times a variant of the kernels: K1 is
built from a copy of ``csrc/`` under ``build/time_k1/`` in which each OLD,
found exactly once in one of its files, reads NEW (say, another ring depth).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import hashlib
import json
import shutil
import statistics
import subprocess

import torch

from efficientat_tpu_torch.ops import _build, mel_kernel
from efficientat_tpu_torch.ops.filterbank import kaldi_mel_banks
from efficientat_tpu_torch.ops.melspec import _dft_basis, device_const, edge_frames
from efficientat_tpu_torch.tools.probe_mel_kernel import inputs
from efficientat_tpu_torch.utils.profiling import device_rows, median_ms


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
            "plain_ms": runs["plain"], "kernel_alone_ms": kernel_alone_ms(calls["serving"]),
            "serving_kernels": call_kernels(calls["serving"]),
            "kernel_kernels": call_kernels(calls["kernel"]),
            "serving_device_ms": call_device_ms(calls["serving"]),
            "kernel_device_ms": call_device_ms(calls["kernel"])}


# the hand-written kernels a K1 call may launch, as their device events
# name them
CALL_KERNEL_NAMES = ("mel_kernel_wgmma", "mel_edges", "tile_banks")


def _call_events(fn, repeats: int):
    """The device rows of one call of ``fn`` in ``repeats`` profiles that
    hold all of them (``utils/profiling.device_rows``; on one H100, two of
    three profiles of a K1 call have lacked its ``mel_edges`` row): a list a
    profile of (kernel, ms), each row named by the first of
    ``CALL_KERNEL_NAMES`` its name holds, else ``"other:"`` and its name (a
    copy, a fill, a PyTorch kernel)."""
    return [[(next((k for k in CALL_KERNEL_NAMES if k in name), "other:" + name[:60]), ms)
             for name, ms in rows]
            for rows in device_rows(fn, repeats=repeats)]


def call_kernels(fn, repeats: int = 3) -> dict:
    """What one call of ``fn`` runs on the card: {kernel: device events},
    from the profiles that hold them all (``_call_events``)."""
    return dict(collections.Counter(name for name, _ in _call_events(fn, repeats)[0]))


def call_device_ms(fn, repeats: int = 3) -> dict:
    """The device time of one call of ``fn`` by kernel, {kernel: ms}, and
    ``"total"``, the call's: each the median over the profiles that hold
    every event of the call (``_call_events``) of that profile's sum."""
    runs = []
    for run in _call_events(fn, repeats):
        ms = collections.defaultdict(float)
        for name, t in run:
            ms[name] += t
        runs.append(ms)
    return {**{name: statistics.median(ms[name] for ms in runs) for name in runs[0]},
            "total": statistics.median(sum(ms.values()) for ms in runs)}


def edge_oracle(wave, banks, cfg):
    """The edge frames' log-mel (B, n_mels, edge frames) in float64 on the
    wave's device, from the fp32 operands ``mel_edges`` takes: the
    pre-emphasised wave at the reflected index in fp32 (two roundings), the
    fp32 basis and banks, the power rounded to fp32, then float64."""
    n_samples = wave.shape[1]
    left, right = edge_frames(cfg.num_frames(n_samples), cfg.hopsize, cfg.n_fft,
                              n_samples - 1)
    t = (cfg.hopsize * torch.tensor(left + right, device=wave.device)[:, None]
         - cfg.n_fft // 2 + torch.arange(cfg.n_fft, device=wave.device)).abs()
    t = torch.where(t > n_samples - 2, 2 * (n_samples - 2) - t, t)
    xe = wave[:, t + 1] - 0.97 * wave[:, t]
    proj = xe.double() @ device_const(_dft_basis, (cfg.n_fft, cfg.win_length),
                                      str(wave.device)).double()
    power = (proj[..., :cfg.n_freqs] ** 2 + proj[..., cfg.n_freqs:] ** 2).float().double()
    return ((torch.log(power @ banks.double().t() + 1e-5) + 4.5) / 5).transpose(1, 2)


def time_edges(batch: int, n_mels: int) -> dict:
    """One record: ``mel_edges`` against ``_patch_edges`` on the inputs of
    ``time_k1``: the device time of each (``call_device_ms``: the kernel's
    event, the plain version's whole call) and the largest gaps over the
    edge frames, to each other and to ``edge_oracle``."""
    waves, _, cfg = inputs(torch.device("cuda"), batch)
    cfg = dataclasses.replace(cfg, n_mels=n_mels)
    banks = kaldi_mel_banks(n_mels, cfg.n_fft, cfg.sr, 0.0, 15000.0, device="cuda")
    n_frames = cfg.num_frames(waves.shape[1])
    left, right = edge_frames(n_frames, cfg.hopsize, cfg.n_fft, waves.shape[1] - 1)
    out = torch.zeros(batch, n_mels, n_frames, device="cuda")
    got = mel_kernel.mel_edges(out.clone(), waves, banks, cfg)[:, :, left + right].double()
    plain = mel_kernel._patch_edges(out.clone(), waves, banks, cfg)[:, :, left + right].double()
    oracle = edge_oracle(waves, banks, cfg)
    return {"edges": "mel_edges", "batch": batch, "n_mels": n_mels,
            "edge_frames": len(left + right),
            "ms": call_device_ms(lambda: mel_kernel.mel_edges(out, waves, banks, cfg))[
                "mel_edges"],
            "plain_device_ms": call_device_ms(
                lambda: mel_kernel._patch_edges(out, waves, banks, cfg))["total"],
            "vs_plain": float((got - plain).abs().max()),
            "vs_f64": float((got - oracle).abs().max()),
            "plain_vs_f64": float((plain - oracle).abs().max())}


def kernel_alone_ms(fn, calls: int = 5):
    """The device time of K1's kernels a call of ``fn``: the mean of their
    rows (``mel_kernel*``) in a profile of ``calls`` calls
    (``utils/profiling.device_rows``) times K1's launches a call; None where
    the profile kept no such row. The mean, since a profile can drop some
    of a call's device records."""
    before = mel_kernel.k1_launches()
    fn()
    launches = mel_kernel.k1_launches() - before
    ms = [t for name, t in device_rows(fn, calls=calls)[0] if "mel_kernel" in name]
    return statistics.mean(ms) * launches if ms else None


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
            if hasattr(mel_kernel, "mel_edges"):  # a checkout with the edge kernel
                print(json.dumps(time_edges(batch, n_mels)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
