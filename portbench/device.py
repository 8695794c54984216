"""What the benchmark reads of the card: the profiler's device rows over a
few calls, CUDA-event timings, the default generator's state, and the
card's name, power limit and versions."""

from __future__ import annotations

import bisect
import collections
import subprocess
import time

import torch

# kernels of the profiler's warm-up step: in a process profiled before, the
# device's first records after the profiler starts can go missing, and the
# primer's take their place (a copy of efficientat_tpu_torch's
# utils/profiling.py PRIMER_KERNELS)
PRIMER_KERNELS = 64


def merge(rows):
    """Union of (start, end) intervals, sorted by start: merged list."""
    out = []
    for start, end in sorted(rows):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def profile_calls(fn, calls: int, device) -> dict:
    """Run ``fn`` ``calls`` times under ``torch.profiler`` after a primer
    step whose records are dropped. Returns the device rows (kernels,
    copies, memsets: start and end in µs, name), the host's op rows, the
    host-clock span of the calls (``window_s``) and the union of the device
    rows (``busy_s``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        if cuda:
            primer = torch.zeros(1, device=device)
            for _ in range(PRIMER_KERNELS):
                primer.fill_(0.0)
            torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    rows, host = [], []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False) or e.name.startswith("ProfilerStep"):
            continue  # the profiler's own step range, on both timelines
        item = (e.time_range.start, e.time_range.end, e.name)
        (rows if e.device_type == DeviceType.CUDA else host).append(item)
    busy_us = sum(end - start for start, end in merge([r[:2] for r in rows]))
    return {"rows": rows, "host": host, "calls": calls, "window_s": window_s,
            "busy_s": busy_us / 1e6}


def breakdown(prof: dict, top: int = 10) -> dict:
    """The device ops that took most time, and the idle gaps between device
    rows summed by the innermost host op running at each gap's middle
    ("host, no torch op" where none was: Python or numpy, such as the copy
    into a pinned buffer), seconds each, ``top`` of each."""
    ops = collections.Counter()
    for start, end, name in prof["rows"]:
        ops[name[:96]] += (end - start) / 1e6
    busy = merge([r[:2] for r in prof["rows"]])
    mids = [(a + b) / 2 for (_, a), (b, _) in zip(busy, busy[1:])]
    innermost = [(float("inf"), "host, no torch op")] * len(mids)
    for start, end, name in prof["host"]:
        for i in range(bisect.bisect_left(mids, start), bisect.bisect_right(mids, end)):
            innermost[i] = min(innermost[i], (end - start, name[:96]))
    gaps = collections.Counter()
    for ((_, a), (b, _)), (_, name) in zip(zip(busy, busy[1:]), innermost):
        gaps[name] += (b - a) / 1e6
    return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
            "idle_gaps": [[k, v] for k, v in gaps.most_common(top)]}


def event_seconds(fn, calls: int, warmup: int = 2):
    """Seconds a call of ``fn`` takes on the card: CUDA events around
    ``calls`` back-to-back calls after ``warmup`` calls; None without a card."""
    if not torch.cuda.is_available():
        return None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / calls


def no_tf32() -> None:
    """Every float32 GEMM and conv in IEEE float32, as the configurations
    state (PyTorch lets cuDNN use TF32 by default)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def seed_rng(device, seed: int) -> None:
    """Seed the default generator of ``device`` (dropout draws from it)."""
    if torch.device(device).type == "cuda":
        torch.cuda.manual_seed(seed)
    else:
        torch.manual_seed(seed)


def rng_state(device) -> torch.Tensor:
    if torch.device(device).type == "cuda":
        return torch.cuda.get_rng_state(device)
    return torch.get_rng_state()


def set_rng_state(device, state: torch.Tensor) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.set_rng_state(state, device)
    else:
        torch.set_rng_state(state)


def card(device, count: int, peak: int) -> dict:
    """The contract's ``device`` fields (``peak``: the allocator's peak
    bytes, read when the window closed), with the card's power limit and
    the versions of torch and CUDA beside them."""
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": peak}
    query = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=30)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": peak,
            "power_limit_w": query.stdout.strip() or None,
            "torch": torch.__version__, "cuda": torch.version.cuda}
