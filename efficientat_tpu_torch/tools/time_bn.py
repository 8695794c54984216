"""Time the BatchNorm kernels on the card at a model's shapes.

    python -m efficientat_tpu_torch.tools.time_bn [--model_name mn10_as]
        [--batch 120] [--dtype float32 bfloat16] [--iters 20]
    python -m efficientat_tpu_torch.tools.time_bn --trace_step [--batch 120]
    python -m efficientat_tpu_torch.tools.time_bn --eval [--dtype float32] [--iters 20]

The shapes are every BatchNorm input of ``--model_name`` on ``--batch``
10 s clips (128 mels, 1000 frames), in the model's order. For each shape
and dtype, one JSON line: the layers of that shape, the launch plan
(``ops/batch_norm.py::plan``), and for the forward and the backward the
kernels' device time a call (``kernel_ms``, ``torch.profiler``'s rows),
the byte bound at 3.35 TB/s (``bound_ms``: 3 and 5 passes over the input)
and the kernels' share of it, the plain version's time (``plain_ms``:
ATen's own CUDA kernels, ``native_batch_norm`` and its backward) and the
library's (``library_ms``: the kernels ``F.batch_norm`` picks in training,
which the port never calls: cuDNN's for fp32, ATen's for a bf16 input with
fp32 gamma, which cuDNN refuses). Then the sums over the model's layers,
and last the card's name and power limit as ``nvidia-smi`` gives them.

``--eval`` times the eval-mode kernel (``ops/batch_norm.py::eval_kernel``)
at each BatchNorm call of each serving cell (``EVAL_CELLS``: members
joined by ``+``, then ``:`` and the batch), by its shape and chain
(``cell_calls``): one JSON line each with the calls of that shape and
chain, the plan (``eval_plan``), the kernel's device time a call with the
L2 flushed before each call, the byte bound (x read and written, the
residual read: ``eval_bound_bytes``) and the kernel's share of it, and
``library_ms``: the chain as the port ran it before the kernel and no
longer does, eval-mode ``F.batch_norm`` (cuDNN's ``bn_fw_inf``) and
ATen's elementwise ops (``batch_norm_eval_plain``), from the same flushed
L2. Then each cell's sums.

``--trace_step`` profiles one ``train_step`` of ``--model_name`` (fp32 with TF32
off, K1's DFT bf16x3, after two warm-up steps) and prints each
BatchNorm kernel of the step in launch order with its device time, grid and
block, one JSON line a kernel, then their sums by kernel name. It needs only
``train_step`` and ``utils/profiling.trace``, so a copy of this file runs it
in a checkout that predates the port's kernels (cuDNN's BatchNorm).
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import tempfile

import numpy as np
import torch
from torch import nn

from efficientat_tpu_torch.models.registry import build_model
from efficientat_tpu_torch.utils.profiling import device_rows, trace

MOMENTUM, EPS = 0.01, 1e-3
CLIP_FRAMES, N_MELS = 1000, 128
BN_KERNELS = ("bn_", "batch_norm", "batchnorm")
# the serving cells' members and batch
EVAL_CELLS = ("mn10_as:64", "dymn10_as:256", "mn40_as_ext+dymn20_as:32")
# what a flush writes before each timed eval call: five times an H100's
# 50 MB L2
L2_FLUSH_BYTES = 256 << 20


def layer_shapes(name: str, batch: int, device: str = "cuda") -> list:
    """(N, C, H, W) of each BatchNorm input of ``name`` at ``batch`` clips,
    in the model's order (one eval-mode forward of one clip on ``device``)."""
    return [shape for shape, _, _ in eval_calls(name, batch, device)]


def eval_calls(name: str, batch: int, device: str = "cpu") -> list:
    """(shape (N, C, H, W), chain, M) of each BatchNorm call of ``name`` in
    an eval-mode forward of ``batch`` clips, in the model's order: the
    chain's name (``ops/batch_norm.py::eval_epilogue``) from the keywords
    the model passes its ``BatchNorm2d``, M DyReLU-B's pieces (0 without).
    One forward of one clip on ``device``."""
    from efficientat_tpu_torch.ops.batch_norm import eval_epilogue

    model = build_model(name).to(device).eval()
    calls = []

    def hook(module, args, kwargs, out):
        x, coef = args[0], kwargs.get("coef")
        calls.append(((batch,) + tuple(x.shape[1:]), eval_epilogue(**kwargs),
                      0 if coef is None else coef.shape[-1] // (2 * x.shape[1])))

    hooks = [m.register_forward_hook(hook, with_kwargs=True) for m in model.modules()
             if isinstance(m, nn.BatchNorm2d)]
    with torch.no_grad():
        model(torch.zeros(1, 1, N_MELS, CLIP_FRAMES, device=device))
    for h in hooks:
        h.remove()
    return calls


def cell_calls(cell: str) -> list:
    """``eval_calls`` of each member of ``cell`` ("a+b:batch"), in turn."""
    names, batch = cell.split(":")
    return [c for name in names.split("+") for c in eval_calls(name, int(batch))]


def chain_inputs(shape, kind: str, m: int, dtype, device: str = "cuda", seed: int = 0):
    """Seeded inputs of an eval-mode BatchNorm call with chain ``kind``: x
    (with an offset and a spread), gamma, beta, the running mean and
    variance, and the chain's keywords (``act``, ``residual``, ``coef``
    with ``m`` pieces, ``gates``), the operands in x's dtype."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n, c, h, w = shape

    def draw(*size, scale=1.0):
        return (torch.randn(size, device=device, generator=gen) * scale).to(dtype)

    x = (torch.randn(shape, device=device, generator=gen) * 2 + 0.5).to(dtype)
    params = (torch.rand(c, device=device, generator=gen) + 0.5,
              torch.randn(c, device=device, generator=gen),
              torch.randn(c, device=device, generator=gen) * 0.5,
              torch.rand(c, device=device, generator=gen) + 0.5)
    act = next((a for a in ("relu", "hardswish") if kind.startswith(a)), None)
    chain = {"act": act}
    if kind == "residual":
        chain["residual"] = draw(*shape)
    if kind.startswith("dyrelu"):
        chain["coef"] = draw(n, 2 * m * c)
    if kind.endswith("_ca"):
        chain["gates"] = (draw(n, c, h, 1, scale=2.0), draw(n, c, 1, w, scale=2.0))
    return x, params, chain


def time_eval_call(shape, kind: str, m: int, dtype, iters: int) -> dict:
    """One record: the eval kernel and the chain it replaced at ``shape``."""
    from efficientat_tpu_torch.ops import batch_norm as bn

    x, params, chain = chain_inputs(shape, kind, m, dtype)
    itemsize = x.element_size()
    launch = bn.eval_plan(tuple(shape), itemsize,
                          torch.cuda.get_device_properties(x.device).multi_processor_count,
                          True, "gates" in chain)
    ms = cold_device_ms(lambda: bn.eval_kernel(x, *params, EPS, **chain), iters)
    bound = bn.eval_bound_bytes(shape, itemsize, kind == "residual") / bn.HBM_BYTES_PER_S * 1e3
    return {"shape": list(shape), "chain": kind, "m": m,
            "dtype": str(dtype).replace("torch.", ""),
            "plan": {"vec": launch.vec, "planes": launch.planes, "blocks": launch.blocks},
            "kernel_ms": ms, "bound_ms": bound, "share_pct": 100 * bound / ms,
            "library_ms": cold_device_ms(
                lambda: bn.batch_norm_eval_plain(x, *params, EPS, **chain), iters)}


def time_eval(cells, dtypes, iters: int) -> None:
    for cell in cells:
        calls = cell_calls(cell)
        counts = collections.Counter(calls)
        for dtype in dtypes:
            sums = collections.defaultdict(float)
            for call in counts:
                rec = time_eval_call(*call, dtype, iters)
                rec["calls"] = counts[call]
                print(json.dumps(rec), flush=True)
                for k in ("kernel_ms", "bound_ms", "library_ms"):
                    sums[k] += counts[call] * rec[k]
                torch.cuda.empty_cache()
            print(json.dumps({"cell": cell, "calls": len(calls),
                              "dtype": str(dtype).replace("torch.", ""), "sums_ms": dict(sums),
                              "share_pct": 100 * sums["bound_ms"] / sums["kernel_ms"]}),
                  flush=True)


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """The device time of one call of ``fn``: its kernels' and memsets'
    durations in ``torch.profiler``, summed over ``iters`` calls back to
    back, over ``iters`` (``utils/profiling.device_rows``). (CUDA events
    around one call would add the host's enqueue to the small layers'
    microseconds.)"""
    rows = device_rows(fn, calls=iters, warmup=warmup)[0]
    return sum(ms for _, ms in rows) / iters


def cold_device_ms(fn, iters: int, warmup: int = 3, tries: int = 6) -> float:
    """``device_ms`` of ``fn`` with the L2 flushed before each call: a
    ``bitwise_not`` over ``L2_FLUSH_BYTES``, whose rows are left out (the
    timed calls launch no such kernel). A long process's profiles can drop
    a row now and then (one flush of five, on an H100 with torch 2.11), and
    ATen picks a kernel by each allocation's alignment, so a call's kernel
    names can vary: the time is the mean of the first two profiles that
    hold every flush and the most rows of any profile taken."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def call():
        flush.bitwise_not_()
        fn()

    profiles = []  # (rows, ms a call) of each profile that holds every flush
    for _ in range(tries):
        rows = device_rows(call, calls=iters, warmup=warmup)[0]
        kept = [ms for name, ms in rows if "bitwise_not" not in name]
        if len(rows) - len(kept) == iters:
            profiles.append((len(kept), sum(kept) / iters))
        most = max((n for n, _ in profiles), default=0)
        whole = [ms for n, ms in profiles if n == most]
        if len(whole) >= 2:
            return (whole[0] + whole[1]) / 2
    raise RuntimeError(f"{tries} profiles of {iters} calls gave fewer than two whole ones")


def shape_inputs(shape, dtype, seed: int = 0):
    """Seeded CUDA inputs of a layer: x, dy, gamma, beta, running mean and
    variance (x with an offset and a spread)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
    dy = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    w = torch.rand(c, device="cuda", generator=gen) + 0.5
    b = torch.randn(c, device="cuda", generator=gen)
    return x, dy, w, b, torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")


def time_shape(shape, dtype, iters: int) -> dict:
    """One record: the kernels, the plain version and the library at ``shape``."""
    from efficientat_tpu_torch.ops import batch_norm as bn

    x, dy, w, b, rm, rv = shape_inputs(shape, dtype)
    itemsize = x.element_size()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    launch = bn.plan(shape, itemsize, sms)
    _, stats = bn.forward_kernels(x, w, b, rm, rv, MOMENTUM, EPS)
    kernels = {
        "forward": lambda: bn.forward_kernels(x, w, b, rm, rv, MOMENTUM, EPS),
        "backward": lambda: bn.backward_kernels(x, dy, w, stats),
    }
    _, smean, sinv = torch.ops.aten.native_batch_norm(x, w, b, rm, rv, True, MOMENTUM, EPS)
    _, lmean, lvar, reserve = torch.ops.aten._batch_norm_with_update(x, w, b, rm, rv,
                                                                     MOMENTUM, EPS)
    plain = {
        "forward": lambda: torch.ops.aten.native_batch_norm(x, w, b, rm, rv, True,
                                                            MOMENTUM, EPS),
        "backward": lambda: torch.ops.aten.native_batch_norm_backward(
            dy, x, w, rm, rv, smean, sinv, True, EPS, [True, True, True]),
    }
    library = {
        "forward": lambda: torch.ops.aten._batch_norm_with_update(x, w, b, rm, rv,
                                                                  MOMENTUM, EPS),
        "backward": lambda: torch.ops.aten.batch_norm_backward(
            dy, x, w, rm, rv, lmean, lvar, True, EPS, [True, True, True], reserve),
    }
    rec = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
           "plan": {"vec": launch.vec, "chunks": launch.chunks,
                    "blocks": shape[1] * launch.chunks}}
    for d in ("forward", "backward"):
        ms = device_ms(kernels[d], iters)
        bound = bn.bound_bytes(shape, itemsize, d) / bn.HBM_BYTES_PER_S * 1e3
        rec[d] = {"kernel_ms": ms, "bound_ms": bound, "share_pct": 100 * bound / ms,
                  "plain_ms": device_ms(plain[d], iters),
                  "library_ms": device_ms(library[d], iters)}
    return rec


def time_model(name: str, batch: int, dtypes, iters: int) -> None:
    shapes = layer_shapes(name, batch)
    counts = collections.Counter(shapes)
    for dtype in dtypes:
        sums = collections.defaultdict(float)
        for shape in dict.fromkeys(shapes):
            rec = time_shape(shape, dtype, iters)
            rec["layers"] = counts[shape]
            print(json.dumps(rec), flush=True)
            for d in ("forward", "backward"):
                for k in ("kernel_ms", "bound_ms", "plain_ms", "library_ms"):
                    sums[f"{d}_{k}"] += counts[shape] * rec[d][k]
        print(json.dumps({"model": name, "batch": batch, "layers": len(shapes),
                          "dtype": str(dtype).replace("torch.", ""),
                          "sums_ms": dict(sums)}), flush=True)


def trace_step(name: str, batch: int) -> None:
    """One profiled ``train_step``: its BatchNorm kernels in launch order."""
    from efficientat_tpu_torch.ops.melspec import MelConfig
    from efficientat_tpu_torch.train.loop import LossConfig, StepRandom, make_optimizer, train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    model = build_model(name).cuda()
    mel_cfg = MelConfig(freqm=0, timem=0)
    loss_cfg = LossConfig(kind="bce", mixup_alpha=0.3)
    samples = 10 * mel_cfg.sr
    rng = np.random.default_rng(0)
    wave = torch.from_numpy((rng.standard_normal((batch, samples)) * 0.1)
                            .astype(np.float32)).cuda()
    target = torch.from_numpy((rng.random((batch, 527)) < 0.05).astype(np.float32)).cuda()
    opt = make_optimizer(model.parameters(), 1e-4)
    draws = StepRandom(0)

    def step():
        train_step(model, opt, None, mel_cfg, loss_cfg, {"wave": wave, "target": target},
                   draws.draw(mel_cfg, loss_cfg, batch, samples), dft_precision="bf16x3")

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp) as path:
            step()
            torch.cuda.synchronize()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    rows = sorted((e for e in events if e.get("cat") == "kernel"
                   and any(k in e["name"].lower() for k in BN_KERNELS)),
                  key=lambda e: e["ts"])
    sums = collections.defaultdict(lambda: [0, 0.0])
    for e in rows:
        args = e.get("args", {})
        print(json.dumps({"kernel": e["name"][:120], "ms": e["dur"] / 1e3,
                          "grid": args.get("grid"), "block": args.get("block")}), flush=True)
        sums[e["name"][:120]][0] += 1
        sums[e["name"][:120]][1] += e["dur"] / 1e3
    print(json.dumps({"model": name, "batch": batch, "bn_kernels": len(rows),
                      "bn_ms": sum(v[1] for v in sums.values()),
                      "by_kernel": {k: {"launches": n, "ms": ms}
                                    for k, (n, ms) in sums.items()}}), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model_name", default="mn10_as")
    p.add_argument("--batch", type=int, default=120)
    p.add_argument("--dtype", nargs="+", choices=("float32", "bfloat16"), default=["float32"])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--trace_step", action="store_true")
    p.add_argument("--eval", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_bn needs a CUDA device; none is visible")
    if args.trace_step:
        trace_step(args.model_name, args.batch)
    elif args.eval:
        time_eval(EVAL_CELLS, [getattr(torch, d) for d in args.dtype], args.iters)
    else:
        time_model(args.model_name, args.batch,
                   [getattr(torch, d) for d in args.dtype], args.iters)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
