"""Eval-mode BatchNorm and the chain behind it as one kernel
(``ops/batch_norm.py::batch_norm_eval``, ``csrc/batch_norm.cu::bn_eval``)
and how the models hand it their chains (``models/layers.py::norm_chain``).

On the CPU: the plain version, which the card tests take as the chain the
models ran before the kernel, equals that chain module by module, bit for
bit; each model passes each BatchNorm the chain its structure gives
(``mn10_as``: 31 with an activation, 5 without, 10 with the residual); the
wrapper refuses what the kernel does not take; ``bn.launch.eval`` stays 0;
a forward that autograd records gives ``nn.BatchNorm2d``'s values and
gradients; the launch plan covers every plane once and fills the card at
the serving cells' shapes. The ``cuda``-marked tests hold the kernel on
the card against float64, within twice the gap of cuDNN's and ATen's
chain, the four served models' logits against the unfused chain, the
launch counts of a predict and of a train step, single loads on a
misaligned plane, the same bits twice, and a recorded eval-mode forward
(``BatchNormEval``) and its backward against ``nn.BatchNorm2d``'s, alone
and through a model against the CPU:

    python -m pytest --noconftest -m cuda tests/test_torch_bn_eval.py
"""

from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn
from torch_threads import one_torch_thread  # noqa: F401

from efficientat_tpu_torch.models import layers
from efficientat_tpu_torch.models.dymn import DyMN, DyMNConfig
from efficientat_tpu_torch.models.registry import build_model
from efficientat_tpu_torch.ops import batch_norm as bn
from efficientat_tpu_torch.tools.time_bn import EVAL_CELLS, cell_calls, chain_inputs, eval_calls
from efficientat_tpu_torch.utils.profiling import counter, reset_counters

ROOT = Path(__file__).resolve().parents[1]
SMS = 132  # an H100 SXM's SMs
EPS = 1e-3
# each model's BatchNorm calls by chain (PERF.md section 3)
MN_KINDS = {"relu": 11, "hardswish": 20, "none": 5, "residual": 10}
DYMN_KINDS = {"relu": 5, "hardswish": 26, "dyrelu_ca": 15, "none": 5, "residual": 10}
MODEL_KINDS = {"mn10_as": MN_KINDS, "mn40_as_ext": MN_KINDS,
               "dymn10_as": DYMN_KINDS, "dymn20_as": DYMN_KINDS}
# the chains with their DyReLU-B pieces: M = 2 (upstream's) and 3 (the
# general form)
CHAINS = [(k, 2 if k.startswith("dyrelu") else 0) for k in bn.EPILOGUES] + [
    ("dyrelu", 3), ("dyrelu_ca", 3)]
CHAIN_IDS = [f"{k}-m{m}" for k, m in CHAINS]


@pytest.fixture(autouse=True)
def _skip_cuda_without_card(request):
    if request.node.get_closest_marker("cuda") and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ and has no CPU mode")


def _module_chain(x, params, act=None, residual=None, coef=None, gates=None):
    """The chain as the models ran it before the kernel, module by module:
    ``nn.BatchNorm2d`` in eval mode, ``nn.ReLU`` or ``nn.Hardswish``,
    DyReLU-B's and coordinate attention's bodies op by op, then ``out + x``."""
    c = x.shape[1]
    norm = nn.BatchNorm2d(c, eps=EPS).eval()
    with torch.no_grad():
        for t, p in zip((norm.weight, norm.bias, norm.running_mean, norm.running_var), params):
            t.copy_(p)
    y = norm(x)
    if act is not None:
        y = {"relu": nn.ReLU, "hardswish": nn.Hardswish}[act]()(y)
    if coef is not None:
        m = coef.shape[1] // (2 * c)
        theta = 2.0 * torch.sigmoid(coef) - 1.0
        theta = theta.reshape(-1, c, 1, 1, 2 * m)
        a = torch.cat([theta[..., :1] + 1.0, theta[..., 1:m]], dim=-1)
        b = 0.5 * theta[..., m:]
        if m == 2:
            y = torch.maximum(y * a[..., 0] + b[..., 0], y * a[..., 1] + b[..., 1])
        else:
            y = (y[..., None] * a + b).amax(dim=-1)
    if gates is not None:
        y = y * torch.sigmoid(gates[0]) * torch.sigmoid(gates[1])
    if residual is not None:
        y = y + residual
    return y


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind,m", CHAINS, ids=CHAIN_IDS)
def test_plain_version_is_module_chain(kind, m, dtype):
    x, params, chain = chain_inputs((3, 8, 6, 10), kind, m, dtype, device="cpu", seed=m + 1)
    assert bn.eval_epilogue(**chain) == kind
    with torch.no_grad():
        got = bn.batch_norm_eval_plain(x, *params, EPS, **chain)
        want = _module_chain(x, params, **chain)
    assert got.dtype == want.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("kind,m", CHAINS, ids=CHAIN_IDS)
def test_module_runs_the_chain_on_cpu(kind, m):
    """The port's BatchNorm2d and a plain nn.BatchNorm2d through
    ``norm_chain`` give the plain version's bits, in eval and in train mode."""
    x, params, chain = chain_inputs((2, 8, 5, 7), kind, m, torch.float32, device="cpu", seed=3)
    for cls in (layers.BatchNorm2d, nn.BatchNorm2d):
        norm = cls(8, eps=EPS)
        with torch.no_grad():
            for t, p in zip((norm.weight, norm.bias, norm.running_mean, norm.running_var),
                            params):
                t.copy_(p)
        for training in (False, True):
            norm.train(training)
            got = layers.norm_chain(norm, x, **chain)
            y = norm(x) if cls is nn.BatchNorm2d else nn.BatchNorm2d.forward(norm, x)
            torch.testing.assert_close(got, bn.epilogue(y, **chain), rtol=0, atol=0)


@pytest.mark.parametrize("name", list(MODEL_KINDS))
def test_each_batchnorm_gets_its_chain(name):
    calls = eval_calls(name, 1)
    assert Counter(kind for _, kind, _ in calls) == MODEL_KINDS[name]
    assert all(m == (2 if kind.startswith("dyrelu") else 0) for _, kind, m in calls)
    n_bn = sum(isinstance(m, layers.BatchNorm2d) for m in build_model(name).modules())
    assert len(calls) == n_bn


@pytest.mark.parametrize("cell,want", zip(EVAL_CELLS, (46, 61, 107)))
def test_cell_calls_are_each_members_batchnorms_in_turn(cell, want):
    names, batch = cell.split(":")
    calls = cell_calls(cell)
    assert len(calls) == want
    assert {shape[0] for shape, _, _ in calls} == {int(batch)}
    assert calls == [c for name in names.split("+") for c in eval_calls(name, int(batch))]


@pytest.mark.parametrize("kind,m", CHAINS, ids=CHAIN_IDS)
def test_module_records_the_chain_on_cpu(kind, m):
    """An eval-mode forward that autograd records: the port's BatchNorm2d
    through ``norm_chain`` gives ``nn.BatchNorm2d``'s values and
    gradients, bit for bit, for x, gamma, beta and the chain's operands."""
    x, params, chain = chain_inputs((2, 8, 5, 7), kind, m, torch.float32, device="cpu", seed=4)
    grads = []
    for cls in (layers.BatchNorm2d, nn.BatchNorm2d):
        norm = cls(8, eps=EPS).eval()
        with torch.no_grad():
            for t, p in zip((norm.weight, norm.bias, norm.running_mean, norm.running_var),
                            params):
                t.copy_(p)
        xs = x.clone().requires_grad_()
        ops = {k: v if v is None or k == "act" else (
            tuple(g.clone().requires_grad_() for g in v) if k == "gates"
            else v.clone().requires_grad_()) for k, v in chain.items()}
        y = layers.norm_chain(norm, xs, **ops)
        y.backward(torch.linspace(-1, 1, y.numel()).reshape(y.shape))
        tensors = [xs, norm.weight, norm.bias] + [
            t for k, v in ops.items() if k != "act" and v is not None
            for t in (v if k == "gates" else (v,))]
        grads.append([y.detach()] + [t.grad for t in tensors])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("option,chains,m", [
    ({"no_dyrelu": True}, {"relu_ca": 6, "hardswish_ca": 9}, 0),
    ({"no_ca": True}, {"dyrelu": 15}, 2),
    ({"no_dyrelu": True, "no_ca": True}, {"relu": 6, "hardswish": 9}, 0),
    ({"dyrelu_k": 3}, {"dyrelu_ca": 15}, 3),
])
def test_dymn_options_pick_their_chains(option, chains, m):
    """A DyMN without DyReLU-B takes its block's activation before the
    coordinate attention; without the attention, DyReLU-B alone. The 15
    depthwise BatchNorms change their chain; the other 46 keep theirs."""
    model = DyMN(DyMNConfig(width_mult=0.4, **option)).eval()
    calls = []
    hooks = [mod.register_forward_hook(
        lambda mod, args, kwargs, out: calls.append(
            (bn.eval_epilogue(**kwargs), args[0].shape[1], kwargs.get("coef"))),
        with_kwargs=True)
        for mod in model.modules() if isinstance(mod, layers.BatchNorm2d)]
    with torch.no_grad():
        model(torch.randn(1, 1, 128, 64))
    for h in hooks:
        h.remove()
    want = Counter({k: v for k, v in DYMN_KINDS.items() if k != "dyrelu_ca"}) + Counter(chains)
    assert Counter(kind for kind, _, _ in calls) == want
    pieces = {coef.shape[-1] // (2 * c) for _, c, coef in calls if coef is not None}
    assert pieces == ({m} if m else set())


def _bad_eval_args():
    x, params, _ = chain_inputs((2, 4, 6, 8), "none", 0, torch.float32, device="cpu", seed=2)
    w, b, rm, rv = params
    gates = (torch.zeros(2, 4, 6, 1), torch.zeros(2, 4, 1, 8))
    coef = torch.zeros(2, 16)
    layout, operand = "contiguous NCHW", "batch_norm_eval's"
    return {
        "not_contiguous": ((x.transpose(2, 3), *params), {}, ValueError, layout),
        "channels_last": ((x.to(memory_format=torch.channels_last), *params), {}, ValueError,
                          layout),
        "fp16": ((x.half(), *params), {}, TypeError, "float32 or bfloat16"),
        "fp64": ((x.double(), *params), {}, TypeError, "float32 or bfloat16"),
        "three_dims": ((x[0], *params), {}, ValueError, layout),
        "empty": ((x[:0], *params), {}, ValueError, "planes"),
        "bf16_gamma": ((x, w.bfloat16(), b, rm, rv), {}, ValueError,
                       "running statistics are contiguous"),
        "no_running_stats": ((x, w, b, None, None), {}, ValueError, "track_running_stats"),
        "act_name": ((x, *params), {"act": "gelu"}, ValueError, "activations"),
        "residual_after_act": ((x, *params), {"act": "relu", "residual": x}, ValueError,
                               "residual"),
        "dyrelu_and_act": ((x, *params), {"act": "relu", "coef": coef}, ValueError,
                           "act or coef"),
        "gates_alone": ((x, *params), {"gates": gates}, ValueError, "coordinate attention"),
        "residual_shape": ((x, *params), {"residual": x[:1]}, ValueError, operand),
        "residual_dtype": ((x, *params), {"residual": x.bfloat16()}, ValueError, operand),
        "coef_rows": ((x, *params), {"coef": coef[:1]}, ValueError, operand),
        "coef_five_pieces": ((x, *params), {"coef": torch.zeros(2, 40)}, ValueError,
                             "1 to 4 pieces"),
        "gate_shape": ((x, *params), {"act": "relu", "gates": (gates[1], gates[0])},
                       ValueError, operand),
        "gate_not_contiguous": ((x, *params), {"act": "relu", "gates": (
            torch.zeros(2, 4, 12, 1)[:, :, ::2], gates[1])}, ValueError, operand),
        "cpu_input": ((x, *params), {"act": "relu"}, ValueError, "CUDA tensor"),
    }


@pytest.mark.parametrize("case", list(_bad_eval_args()))
def test_eval_wrapper_refuses(case):
    args, chain, error, match = _bad_eval_args()[case]
    with pytest.raises(error, match=match):
        bn.batch_norm_eval(*args, eps=EPS, **chain)


def test_eval_launches_stay_zero_on_cpu():
    reset_counters("bn.")
    for name, args in (("mn04_as", ()), ("dymn04_as", (1.0,))):
        model = build_model(name).eval()
        with torch.inference_mode():
            model(torch.randn(2, 1, 128, 64), *args)
        model.train()
        model(torch.randn(2, 1, 128, 64), *args)[0].sum().backward()
    assert counter("bn.launch.eval") == 0


def _planes_covered(shape, launch):
    """How often the kernel, as csrc/batch_norm.cu indexes it, writes each
    value of an (N, C, H, W) input: block k takes planes k planes ..
    min(N C, (k + 1) planes) - 1, its groups of vec values in order."""
    n, c, h, w = shape
    seen = np.zeros(n * c * h * w, dtype=np.int64)
    for k in range(launch.blocks):
        p0 = k * launch.planes
        np_ = min(launch.planes, n * c - p0)
        groups = np.arange(np_ * h * w // launch.vec)
        for i in range(launch.vec):
            np.add.at(seen, p0 * h * w + groups * launch.vec + i, 1)
    return seen


@pytest.mark.parametrize("shape", [(2, 16, 64, 500), (32, 960, 4, 32), (7, 5, 7, 9),
                                   (3, 32, 141, 1), (300, 3, 2, 2), (1, 1, 1, 1)])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_eval_plan_writes_every_value_once(shape, itemsize):
    for aligned in (True, False):
        for gates in (False, True):
            launch = bn.eval_plan(shape, itemsize, SMS, aligned, gates)
            assert 1 <= launch.planes <= bn.MAX_PLANES
            assert (shape[2] * shape[3]) % launch.vec == 0
            assert (_planes_covered(shape, launch) == 1).all(), launch
            if gates:
                assert 4 * launch.planes * (shape[2] + shape[3]) <= bn.GATE_BYTES


@pytest.mark.parametrize("cell", EVAL_CELLS)
def test_eval_plan_fills_the_card_at_the_cells(cell):
    """At every BatchNorm call of the serving cells the grid holds at least
    one block an SM, each block within a plane or ``EVAL_BLOCK_VALUES``
    values, and loads 16 bytes at a time where H x W allows."""
    for shape, kind, _ in set(cell_calls(cell)):
        for itemsize in (4, 2):
            launch = bn.eval_plan(shape, itemsize, SMS, True, kind.endswith("_ca"))
            hw = shape[2] * shape[3]
            assert launch.blocks >= SMS, (shape, launch)
            assert launch.planes == 1 or launch.planes * hw <= bn.EVAL_BLOCK_VALUES
            assert launch.vec == (16 // itemsize if hw % (16 // itemsize) == 0 else 1)


def test_eval_plan_refuses_gates_past_shared_memory():
    with pytest.raises(ValueError, match="gates"):
        bn.eval_plan((1, 1, 6000, 7000), 4, SMS, True, True)


def test_eval_bound_bytes_counts_x_twice_and_the_residual():
    assert bn.eval_bound_bytes((256, 16, 64, 500), 4) == 2 * 256 * 16 * 32000 * 4
    assert bn.eval_bound_bytes((32, 64, 64, 500), 2, residual=True) == 3 * 32 * 64 * 32000 * 2


# ------------------------------------------------------------------ card


def _gap(got, want):
    want = want.double()
    return float((got.double() - want).abs().max() / want.abs().max().clamp_min(1e-30))


# the serving cells' largest and smallest planes, and a ContextGen plane of
# odd length (single loads)
CARD_SHAPES = [(8, 16, 64, 500), (32, 960, 4, 32)]
CARD_CASES = [(s, k, m, d) for s in CARD_SHAPES for k, m in CHAINS
              for d in (torch.float32, torch.bfloat16)] + [
    ((16, 32, 141, 1), "hardswish", 0, torch.float32)]
# a gap of zero cannot be halved: the floor is one fp32 rounding
ULP32 = 2.0 ** -23


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kind,m,dtype", CARD_CASES, ids=[
    f"{'x'.join(map(str, s))}-{k}-m{m}-{str(d)[6:]}" for s, k, m, d in CARD_CASES])
def test_eval_kernel_matches_float64_within_twice_the_chain(shape, kind, m, dtype):
    x, params, chain = chain_inputs(shape, kind, m, dtype, seed=sum(shape))
    with torch.inference_mode():
        port = bn.batch_norm_eval(x, *params, EPS, **chain)
        lib = bn.batch_norm_eval_plain(x, *params, EPS, **chain)
        f64 = {k: v if not torch.is_tensor(v) else v.double() for k, v in chain.items()}
        if "gates" in chain:
            f64["gates"] = tuple(g.double() for g in chain["gates"])
        want = bn.batch_norm_eval_plain(x.double(), *(p.double() for p in params), EPS, **f64)
    torch.cuda.synchronize()
    p, c = _gap(port, want), _gap(lib, want)
    print(shape, kind, m, dtype, f"port {p:.3g} chain {c:.3g}")
    assert port.dtype == lib.dtype and port.shape == lib.shape
    assert p <= max(2 * c, ULP32), (p, c)


def _members(cell, seed):
    """(model, forward arguments) of each member of ``cell`` on the card,
    with the benchmark's seeded weights."""
    from efficientat_tpu_torch.infer.tag import _serving_args
    from portbench import gen, spec
    from portbench.mixes.serve_ensemble import member_weights

    bench = spec.Bench(ROOT)
    names, _ = cell.split(":")
    if "+" in names:
        cfg = bench.config("ens2_" + names.replace("+", "_"))
        states = member_weights(cfg, seed, "cuda")
    else:
        states = [gen.weights(bench.config(names), seed, "cuda")]
    members = []
    for name, state in zip(names.split("+"), states):
        model = build_model(name).cuda().eval()
        model.load_state_dict(state)
        members.append((model, _serving_args(model)))
    return members


# fused against unfused logits in fp32 with TF32 off: the same function in
# another order of fp32 roundings through 17 layers
TOL_LOGITS = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("cell", EVAL_CELLS)
def test_models_fused_against_unfused(cell, monkeypatch):
    from efficientat_tpu_torch.ops.mel_kernel import log_mel_spectrogram_fused
    from efficientat_tpu_torch.ops.melspec import MelConfig

    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        batch = int(cell.split(":")[1])
        gen = torch.Generator(device="cuda").manual_seed(batch)
        wave = torch.randn(batch, 320000, device="cuda", generator=gen) * 0.05
        with torch.inference_mode():
            mel = log_mel_spectrogram_fused(wave, MelConfig())[:, None]
            del wave
            for model, args in _members(cell, seed=2 ** 31 + batch):
                expect = sum(1 for m in model.modules() if isinstance(m, layers.BatchNorm2d))
                reset_counters("bn.")
                fused = model(mel, *args)[0]
                assert counter("bn.launch.eval") == expect
                with monkeypatch.context() as mp:
                    mp.setattr(bn, "eval_kernel", bn.batch_norm_eval_plain)
                    plain = model(mel, *args)[0]
                gap = _gap(fused, plain)
                print(cell, type(model).__name__, f"logits gap {gap:.3g}")
                assert torch.isfinite(fused).all()
                assert gap <= TOL_LOGITS, gap
                del model
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.cuda
def test_predict_counts_a_launch_a_batchnorm_and_a_train_step_none():
    from efficientat_tpu_torch.infer.tag import Tagger
    from test_torch_batch_norm import _step

    waves = np.random.default_rng(0).standard_normal((2, 32000)).astype(np.float32) * 0.1
    for names, want in ((["mn10_as"], 46), (["dymn10_as"], 61),
                        (["mn40_as_ext", "dymn20_as"], 107)):
        tagger = Tagger(names, pretrained=False, device="cuda")
        reset_counters("bn.")
        tagger.predict(waves)
        assert counter("bn.launch.eval") == want, names
        assert (counter("bn.launch.forward"), counter("bn.launch.backward")) == (0, 0)
    _, fwd, bwd = _step("mn10_as", use_port=True)
    assert (fwd, bwd, counter("bn.launch.eval")) == (46, 46, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["residual", "dyrelu_ca"])
def test_misaligned_plane_takes_single_loads(kind):
    shape = (4, 24, 32, 40)
    x, params, chain = chain_inputs(shape, kind, 2, torch.float32, seed=6)
    buf = torch.empty(x.numel() + 1, device="cuda")
    xs = buf[1:].view(shape)
    xs.copy_(x)
    assert xs.is_contiguous() and xs.data_ptr() % 16
    assert bn.eval_plan(shape, 4, SMS, False, kind == "dyrelu_ca").vec == 1
    with torch.inference_mode():
        got = bn.batch_norm_eval(xs, *params, EPS, **chain)
        want = bn.batch_norm_eval(x, *params, EPS, **chain)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kind,dtype", [((16, 16, 64, 500), "dyrelu_ca", torch.float32),
                                              ((32, 960, 4, 32), "hardswish", torch.bfloat16),
                                              ((64, 112, 8, 63), "residual", torch.float32)])
def test_eval_kernel_gives_the_same_bits_twice(shape, kind, dtype):
    x, params, chain = chain_inputs(shape, kind, 2, dtype, seed=5)
    with torch.inference_mode():
        first = bn.batch_norm_eval(x, *params, EPS, **chain)
        second = bn.batch_norm_eval(x, *params, EPS, **chain)
    assert torch.equal(first, second)


# a recorded eval-mode forward and its backward: dgamma and dbeta are fp32
# sums of up to 2**21 values, merged in fp64; a gap of zero cannot be
# halved, so their floor is a few fp32 roundings
SUMS_FLOOR = 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(8, 16, 64, 500), (32, 960, 4, 32), (4, 24, 33, 41)])
def test_recorded_eval_forward_runs_the_kernels_and_their_backward(shape, dtype):
    """``BatchNormEval`` under a hardswish chain: one eval launch and one
    backward launch; y, dx, dgamma and dbeta against float64, each within
    twice the gap of nn.BatchNorm2d's on the card (cuDNN, or ATen for a
    bf16 x with fp32 gamma)."""
    x, params, _ = chain_inputs(shape, "none", 0, dtype, seed=sum(shape))
    dy = torch.randn(shape, device="cuda", generator=torch.Generator(device="cuda")
                     .manual_seed(1)).to(dtype)
    out = []
    for cls, wide in ((layers.BatchNorm2d, False), (nn.BatchNorm2d, False),
                      (nn.BatchNorm2d, True)):
        norm = cls(shape[1], eps=EPS).cuda().eval()
        with torch.no_grad():
            for t, p in zip((norm.weight, norm.bias, norm.running_mean, norm.running_var),
                            params):
                t.copy_(p)
        if wide:
            norm.double()
        xs = (x.double() if wide else x.clone()).requires_grad_()
        reset_counters("bn.")
        y = layers.norm_chain(norm, xs, act="hardswish")
        y.backward(dy.double() if wide else dy)
        torch.cuda.synchronize()
        out.append(((y.detach(), xs.grad, norm.weight.grad, norm.bias.grad),
                    [counter("bn.launch.eval"), counter("bn.launch.backward")]))
    (port, port_launches), (lib, lib_launches), (f64, _) = out
    assert port_launches == [1, 1] and lib_launches == [0, 0]
    assert port[0].dtype == port[1].dtype == dtype
    assert port[2].dtype == port[3].dtype == torch.float32
    for name, p, c, w, floor in zip(("y", "dx", "dgamma", "dbeta"), port, lib, f64,
                                    (ULP32, ULP32, SUMS_FLOOR, SUMS_FLOOR)):
        gp, gc = _gap(p, w), _gap(c, w)
        print(shape, dtype, name, f"port {gp:.3g} library {gc:.3g}")
        assert gp <= max(2 * gc, floor), (name, gp, gc)


# eval-mode gradients of a model, card against CPU in fp32 with TF32 off
# (chip_smoke.py's TOL_GRAD_L2 and TOL_GRAD_TENSOR: fp32 convs summed in
# another order, and rounding moves an activation across a kink now and
# then; a wrong gradient gives gaps of order 1)
TOL_GRAD_L2, TOL_GRAD_TENSOR = 1e-2, 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mn04_as", "dymn04_as"])
def test_eval_mode_gradients_match_the_cpu(name):
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        from test_torch_batch_norm import _seeded_state

        cpu = build_model(name).eval()
        cpu.load_state_dict(_seeded_state(cpu, 0))
        card = build_model(name).eval()
        card.load_state_dict(cpu.state_dict())
        card.cuda()
        gen = torch.Generator().manual_seed(3)
        mel = torch.randn(2, 1, 128, 100, generator=gen)
        args = (1.0,) if name.startswith("dymn") else ()
        grads = []
        for model, device in ((card, "cuda"), (cpu, "cpu")):
            reset_counters("bn.")
            logits = model(mel.to(device), *args)[0]
            assert torch.isfinite(logits).all()
            r = torch.linspace(-1, 1, logits.numel()).reshape(logits.shape).to(device)
            (logits * r).sum().backward()
            grads.append({n: p.grad.double().cpu() for n, p in model.named_parameters()})
            if device == "cuda":
                n_bn = sum(isinstance(mod, nn.BatchNorm2d) for mod in model.modules())
                assert [counter("bn.launch.eval"), counter("bn.launch.backward")] == [n_bn] * 2
        got, want = grads
        l2 = (sum(float(((got[n] - w) ** 2).sum()) for n, w in want.items())
              / sum(float((w ** 2).sum()) for w in want.values())) ** 0.5
        floor = 1e-4 * max(float(w.norm()) for w in want.values())
        worst = max(float((got[n] - w).norm()) / (float(w.norm()) + floor)
                    for n, w in want.items())
        print(name, l2, worst)
        assert l2 <= TOL_GRAD_L2 and worst <= TOL_GRAD_TENSOR, (l2, worst)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old
