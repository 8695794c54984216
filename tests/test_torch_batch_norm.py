"""Training-mode BatchNorm on the port's kernels (``ops/batch_norm.py``,
``csrc/batch_norm.cu``) and the module that calls them
(``models/layers.py::BatchNorm2d``).

On the CPU the module is ``nn.BatchNorm2d`` bit for bit, the registry
models keep their ``state_dict`` keys, ``convert_global_bn`` takes every
BatchNorm, the launch counters stay 0, the wrapper refuses what the kernels
do not take (a CPU tensor too), and the launch plan (load width, chunks)
covers each channel's values once, as the kernels index them. The
``cuda``-marked tests hold the kernels on the card against ``F.batch_norm``
in float64, each gap within twice cuDNN fp32's own, and one ``train_step``
of MN and of DyMN through them:

    python -m pytest --noconftest -m cuda tests/test_torch_batch_norm.py
"""

from collections import Counter

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from efficientat_tpu_torch.models import dymn as dymn_module
from efficientat_tpu_torch.models import layers
from efficientat_tpu_torch.models.registry import build_model
from efficientat_tpu_torch.ops import batch_norm as bn
from efficientat_tpu_torch.parallel.ddp import GlobalBatchNorm2d, convert_global_bn
from efficientat_tpu_torch.utils.profiling import counter, reset_counters

SMS = 132  # an H100 SXM's SMs

# every BatchNorm input of mn10_as at B = 120 on 10 s clips, (C, H, W): the
# 46 layers' 19 shapes
MN10_SHAPES = [
    (64, 64, 500), (16, 64, 500), (72, 32, 250), (64, 32, 250), (24, 32, 250),
    (120, 16, 125), (240, 16, 125), (40, 16, 125), (72, 16, 125),
    (672, 8, 63), (480, 8, 63), (184, 8, 63), (200, 8, 63), (80, 8, 63),
    (240, 8, 63), (112, 8, 63), (960, 4, 32), (672, 4, 32), (160, 4, 32),
]
MN10_LAYERS = 46
# DyMN's context layers, (C, F + T, 1): H x W not a multiple of a 16-byte pack
ODD_SHAPES = [(32, 71, 1), (128, 141, 1), (5, 7, 9)]
REGISTRY = ["mn10_as", "dymn10_as", "mn04_as"]
# one train step against another: the loss, fp32 sums in another order
# through 17 layers (chip_smoke.py's TOL_STEP_LOSS_REL)
TOL_STEP_LOSS_REL = 1e-4


@pytest.fixture(autouse=True)
def _skip_cuda_without_card(request):
    if request.node.get_closest_marker("cuda") and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ and have no CPU mode")


def _inputs(shape, seed, dtype=torch.float32, device="cpu"):
    """x with a channel offset and spread of its own, and an upstream
    gradient."""
    gen = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=gen) * torch.rand(c, generator=gen)[:, None, None] * 3
         + torch.randn(c, generator=gen)[:, None, None] * 2)
    dy = torch.randn(shape, generator=gen)
    w = 1 + 0.5 * torch.randn(c, generator=gen)
    b = 0.5 * torch.randn(c, generator=gen)
    rm = 0.1 * torch.randn(c, generator=gen)
    rv = 1 + torch.rand(c, generator=gen)
    return [t.to(device) for t in (x.to(dtype), dy.to(dtype), w, b, rm, rv)]


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("shape", [(4, 16, 8, 10), (1, 3, 5, 7)])
@pytest.mark.parametrize("momentum", [0.01, 0.1, None])
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_module_is_nn_batchnorm_on_cpu(mode, momentum, shape):
    x, dy, w, b, rm, rv = _inputs(shape, seed=1)
    mods = []
    for cls in (nn.BatchNorm2d, layers.BatchNorm2d):
        mod = cls(shape[1], eps=1e-3, momentum=momentum)
        with torch.no_grad():
            mod.weight.copy_(w)
            mod.bias.copy_(b)
            mod.running_mean.copy_(rm)
            mod.running_var.copy_(rv)
        mod.train(mode == "train")
        mods.append(mod)
    outs = []
    for mod in mods:
        xi = x.clone().requires_grad_()
        ys = [mod(xi) for _ in range(2)]  # two steps move the buffers twice
        sum((y * dy).sum() for y in ys).backward()
        outs.append((ys, xi.grad, mod.weight.grad, mod.bias.grad, list(mod.buffers())))
    (want_y, want_dx, want_dw, want_db, want_buf), (y, dx, dw, db, buf) = outs
    for got, want in zip(y + [dx, dw, db] + buf, want_y + [want_dx, want_dw, want_db] + want_buf):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _pre_change(monkeypatch):
    """Build models with ``nn.BatchNorm2d`` where the port puts its own."""
    monkeypatch.setattr(layers, "BatchNorm2d", nn.BatchNorm2d)
    monkeypatch.setattr(dymn_module, "BatchNorm2d", nn.BatchNorm2d)


@pytest.mark.parametrize("name", REGISTRY)
def test_state_dict_keys_unchanged_and_load_strict(name, monkeypatch):
    model = build_model(name)
    with monkeypatch.context() as m:
        _pre_change(m)
        plain = build_model(name)
    assert not any(type(x) is nn.BatchNorm2d for x in model.modules())
    assert sum(isinstance(x, layers.BatchNorm2d) for x in model.modules()) == \
        sum(type(x) is nn.BatchNorm2d for x in plain.modules()) > 0
    want = plain.state_dict()
    assert [(k, v.shape) for k, v in model.state_dict().items()] == \
        [(k, v.shape) for k, v in want.items()]
    model.load_state_dict(want, strict=True)
    plain.load_state_dict(model.state_dict(), strict=True)


@pytest.mark.parametrize("name", ["mn10_as", "dymn10_as"])
def test_convert_global_bn_takes_every_batchnorm(name):
    model = build_model(name)
    n_bn = sum(isinstance(m, nn.BatchNorm2d) for m in model.modules())
    keys = list(model.state_dict())
    convert_global_bn(model)
    kinds = Counter(type(m) for m in model.modules() if isinstance(m, nn.BatchNorm2d))
    assert kinds == {GlobalBatchNorm2d: n_bn}
    assert list(model.state_dict()) == keys


def test_convert_global_bn_takes_a_plain_batchnorm():
    model = convert_global_bn(nn.Sequential(nn.BatchNorm2d(3)))
    assert type(model[0]) is GlobalBatchNorm2d


def test_counters_stay_zero_on_cpu():
    reset_counters("bn.")
    model = build_model("mn04_as").train()
    logits, _ = model(torch.randn(2, 1, 128, 100))
    logits.sum().backward()
    assert (counter("bn.launch.forward"), counter("bn.launch.backward")) == (0, 0)


def _bad_args():
    x, _, w, b, rm, rv = _inputs((2, 4, 6, 8), seed=2)
    layout, params = "contiguous NCHW", "running statistics are contiguous"
    return {
        "not_contiguous": ((x.transpose(2, 3), w, b, rm, rv), ValueError, layout),
        "channels_last": ((x.to(memory_format=torch.channels_last), w, b, rm, rv), ValueError,
                          layout),
        "fp16": ((x.half(), w, b, rm, rv), TypeError, "float32 or bfloat16"),
        "fp64": ((x.double(), w, b, rm, rv), TypeError, "float32 or bfloat16"),
        "no_running_stats": ((x, w, b, None, None), ValueError, "track_running_stats"),
        "no_affine": ((x, None, None, rm, rv), ValueError, "affine"),
        "three_dims": ((x[0], w, b, rm, rv), ValueError, layout),
        "bf16_gamma": ((x, w.bfloat16(), b, rm, rv), ValueError, params),
        "one_value_a_channel": ((x[:1, :, :1, :1].contiguous(), w, b, rm, rv), ValueError,
                                "more than 1 value"),
        "cpu_input": ((x, w, b, rm, rv), ValueError, "CUDA tensor"),
    }


@pytest.mark.parametrize("case", list(_bad_args()))
def test_wrapper_refuses(case):
    args, error, match = _bad_args()[case]
    with pytest.raises(error, match=match):
        bn.batch_norm_train(*args, momentum=0.1, eps=1e-5)


def _visits(shape, launch):
    """How often the kernels, as csrc/batch_norm.cu indexes them, read each
    value of an (N, C, H, W) input under ``launch``: block (k, c) reads
    groups k chunk .. min(groups, (k + 1) chunk) - 1; group g is values
    (g % hwv) vec .. + vec - 1 of plane (g // hwv, c)."""
    n, c, h, w = shape
    hw = h * w
    hwv = hw // launch.vec
    groups = n * hwv
    seen = np.zeros(n * c * hw, dtype=np.int64)
    spans = [(k * launch.chunk, min(groups, (k + 1) * launch.chunk))
             for k in range(launch.chunks)]
    for ch in range(c):
        for g0, g1 in spans:
            g = np.arange(g0, g1)
            start = (g // hwv * c + ch) * hw + g % hwv * launch.vec
            for i in range(launch.vec):
                np.add.at(seen, start + i, 1)
    return seen


PLAN_CASES = ([(120,) + s for s in MN10_SHAPES[:1]]
              + [(2, 16, 64, 500), (1, 64, 64, 500), (3, 960, 4, 32), (7, 5, 7, 9),
                 (4, 32, 71, 1), (120, 300, 2, 2)])


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("shape", PLAN_CASES)
def test_plan_reads_every_value_once(shape, itemsize):
    for aligned in (True, False):
        launch = bn.plan(shape, itemsize, SMS, aligned)
        if shape[0] * shape[1] * shape[2] * shape[3] <= 2 ** 22:
            assert (_visits(shape, launch) == 1).all(), launch
        groups = shape[0] * shape[2] * shape[3] // launch.vec
        assert launch.chunk * (launch.chunks - 1) < groups <= launch.chunk * launch.chunks


@pytest.mark.parametrize("shape", MN10_SHAPES)
def test_plan_fills_the_card_at_mn10_shapes(shape):
    """At B = 120 every mn10_as layer loads 16 bytes at a time and puts at
    least two waves of blocks on the 132 SMs."""
    full = (120,) + shape
    for itemsize in (4, 2):
        launch = bn.plan(full, itemsize, SMS)
        assert launch.vec == 16 // itemsize
        assert launch.chunks * shape[0] >= 2 * SMS


def test_plan_takes_one_value_at_a_time_where_it_must():
    assert bn.plan((8, 32, 71, 1), 4, SMS).vec == 1
    assert bn.plan((8, 32, 12, 1), 2, SMS).vec == 1  # 12 bf16 values: not 8
    assert bn.plan((8, 32, 12, 1), 4, SMS).vec == 4
    assert bn.plan((8, 32, 64, 4), 4, SMS, aligned=False).vec == 1


def test_time_bn_takes_the_46_mn10_shapes():
    """The timing tool's shapes are the layers these tests hold, and they
    hold PERF.md's byte count: 11,261,440 values a clip."""
    from efficientat_tpu_torch.tools.time_bn import layer_shapes

    shapes = layer_shapes("mn10_as", 120, device="cpu")
    assert len(shapes) == MN10_LAYERS
    assert {s[1:] for s in shapes} == set(MN10_SHAPES)
    assert sum(c * h * w for _, c, h, w in shapes) == 11_261_440


def test_bound_bytes_counts_the_passes():
    assert bn.bound_bytes((120, 64, 64, 500), 4, "forward") == 3 * 120 * 64 * 32000 * 4
    assert bn.bound_bytes((120, 64, 64, 500), 2, "backward") == 5 * 120 * 64 * 32000 * 2
    assert bn.bound_bytes((8, 3, 4, 5), 4, "backward") == 5 * 8 * 3 * 20 * 4


# ------------------------------------------------------------------ card


def _run(kind, x, dy, w, b, rm, rv, momentum=0.01, eps=1e-3):
    """One training-mode forward and backward: ``kind`` "port" (the
    module's kernels), "cudnn" (``F.batch_norm`` in x's dtype) or "f64"
    (``F.batch_norm`` in float64). Returns y, dx, dgamma, dbeta, running
    mean, running var."""
    if kind == "f64":
        x, dy, w, b, rm, rv = (t.double() for t in (x, dy, w, b, rm, rv))
    x = x.clone().requires_grad_()
    w = w.clone().requires_grad_()
    b = b.clone().requires_grad_()
    rm, rv = rm.clone(), rv.clone()
    if kind == "port":
        y = bn.batch_norm_train(x, w, b, rm, rv, momentum, eps)
    else:
        with torch.backends.cudnn.flags(enabled=True):
            y = F.batch_norm(x, rm, rv, w, b, True, momentum, eps)
    y.backward(dy)
    return [t.detach() for t in (y, x.grad, w.grad, b.grad, rm, rv)]


def _gap(got, want):
    want = want.double()
    return float((got.double() - want).abs().max() / want.abs().max().clamp_min(1e-30))


NAMES = ("y", "dx", "dgamma", "dbeta", "running_mean", "running_var")
CARD_CASES = ([((120,) + s, torch.float32) for s in MN10_SHAPES]
              + [((120,) + s, torch.float32) for s in ODD_SHAPES]
              + [((1, 64, 64, 500), torch.float32), ((1, 32, 71, 1), torch.float32)]
              + [((120,) + s, torch.bfloat16) for s in
                 [(16, 64, 500), (72, 32, 250), (672, 8, 63), (960, 4, 32), (32, 71, 1)]])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", CARD_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{str(d)[6:]}" for s, d in CARD_CASES])
def test_kernels_match_float64_within_twice_cudnn(shape, dtype):
    args = _inputs(shape, seed=sum(shape), dtype=dtype, device="cuda")
    want = _run("f64", *args)
    port = _run("port", *args)
    lib = _run("cudnn", *args)
    torch.cuda.synchronize()
    gaps = {n: (_gap(p, e), _gap(c, e)) for n, p, c, e in zip(NAMES, port, lib, want)}
    print(shape, dtype, {n: f"{p:.3g} / {c:.3g}" for n, (p, c) in gaps.items()})
    for n, (p, c) in gaps.items():
        assert p <= 2 * c, (n, p, c)
    for t, e in zip(port, lib):
        assert t.dtype == e.dtype and t.shape == e.shape


@pytest.mark.cuda
def test_module_counts_batches_and_runs_the_kernels():
    x, dy, w, b, rm, rv = _inputs((8, 24, 16, 20), seed=4, device="cuda")
    mod = layers.BatchNorm2d(24, eps=1e-3, momentum=None).cuda().train()
    ref = nn.BatchNorm2d(24, eps=1e-3, momentum=None).cuda().train()
    reset_counters("bn.")
    for _ in range(3):
        mod(x.requires_grad_()).backward(dy)
        ref(x).backward(dy)
    torch.cuda.synchronize()
    assert int(mod.num_batches_tracked) == int(ref.num_batches_tracked) == 3
    assert (counter("bn.launch.forward"), counter("bn.launch.backward")) == (3, 3)
    for got, want in ((mod.running_mean, ref.running_mean), (mod.running_var, ref.running_var)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # eval mode is the eval kernel on the same buffers, recorded by autograd
    # or not (the same bits), against float64 within twice the gap of
    # nn.BatchNorm2d's inference path (cuDNN)
    ref.load_state_dict(mod.state_dict())
    mod.eval()
    reset_counters("bn.")
    recorded = mod(x)
    with torch.no_grad():
        plain = mod(x)
    lib = ref.eval()(x)
    want = F.batch_norm(x.double(), mod.running_mean.double(), mod.running_var.double(),
                        mod.weight.double(), mod.bias.double(), False, 0.0, mod.eps)
    assert torch.equal(recorded, plain)
    assert _gap(recorded, want) <= max(2 * _gap(lib, want), 2.0 ** -23)
    assert (counter("bn.launch.forward"), counter("bn.launch.eval")) == (0, 2)


@pytest.mark.cuda
def test_module_checks_replaced_parameters_again():
    x = _inputs((4, 8, 6, 10), seed=7, device="cuda")[0]
    mod = layers.BatchNorm2d(8).cuda().train()
    mod(x)
    mod.weight.data = mod.weight.data.bfloat16()
    with pytest.raises(ValueError, match="running statistics are contiguous"):
        mod(x)
    mod.weight.data = mod.weight.data.float()
    mod(x)
    with pytest.raises(ValueError, match="running statistics are contiguous"):
        mod(torch.cat([x, x], dim=1))  # 16 channels against gamma's 8


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((120, 16, 64, 500), torch.float32),
                                         ((120, 960, 4, 32), torch.float32),
                                         ((120, 672, 8, 63), torch.bfloat16),
                                         ((120, 32, 71, 1), torch.float32)])
def test_kernels_give_the_same_bits_twice(shape, dtype):
    args = _inputs(shape, seed=5, dtype=dtype, device="cuda")
    first, second = _run("port", *args), _run("port", *args)
    for n, a, b in zip(NAMES, first, second):
        assert torch.equal(a, b), n


@pytest.mark.cuda
def test_misaligned_input_takes_single_loads():
    shape = (16, 24, 32, 40)
    x, dy, w, b, rm, rv = _inputs(shape, seed=6, device="cuda")
    buf = torch.empty(x.numel() + 1, device="cuda")
    xs = buf[1:].view(shape)
    xs.copy_(x)
    assert xs.is_contiguous() and xs.data_ptr() % 16
    got = _run("port", xs, dy, w, b, rm, rv)
    want = _run("port", x, dy, w, b, rm, rv)
    for n, a, e in zip(NAMES, got, want):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5, msg=n)


def _seeded_state(model, seed):
    """A state dict for ``model`` whose activations keep their scale (as
    chip_smoke.py's ``seeded_weights``): convs by fan-in, BatchNorm near
    identity, small Linears, a DyMN's banks by one bank's fan-in times the
    square root of their count. (The registry's own init leaves a DyMN's
    depthwise DynamicConv non-finite on random input.)"""
    g = torch.Generator().manual_seed(seed)
    banks = {f"{n}.weight": m for n, m in model.named_modules()
             if isinstance(m, dymn_module.DynamicConv)}
    sd = model.state_dict()
    for key, v in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key.endswith("running_var"):
            sd[key] = 1.0 + 0.1 * torch.rand(v.shape, generator=g)
        elif v.dim() == 1:
            base = 1.0 if key.endswith((".1.weight", "_norm.weight")) else 0.0
            sd[key] = base + 0.1 * torch.randn(v.shape, generator=g)
        elif key in banks:
            m = banks[key]
            fan_in = v.shape[-1] // m.out_channels
            sd[key] = torch.randn(v.shape, generator=g) * (2.0 * m.k / fan_in) ** 0.5
        else:
            gain = 2.0 if v.dim() == 4 else 0.1
            sd[key] = torch.randn(v.shape, generator=g) * (gain / v[0].numel()) ** 0.5
    return sd


def _step(name, use_port, seed=0, clips=8, seconds=2):
    """One ``train_step`` of ``name`` on the card from seeded weights and
    draws: its loss and the BN launch counts; ``use_port`` False builds the
    model with ``nn.BatchNorm2d`` (cuDNN), as before the port had its own."""
    from efficientat_tpu_torch.ops.melspec import MelConfig
    from efficientat_tpu_torch.train.loop import LossConfig, StepRandom, make_optimizer, train_step

    mp = pytest.MonkeyPatch()
    if not use_port:
        _pre_change(mp)
    try:
        model = build_model(name)
    finally:
        mp.undo()
    model.load_state_dict(_seeded_state(model, seed))
    model.cuda()
    torch.manual_seed(seed)
    mel_cfg = MelConfig(freqm=0, timem=0)
    loss_cfg = LossConfig(kind="bce", mixup_alpha=0.3)
    rng = np.random.default_rng(seed)
    batch = {"wave": torch.from_numpy(
                 (rng.standard_normal((clips, seconds * 32000)) * 0.1).astype(np.float32)).cuda(),
             "target": torch.from_numpy(
                 (rng.random((clips, 527)) < 0.05).astype(np.float32)).cuda()}
    draws = StepRandom(seed).draw(mel_cfg, loss_cfg, clips, seconds * 32000)
    opt = make_optimizer(model.parameters(), 1e-4)
    reset_counters("bn.")
    out = train_step(model, opt, None, mel_cfg, loss_cfg, batch, draws,
                     dft_precision="fp32", temperature=30.0)
    torch.cuda.synchronize()
    return float(out["train_loss"]), counter("bn.launch.forward"), counter("bn.launch.backward")


@pytest.mark.cuda
def test_mn10_train_step_counts_46_each_way_and_predict_none():
    from efficientat_tpu_torch.infer.tag import Tagger

    loss, fwd, bwd = _step("mn10_as", use_port=True)
    assert np.isfinite(loss)
    assert (fwd, bwd) == (MN10_LAYERS, MN10_LAYERS)
    tagger = Tagger("mn10_as", pretrained=False, device="cuda")
    reset_counters("bn.")
    tagger.predict(np.random.default_rng(0).standard_normal((4, 32000)).astype(np.float32))
    assert (counter("bn.launch.forward"), counter("bn.launch.backward")) == (0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dymn10_as", "mn10_as"])
def test_train_step_loss_matches_cudnn_batchnorm(name):
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        port, fwd, bwd = _step(name, use_port=True, seed=3)
        plain, fwd0, bwd0 = _step(name, use_port=False, seed=3)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old
    n_bn = sum(isinstance(m, nn.BatchNorm2d) for m in build_model(name).modules())
    assert (fwd, bwd, fwd0, bwd0) == (n_bn, n_bn, 0, 0)
    assert np.isfinite(port)
    assert abs(port - plain) / abs(plain) <= TOL_STEP_LOSS_REL, (port, plain)
