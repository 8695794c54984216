"""Port's DyMN against the flax DyMN and the torch-functional oracle: the
forward of every config at temperatures 1 and 30, the checkpoint keys, the
converter, the parameter counts, the temperature schedule, the DynamicConv
forms, the 1x1 forms (``pw_form``) and the bf16 bank mix
(``dyconv_compute``) against JAX's, one train step against JAX's, and
``remat`` against a plain step (MN and DyMN, one process and two gloo
ranks)."""

import dataclasses
import multiprocessing
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch_oracle import make_dymn_state_dict, torch_dymn_forward
from torch_train_parity import (
    DYMN_CFG,
    LOSS_CFG,
    MEL_CFG,
    MODEL_CFG,
    N_SAMPLES,
    bn_stats_close,
    grads_close,
    jax_config,
    jax_grads_at,
    jax_step,
    make_batch,
    port_step,
    state_dict,
    step_draws,
)

from efficientat_tpu.models import dymn as jdymn
from efficientat_tpu.models.convert import convert_dymn
from efficientat_tpu_torch.models.convert import from_flax_dymn
from efficientat_tpu_torch.models.dymn import (
    DyMN,
    DyMNConfig,
    DynamicConv,
    dyconv_temperature,
    init_weights,
)
from efficientat_tpu_torch.parallel.ddp import DataParallel
from efficientat_tpu_torch.train.loop import task_loss

# the JAX package's own DyMN-vs-oracle bound (tests/test_convert.py:98);
# measured largest gaps of the port against flax over every config and
# both temperatures: 9.5e-7 on the logits, 3.1e-6 on the embedding (absolute),
# and exactly 0 against the oracle (the same NCHW ops)
RTOL, ATOL = 2e-3, 2e-4
TEMPERATURES = [1.0, 30.0]

CONFIGS = {
    "all": dict(),
    "replace_se": dict(use_dy_blocks="replace_se"),
    "fc_head": dict(head_type="fully_convolutional"),
    "no_dyrelu": dict(no_dyrelu=True),
    "no_dyconv": dict(no_dyconv=True),
    "no_ca": dict(no_ca=True),
    "dilated": dict(dilated=True),
}
# the configs torch_dymn_forward computes: mlp head, DynamicConvs, no dilation
ORACLE = ["all", "replace_se", "no_dyrelu", "no_ca"]
# the JAX DyMNConfig field of a TPU lowering the port leaves out
UNPORTED = ("layout",)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs in several worker processes at once: torch's default
    # of one thread a core oversubscribes the cores many times over
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(name):
    return DyMNConfig(width_mult=0.4, num_classes=13, **CONFIGS[name])


def reference_dict(cfg, seed):
    """``make_dymn_state_dict`` for ``cfg``; the keys its dict lacks (the fc
    head, ``no_dyconv``'s ``<conv>.module.weight``) are drawn here alike."""
    sd = make_dymn_state_dict(jax_config(cfg), seed=seed)
    rng = np.random.default_rng(seed + 1000)
    out = {}
    for key, v in DyMN(cfg).state_dict().items():
        n = torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
        if key in sd:
            out[key] = sd[key]
        elif key.endswith("num_batches_tracked"):
            out[key] = torch.tensor(7)
        elif key.endswith("running_var"):
            out[key] = n.abs() + 0.5
        elif key == "classifier.1.weight":  # the fc head's BatchNorm scale
            out[key] = 1.0 + 0.2 * n
        else:
            out[key] = n * (0.3 if v.dim() > 1 else 0.1)
    return out


def _flax_variables(sd, cfg):
    return convert_dymn({k: v.numpy() for k, v in sd.items()}, jax_config(cfg))


def _input():
    return np.random.default_rng(6).normal(size=(2, 1, 128, 64)).astype(np.float32) * 0.5


@pytest.mark.parametrize("temperature", TEMPERATURES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_flax_and_oracle(name, temperature):
    cfg = _cfg(name)
    sd = reference_dict(cfg, seed=5)
    model = DyMN(cfg).eval()
    model.load_state_dict(sd, strict=True)
    x = _input()
    with torch.no_grad():
        logits, emb = model(torch.from_numpy(x), temperature)
    f_logits, f_emb = jdymn.DyMN(jax_config(cfg)).apply(
        jax.tree.map(jnp.asarray, _flax_variables(sd, cfg)),
        jnp.asarray(x.transpose(0, 2, 3, 1)), False, temperature)
    assert logits.shape == (2, 13)
    np.testing.assert_allclose(logits.numpy(), np.asarray(f_logits), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(emb.numpy(), np.asarray(f_emb), rtol=RTOL, atol=ATOL)
    if name in ORACLE:
        with torch.no_grad():
            o_logits, o_emb = torch_dymn_forward(sd, torch.from_numpy(x),
                                                 jax_config(cfg), temperature)
        np.testing.assert_allclose(logits.numpy(), o_logits.numpy(), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(emb.numpy(), o_emb.numpy(), rtol=RTOL, atol=ATOL)


def test_temperature_changes_the_output():
    # a control for the temperature cases above: 1 and 30 give other logits
    cfg = _cfg("all")
    model = DyMN(cfg).eval()
    model.load_state_dict(reference_dict(cfg, seed=5), strict=True)
    x = torch.from_numpy(_input())
    with torch.no_grad():
        gap = (model(x, 1.0)[0] - model(x, 30.0)[0]).abs().max().item()
    assert gap > 10 * ATOL  # measured 5.6e-3


@pytest.mark.parametrize("name", list(CONFIGS))
def test_from_flax_inverts_convert(name):
    cfg = _cfg(name)
    sd = reference_dict(cfg, seed=2)
    back = from_flax_dymn(_flax_variables(sd, cfg), cfg)
    assert set(back) == set(sd)
    for key, value in sd.items():
        if key.endswith("num_batches_tracked"):
            continue  # flax keeps no batch counter
        assert back[key].dtype == value.dtype, key
        torch.testing.assert_close(back[key], value, rtol=0, atol=0)
    DyMN(cfg).load_state_dict(back, strict=True)


@pytest.mark.parametrize("name", ORACLE)
def test_reference_state_dict_loads_strict(name):
    cfg = _cfg(name)
    sd = make_dymn_state_dict(jax_config(cfg), seed=0)
    DyMN(cfg).load_state_dict(sd, strict=True)
    assert set(DyMN(cfg).state_dict()) == set(sd)


@pytest.mark.parametrize("width,expected_m", [(0.4, 1.97), (1.0, 10.57), (2.0, 40.02)])
def test_param_count_matches_flax_and_reference(width, expected_m):
    cfg = DyMNConfig(width_mult=width)
    with torch.device("meta"):
        count = sum(p.numel() for p in DyMN(cfg).parameters())
    shapes = jax.eval_shape(jdymn.DyMN(jax_config(cfg)).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 128, 64, 1), jnp.float32))["params"]
    assert count == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    # the reference table (tests/test_models.py:43-48)
    assert abs(count / 1e6 - expected_m) / expected_m < 0.005


@pytest.mark.parametrize("t_max", [30.0, 1.0])
def test_temperature_schedule_matches_jax(t_max):
    cfg = DyMNConfig(t_max=t_max)
    jcfg = jax_config(cfg)
    for epoch in range(41):
        assert cfg.temperature(epoch) == jcfg.temperature(epoch)
        assert dyconv_temperature(epoch, t_max) == jdymn.dyconv_temperature(epoch, t_max)


def test_registry_config_fields_are_jax_minus_unported():
    port = {f.name for f in dataclasses.fields(DyMNConfig)}
    jax_fields = {f.name for f in dataclasses.fields(jdymn.DyMNConfig)}
    assert port == jax_fields - set(UNPORTED)


# ------------------------------------------------------------ DynamicConv

def _dynamic_conv(c_in, c_out, ks, stride, dilation, seed=0):
    conv = DynamicConv(c_in, c_out, context_dim=8, kernel_size=ks, stride=stride,
                       dilation=dilation)
    init_weights(conv, torch.Generator().manual_seed(seed))
    with torch.no_grad():  # attention logits that differ per sample
        conv.residuals[0].weight.normal_(generator=torch.Generator().manual_seed(seed))
    return conv


def _per_sample_loop(conv, x, h_c, temperature):
    """The reference's math one sample at a time: the sample's own kernel
    (att @ banks), then one ordinary F.conv2d."""
    att = torch.softmax(conv.residuals(h_c) / temperature, dim=-1)
    c_in = x.shape[1]
    groups = c_in if conv.depthwise else 1
    ks = conv.kernel_size
    outs = []
    for b in range(x.shape[0]):
        w = (att[b] @ conv.weight[0, 0]).reshape(conv.out_channels, c_in // groups, ks, ks)
        outs.append(F.conv2d(x[b:b + 1], w, None, conv.stride,
                             (ks - 1) // 2 * conv.dilation, conv.dilation, groups))
    return torch.cat(outs)


# the depthwise shapes of blocks 1 (k3 s2) and 3 (k5 s1), a dilated k5, and
# the pointwise form; all against the per-sample loop in fp32
@pytest.mark.parametrize("c_in,c_out,ks,stride,dilation", [
    (24, 24, 3, 2, 1), (32, 32, 5, 1, 1), (16, 16, 5, 1, 2), (24, 40, 1, 1, 1)],
    ids=["k3s2", "k5s1", "k5_dilated", "pointwise"])
def test_dynamic_conv_equals_per_sample_loop(c_in, c_out, ks, stride, dilation):
    conv = _dynamic_conv(c_in, c_out, ks, stride, dilation)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(3, c_in, 20, 17)).astype(np.float32))
    h_c = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    with torch.no_grad():
        got = conv(x, h_c, 2.0)
        want = _per_sample_loop(conv, x, h_c, 2.0)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("ks", [3, 1], ids=["depthwise", "pointwise"])
def test_dynamic_conv_under_autocast_keeps_fp32_banks(ks):
    # the fold and the bmm run in bf16 under autocast; the attention softmax
    # stays fp32 and the banks' gradient comes back in their dtype
    c = 16
    conv = _dynamic_conv(c, c, ks, 1, 1)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, c, 12, 10)).astype(np.float32))
    h_c = torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y = conv(x, h_c, 1.0)
    assert y.dtype == torch.bfloat16
    y.float().square().sum().backward()
    assert conv.weight.grad.dtype == torch.float32
    assert torch.isfinite(conv.weight.grad).all() and conv.weight.grad.abs().sum() > 0
    with torch.no_grad():
        want = conv(x, h_c, 1.0)
    # bf16 operands: about 3 significant digits
    torch.testing.assert_close(y.float(), want, rtol=3e-2, atol=3e-2)


# ------------------------------------------------ pw_form, dyconv_compute

# tests/test_models.py's bound on the three JAX forms against each other;
# measured: each port form 4e-8 to 7e-8 from JAX's same form. The port
# computes every form as per_sample (models/dymn.py)
ATOL_PW_FORM = 1e-5


@pytest.mark.parametrize("form", ["per_sample", "shared_out", "shared_in"])
def test_pw_form_matches_jax(form):
    cfg = dataclasses.replace(_cfg("all"), pw_form=form)
    sd = reference_dict(cfg, seed=5)
    model = DyMN(cfg).eval()
    model.load_state_dict(sd, strict=True)
    x = _input()
    with torch.no_grad():
        got = model(torch.from_numpy(x), 2.0)[0].numpy()
    want = jdymn.DyMN(jax_config(cfg)).apply(
        jax.tree.map(jnp.asarray, _flax_variables(sd, cfg)),
        jnp.asarray(x.transpose(0, 2, 3, 1)), False, 2.0)[0]
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL_PW_FORM)


@pytest.mark.parametrize("field,value", [("pw_form", "shared"),
                                         ("dyconv_compute", "bf16"),
                                         ("dyconv_compute", "int8")])
def test_unknown_dymn_option_raises(field, value):
    with pytest.raises(ValueError, match=field):
        DyMNConfig(**{field: value})


BF16 = dict(dyconv_compute="bfloat16")
# dyconv_compute="bfloat16" against JAX's on the same weights (the
# scale-keeping reference weights of the tests above), each bound with a
# control, the port's fp32 path against JAX's bf16 one, which must exceed
# four times it. Eval, the whole model (logits up to 0.13): measured
# 5.2e-8, control 8.3e-5. Train mode (BatchNorm on the batch's statistics),
# blocks 1 and 12 alone on a seeded (2, C, 32, 24) input (outputs up to 6,
# where one bf16 step is 2.3e-2): measured 7.0e-5 and 3.2e-3, controls
# 3.7e-2 and 3.8e-2. The whole model in train mode is no test of this:
# there a late BatchNorm normalises 2 clips over a 1 x 1 map, and JAX's own
# bf16 logits move 1.9e-3 when its input moves 1e-6
ATOL_DYCONV_EVAL = 1e-5
ATOL_DYCONV_TRAIN = 5e-3
# the whole gradient (relative L2) of sum(logits * r) in eval mode, the
# bf16 path against jax.grad of JAX's: measured 4.7e-6, the port's fp32
# gradient 6.9e-4 from JAX's bf16 one
RTOL_DYCONV_GRAD_L2 = 1e-4


def _dyconv_eval_setup():
    cfg = _cfg("all")
    sd = reference_dict(cfg, seed=5)
    return cfg, sd, _flax_variables(sd, cfg), _input()


def _port_logits(cfg, sd, x):
    model = DyMN(cfg).eval()
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        return model(torch.from_numpy(x), 2.0)[0]


def test_dyconv_compute_bf16_matches_jax_in_eval():
    cfg, sd, variables, x = _dyconv_eval_setup()
    bf16 = dataclasses.replace(cfg, **BF16)
    # the option leaves the parameter tree as it is: the fp32 model's loads
    # strict
    got = _port_logits(bf16, sd, x)
    assert got.dtype == torch.float32
    model = jdymn.DyMN(jax_config(bf16))
    want = np.asarray(jax.jit(lambda v: model.apply(v, jnp.asarray(x.transpose(0, 2, 3, 1)),
                                                    False, 2.0)[0])(
        jax.tree.map(jnp.asarray, variables)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_DYCONV_EVAL)
    control = np.abs(_port_logits(cfg, sd, x).numpy() - want).max()
    assert control > 4 * ATOL_DYCONV_EVAL, control


@pytest.mark.parametrize("block", [1, 12])
def test_dyconv_compute_bf16_block_matches_jax_in_train_mode(block):
    cfg, sd, variables, _ = _dyconv_eval_setup()
    bf16 = dataclasses.replace(cfg, **BF16)
    cnf = cfg.block_table()[0][block]
    x = np.random.default_rng(block).normal(
        size=(2, cnf.input_channels, 32, 24)).astype(np.float32)

    def port(c):
        model = DyMN(c).train()
        model.load_state_dict(sd, strict=True)
        with torch.no_grad():
            return model.layers[block](torch.from_numpy(x), 2.0)

    jc = jax_config(bf16)
    jblock = jdymn.DYBlock(cnf, jc.width_mult, jc.context_ratio, jc.max_context_size,
                           jc.min_context_size, jc.dyrelu_k, jc.dyconv_k, jc.no_dyrelu,
                           jc.no_dyconv, jc.no_ca, jc.pw_form,
                           dyconv_compute=jc.dyconv_compute)
    v = {c: jax.tree.map(jnp.asarray, variables[c][f"block{block}"])
         for c in ("params", "batch_stats")}
    want = jax.jit(lambda v, xx: jblock.apply(v, xx, True, 2.0, mutable=["batch_stats"])[0])(
        v, jnp.asarray(x.transpose(0, 2, 3, 1)))
    want = np.asarray(want).transpose(0, 3, 1, 2)
    got = port(bf16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_DYCONV_TRAIN)
    control = np.abs(port(cfg).numpy() - want).max()
    assert control > 4 * ATOL_DYCONV_TRAIN, control


@pytest.mark.parametrize("form", ["shared_out", "shared_in"])
def test_pw_form_shared_keeps_pointwise_out_of_the_bf16_mix(form):
    # JAX mixes a shared form's 1x1 in the model's dtype, and only the
    # depthwise fold in bf16; the control, the per_sample form's bf16 1x1,
    # must miss four times the bound. Measured: 3e-8 and 6e-8, control
    # 7.7e-5 (the fp32 model is 9.4e-6 off: the fold's bf16 is the
    # smaller part, held by the per_sample test above)
    cfg, sd, variables, x = _dyconv_eval_setup()
    shared = dataclasses.replace(cfg, pw_form=form, **BF16)
    model = jdymn.DyMN(jax_config(shared))
    want = np.asarray(jax.jit(lambda v: model.apply(v, jnp.asarray(x.transpose(0, 2, 3, 1)),
                                                    False, 2.0)[0])(
        jax.tree.map(jnp.asarray, variables)))
    np.testing.assert_allclose(_port_logits(shared, sd, x).numpy(), want, rtol=0,
                               atol=ATOL_DYCONV_EVAL)
    control = np.abs(_port_logits(dataclasses.replace(cfg, **BF16), sd, x).numpy()
                     - want).max()
    assert control > 4 * ATOL_DYCONV_EVAL, control


def _grad_l2(got, want):
    num = sum(float(((got[n].double() - want[n].double()) ** 2).sum()) for n in got)
    return (num / sum(float((want[n].double() ** 2).sum()) for n in got)) ** 0.5


def test_dyconv_compute_bf16_gradient_matches_jax():
    cfg, sd, variables, x = _dyconv_eval_setup()
    r = np.random.default_rng(8).normal(size=(2, cfg.num_classes)).astype(np.float32)
    bf16 = dataclasses.replace(cfg, **BF16)

    def port_grads(c):
        model = DyMN(c).eval()
        model.load_state_dict(sd, strict=True)
        (model(torch.from_numpy(x), 2.0)[0] * torch.from_numpy(r)).sum().backward()
        return {n: p.grad for n, p in model.named_parameters()}

    jv = jax.tree.map(jnp.asarray, variables)
    jmodel = jdymn.DyMN(jax_config(bf16))

    def loss(params):
        logits = jmodel.apply({"params": params, "batch_stats": jv["batch_stats"]},
                              jnp.asarray(x.transpose(0, 2, 3, 1)), False, 2.0)[0]
        return (logits * r).sum()

    # the compiled loss's gradient, as test_dymn_train_step_matches_jax takes it
    grads = jax.grad(jax.jit(loss))(jv["params"])
    want = from_flax_dymn({"params": jax.tree.map(np.asarray, grads),
                           "batch_stats": variables["batch_stats"]}, bf16)
    got = port_grads(bf16)
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in got.values())
    assert _grad_l2(got, want) <= RTOL_DYCONV_GRAD_L2
    control = _grad_l2(port_grads(cfg), want)
    assert control > 4 * RTOL_DYCONV_GRAD_L2, control


@pytest.mark.parametrize("option", ["bfloat16", "float32"])
def test_dyconv_compute_under_autocast_at_its_dtype_changes_nothing(option):
    # JAX mixes only where the model's dtype is not the mix dtype: under
    # autocast at bf16 "bfloat16" is the model's own, and in an fp32 model
    # "float32" is
    cfg, sd, _, x = _dyconv_eval_setup()
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=option == "bfloat16"):
        plain = _port_logits(cfg, sd, x)
        got = _port_logits(dataclasses.replace(cfg, dyconv_compute=option), sd, x)
    assert torch.equal(got, plain)


# ----------------------------------------------------------- train steps

# the train step's gates (PERF.md section 2); the gradients are held by
# grads_close (torch_train_parity.py: 1e-2 relative L2, 5e-2 a tensor)
RTOL_STEP_LOSS = 1e-4
TEMPERATURE = DYMN_CFG.temperature(10)  # 20.0: mid-anneal


def test_dymn_train_step_matches_jax():
    seed = 3
    sd, batch = state_dict(seed=seed, cfg=DYMN_CFG), make_batch(4, seed=seed)
    key = jax.random.PRNGKey(11)
    draws = step_draws(key, 0, MEL_CFG, LOSS_CFG, 4, N_SAMPLES)
    got = port_step(sd, batch, draws, cfg=DYMN_CFG, temperature=TEMPERATURE)
    want_loss, want_stats = jax_step(sd, batch, key, cfg=DYMN_CFG,
                                     temperature=TEMPERATURE)
    assert got["loss"] == pytest.approx(want_loss, rel=RTOL_STEP_LOSS)
    # ContextGen's joint_norm normalises over (B, F+T) too
    assert any("joint_norm" in name for name in got["counts"])
    bn_stats_close(got["buffers"], want_stats, sd, got["counts"])
    # the gradients at the port's model input, against JAX's gradient of its
    # compiled loss: here the JAX step's own form, jit(value_and_grad)
    # (XLA:CPU, in fp32 and float64 alike), is 9.4e-2 (relative L2) from
    # it, and from a central finite difference of the loss in float64,
    # which the port's gradient equals (the test below)
    _, jax_grads = jax_grads_at(sd, got["x"], batch, draws.mixup, cfg=DYMN_CFG,
                                temperature=TEMPERATURE, jit_grad=False)
    print("port vs JAX gradients (L2, worst tensor):",
          grads_close(got["grads"], jax_grads))


def test_dymn_gradient_matches_finite_difference():
    # float64, the train step's input and loss: block 0's DyReLU biases,
    # where the jitted JAX gradient misses (the test above)
    seed = 3
    sd, batch = state_dict(seed=seed, cfg=DYMN_CFG), make_batch(4, seed=seed)
    draws = step_draws(jax.random.PRNGKey(11), 0, MEL_CFG, LOSS_CFG, 4, N_SAMPLES)
    x = torch.from_numpy(port_step(sd, batch, draws, cfg=DYMN_CFG,
                                   temperature=TEMPERATURE)["x"]).double()
    model = DyMN(DYMN_CFG)
    model.load_state_dict(sd, strict=True)
    model.double().train()
    t = {k: torch.from_numpy(v).double() for k, v in batch.items()}
    perm, lam = draws.mixup
    mix = (torch.from_numpy(np.array(lam)).double(),
           {k: t[k][torch.from_numpy(np.array(perm))] for k in ("target", "teacher")})

    def loss():
        return task_loss(LOSS_CFG, model(x, TEMPERATURE)[0], t, mix)[0]

    loss().backward()
    bias = model.layers[0].depth_act.coef_net[0].bias
    eps, fd = 1e-5, []
    with torch.no_grad():
        for i in range(8):
            bias[i] += eps
            up = loss().item()
            bias[i] -= 2 * eps
            down = loss().item()
            bias[i] += eps
            fd.append((up - down) / (2 * eps))
    np.testing.assert_allclose(bias.grad[:8].numpy(), fd, rtol=1e-6, atol=1e-9)


# remat recomputes in fp32 on the CPU what the plain step computed: equal
# but for summation order, which the recompute repeats exactly
ATOL_REMAT = 1e-6


def _remat_inputs(cfg):
    seed = 4
    draws = step_draws(jax.random.PRNGKey(5), 0, MEL_CFG, LOSS_CFG, 4, N_SAMPLES)
    return state_dict(seed=seed, cfg=cfg), make_batch(4, seed=seed), draws


def _remat_step(cfg, remat, inputs, dp=None):
    sd, batch, draws = inputs
    if dp is not None:
        rows = dp.rows(4)
        batch = {k: v[rows] for k, v in batch.items()}
    return port_step(sd, batch, draws, dp=dp, cfg=dataclasses.replace(cfg, remat=remat),
                     temperature=TEMPERATURE)


def _assert_remat_transparent(plain, remat):
    torch.testing.assert_close(remat["logits"], plain["logits"], rtol=0, atol=ATOL_REMAT)
    assert remat["loss"] == pytest.approx(plain["loss"], rel=0, abs=ATOL_REMAT)
    for name, g in plain["grads"].items():
        torch.testing.assert_close(remat["grads"][name], g, rtol=0, atol=ATOL_REMAT,
                                   msg=name)
    # the recompute updates no BatchNorm a second time
    for name, b in plain["buffers"].items():
        assert torch.equal(remat["buffers"][name], b), name


@pytest.mark.parametrize("model", ["mn", "dymn"])
def test_remat_step_equals_plain_step(model):
    cfg = MODEL_CFG if model == "mn" else DYMN_CFG
    inputs = _remat_inputs(cfg)
    _assert_remat_transparent(_remat_step(cfg, False, inputs),
                              _remat_step(cfg, True, inputs))


def _rank_main(rank, init, out_dir, inputs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
    try:
        dp = DataParallel(rank, 2, torch.device("cpu"))
        result = {remat: _remat_step(DYMN_CFG, remat, inputs, dp)
                  for remat in (False, True)}
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_remat_ddp_step_equals_plain_ddp_step(tmp_path):
    # two gloo ranks: GlobalBatchNorm2d's all-reduces run again in the
    # recompute, inside DDP's backward; the buffers stay as the forward
    # left them
    ctx = multiprocessing.get_context("spawn")
    init = f"file://{tmp_path / 'rendezvous'}"
    inputs = _remat_inputs(DYMN_CFG)
    procs = [ctx.Process(target=_rank_main, args=(r, init, str(tmp_path), inputs))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert [p.exitcode for p in procs] == [0, 0]
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    for result in ranks:
        _assert_remat_transparent(result[False], result[True])
    assert ranks[0][True]["loss"] == ranks[1][True]["loss"]


def test_convert_global_bn_reaches_context_norm():
    # under DDP every BatchNorm normalises over the global batch, ContextGen's
    # joint_norm over (B, F+T) included
    from efficientat_tpu_torch.parallel.ddp import GlobalBatchNorm2d, convert_global_bn

    model = DyMN(_cfg("all"))
    names = [n for n, m in model.named_modules() if isinstance(m, torch.nn.BatchNorm2d)]
    convert_global_bn(model)
    kinds = {n: type(m) for n, m in model.named_modules() if n in names}
    assert "layers.0.context_gen.joint_norm" in kinds
    assert set(kinds.values()) == {GlobalBatchNorm2d}


def test_init_weights_draws_each_bank_by_fan_out():
    # upstream's init: every bank kaiming normal (fan-out), seeded on the CPU
    cfg = _cfg("all")
    a = init_weights(DyMN(cfg), torch.Generator().manual_seed(5))
    b = init_weights(DyMN(cfg), torch.Generator().manual_seed(5))
    for (key, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), key
    convs = [m for m in a.modules() if isinstance(m, DynamicConv)]
    assert len(convs) == 3 * 15 - 1  # block 0 has no expansion
    for conv in convs:
        std = conv.weight.reshape(conv.k, -1).std(dim=1)
        assert torch.allclose(std, torch.full_like(std, conv.bank_std), rtol=0.2)
