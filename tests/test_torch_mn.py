"""Port's MN against the flax MN and the torch-functional oracle."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_oracle import make_mn_state_dict, torch_mn_forward

from efficientat_tpu.models import layers as jlayers
from efficientat_tpu.models import mn as jmn
from efficientat_tpu.models import registry as jreg
from efficientat_tpu.models.convert import convert_mn
from efficientat_tpu_torch.models import layers as tlayers
from efficientat_tpu_torch.models import registry as treg
from efficientat_tpu_torch.models.convert import from_flax_mn
from efficientat_tpu_torch.models.mn import MN, MNConfig, init_weights

# fp32 convs summed in another order through 17 layers (NCHW torch vs NHWC
# XLA); measured gaps are ~1e-6
ATOL_MN = 1e-4

CONFIGS = {
    "mlp": dict(head_type="mlp"),
    "fully_convolutional": dict(head_type="fully_convolutional"),
    "mha": dict(head_type="multihead_attention_pooling"),
    "dilated": dict(dilated=True),
    "reduced_tail_s2211": dict(reduced_tail=True, strides=(2, 2, 1, 1)),
}


def _cfg(name):
    return MNConfig(width_mult=0.4, **CONFIGS[name])


def _jcfg(cfg):
    return jmn.MNConfig(**dataclasses.asdict(cfg))


def _input():
    rng = np.random.default_rng(0)
    return rng.normal(size=(2, 1, 128, 100)).astype(np.float32)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_reference_state_dict_loads_strict(name):
    cfg = _cfg(name)
    model = MN(cfg)
    model.load_state_dict(make_mn_state_dict(cfg), strict=True)
    assert set(model.state_dict()) == set(make_mn_state_dict(cfg))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_flax_and_oracle(name):
    cfg = _cfg(name)
    sd = make_mn_state_dict(cfg, seed=1)
    model = MN(cfg).eval()
    model.load_state_dict(sd, strict=True)
    x = _input()
    with torch.no_grad():
        logits, emb = model(torch.from_numpy(x))
        o_logits, o_emb = torch_mn_forward(sd, torch.from_numpy(x), cfg)
    jcfg = _jcfg(cfg)
    variables = jax.tree.map(jnp.asarray, convert_mn(
        {k: v.numpy() for k, v in sd.items()}, jcfg))
    f_logits, f_emb = jmn.MN(jcfg).apply(variables,
                                        jnp.asarray(x.transpose(0, 2, 3, 1)))
    assert logits.shape == (2, cfg.num_classes)
    np.testing.assert_allclose(logits.numpy(), np.asarray(f_logits), rtol=0, atol=ATOL_MN)
    np.testing.assert_allclose(emb.numpy(), np.asarray(f_emb), rtol=0, atol=ATOL_MN)
    np.testing.assert_allclose(logits.numpy(), o_logits.numpy(), rtol=0, atol=ATOL_MN)
    np.testing.assert_allclose(emb.numpy(), o_emb.numpy(), rtol=0, atol=ATOL_MN)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_from_flax_inverts_convert(name):
    cfg = _cfg(name)
    sd = make_mn_state_dict(cfg, seed=2)
    back = from_flax_mn(convert_mn({k: v.numpy() for k, v in sd.items()},
                                   _jcfg(cfg)), cfg)
    assert set(back) == set(sd)
    for key, value in sd.items():
        if key.endswith("num_batches_tracked"):
            continue  # flax keeps no batch counter
        assert back[key].dtype == value.dtype, key
        torch.testing.assert_close(back[key], value, rtol=0, atol=0)
    MN(cfg).load_state_dict(back, strict=True)


@pytest.mark.parametrize("se_agg", ["max", "avg", "add", "min"])
def test_concurrent_se_matches_flax(se_agg):
    c, f, t = 16, 8, 12
    block = tlayers.ConcurrentSEBlock(c, f, t, "cft", se_agg, se_r=4)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    params = {}
    for letter, se in zip("cft", block.conc_se_layers):
        params[f"se_{letter}"] = {
            fc: {"kernel": jnp.asarray(getattr(se, fc).weight.detach().numpy().T),
                 "bias": jnp.asarray(getattr(se, fc).bias.detach().numpy())}
            for fc in ("fc1", "fc2")}
    x = np.random.default_rng(4).normal(size=(2, c, f, t)).astype(np.float32)
    want = jlayers.ConcurrentSEBlock(c, f, t, "cft", se_agg, 4).apply(
        {"params": params}, jnp.asarray(x.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-6)


# the JAX DyMNConfig field of a TPU lowering the port leaves out
DYMN_UNPORTED = ("layout",)


@pytest.mark.parametrize("name", sorted(jreg.REGISTRY))
def test_registry_matches_jax(name):
    jspec = jreg.REGISTRY[name]
    spec = treg.get_model_config(name)
    assert spec.file == jspec.file
    assert type(spec.model_cfg).__name__ == type(jspec.model_cfg).__name__
    assert dataclasses.asdict(spec.model_cfg) == {
        k: v for k, v in dataclasses.asdict(jspec.model_cfg).items()
        if k not in DYMN_UNPORTED}
    assert dataclasses.asdict(spec.mel_cfg) == dataclasses.asdict(jspec.mel_cfg)
    with torch.device("meta"):  # every name builds, without allocating
        model = treg.build_model(name)
    assert type(model).__name__ == type(jspec.model_cfg).__name__[:-len("Config")]


def test_init_weights_seeded():
    cfg = MNConfig(width_mult=0.4)
    a = init_weights(MN(cfg), torch.Generator().manual_seed(5)).state_dict()
    b = init_weights(MN(cfg), torch.Generator().manual_seed(5)).state_dict()
    c = init_weights(MN(cfg), torch.Generator().manual_seed(6)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["features.0.0.weight"], c["features.0.0.weight"])
    w = a["features.16.0.weight"]  # 1x1 conv: kaiming fan-out normal
    assert abs(w.std().item() - (2.0 / w.shape[0]) ** 0.5) < 0.1 * (2.0 / w.shape[0]) ** 0.5
    assert abs(a["classifier.5.weight"].std().item() - 0.01) < 1e-3
    assert torch.equal(a["classifier.5.bias"], torch.zeros_like(a["classifier.5.bias"]))
    assert torch.equal(a["features.0.1.weight"], torch.ones_like(a["features.0.1.weight"]))
