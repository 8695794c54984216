"""The port's analysis tools and their CLI subcommands against the JAX
package's, on every registry name at a 10 s input, and against independent
oracles: the reference's published MAC table, the port's own ``nn.Module``
parameters, and the reference's forward-hook MAC count (upstream
helpers/flop_count.py) on the port's MN modules."""

import dataclasses
import importlib

import h5py
import numpy as np
import pytest
import torch
from torch import nn

import codec_oracles
from efficientat_tpu import cli as jax_cli
from efficientat_tpu.models.registry import REGISTRY as JAX_REGISTRY
from efficientat_tpu.tools.layer_plan import layer_plan as jax_layer_plan
from efficientat_tpu.tools import macs as jax_macs
from efficientat_tpu.tools import peak_memory as jax_peak
from efficientat_tpu_torch import cli
from efficientat_tpu_torch.models.dymn import DyMNConfig
from efficientat_tpu_torch.models.htsat import HTSATConfig
from efficientat_tpu_torch.models.mn import MNConfig
from efficientat_tpu_torch.models.passt import PaSSTConfig
from efficientat_tpu_torch.models.registry import REGISTRY, build_model
from efficientat_tpu_torch.ops.melspec import MelConfig
from efficientat_tpu_torch.tools import (
    count_macs,
    count_params,
    layer_plan,
    peak_memory_cnn,
    peak_memory_mnv3,
    receptive_field,
)
from efficientat_tpu_torch.tools.complexity import count_module_params, report_complexity
from efficientat_tpu_torch.tools.macs import TransformerSpec, count_macs_transformer
from efficientat_tpu_torch.tools.receptive_field import (
    parse_layer_spec,
    receptive_field_from_layers,
)

# the module, which the package's ``receptive_field`` function shadows
jax_rf = importlib.import_module("efficientat_tpu.tools.receptive_field")
# the EfficientAT zoo's names, which the JAX registry holds too (the port's
# PaSST-S and HTS-AT are counted in tests/test_torch_passt.py and
# tests/test_torch_htsat.py)
NAMES = sorted(n for n, s in REGISTRY.items()
               if not isinstance(s.model_cfg, (PaSSTConfig, HTSATConfig)))
# the peak-memory estimates: the same float arithmetic in one order, so
# equal but for the last bit
RTOL_PEAK = 1e-12


def _configs(name):
    """(port config, JAX config, input_f, input_t) of a registry name at a
    10 s clip of its own mel config."""
    spec = REGISTRY[name]
    mel = spec.mel_cfg
    return (spec.model_cfg, JAX_REGISTRY[name].model_cfg, mel.n_mels,
            mel.num_frames(10 * mel.sr))


def test_registries_hold_the_same_names():
    assert len(NAMES) == 46 and set(NAMES) == set(JAX_REGISTRY)
    assert set(REGISTRY) - set(NAMES) == {"passt_s_swa_p16_128_ap476", "htsat_tiny_as"}


# ------------------------------------------------------- against the JAX tools

@pytest.mark.parametrize("name", NAMES)
def test_layer_plan_matches_jax(name):
    cfg, jcfg, f, t = _configs(name)
    got = [dataclasses.asdict(l) for l in layer_plan(cfg, f, t)]
    want = [dataclasses.asdict(l) for l in jax_layer_plan(jcfg, f, t)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, (g["name"], w["name"])


@pytest.mark.parametrize("name", NAMES)
def test_macs_and_params_match_jax(name):
    cfg, jcfg, f, t = _configs(name)
    assert count_macs(cfg, f, t) == jax_macs.count_macs(jcfg, f, t)
    assert count_params(cfg) == jax_macs.count_params(jcfg)
    assert isinstance(count_macs(cfg, f, t), int)


@pytest.mark.parametrize("name", NAMES)
def test_peak_memory_matches_jax(name):
    cfg, jcfg, f, t = _configs(name)
    for bits in (16, 32):
        np.testing.assert_allclose(peak_memory_cnn(cfg, f, t, bits),
                                   jax_peak.peak_memory_cnn(jcfg, f, t, bits),
                                   rtol=RTOL_PEAK, atol=0)
        if isinstance(cfg, MNConfig):
            np.testing.assert_allclose(peak_memory_mnv3(cfg, f, t, bits),
                                       jax_peak.peak_memory_mnv3(jcfg, f, t, bits),
                                       rtol=RTOL_PEAK, atol=0)


@pytest.mark.parametrize("name", NAMES)
def test_receptive_field_matches_jax(name):
    cfg, jcfg, f, t = _configs(name)
    assert receptive_field(cfg, f, t) == jax_rf.receptive_field(jcfg, f, t)


@pytest.mark.parametrize("spec", [
    TransformerSpec(),  # PaSST-S on a 10 s AudioSet mel
    TransformerSpec(input_f=32, input_t=50, embed_dim=16, depth=2, num_heads=2,
                    patch_size=8, stride_f=4, stride_t=4, num_classes=5),
], ids=["passt_s", "small"])
def test_transformer_macs_match_jax(spec):
    jspec = jax_macs.TransformerSpec(**dataclasses.asdict(spec))
    assert spec.seq_len == jspec.seq_len
    assert count_macs_transformer(spec) == jax_macs.count_macs_transformer(jspec)


# the strings of tests/test_tools.py::test_receptive_field_generic_layers,
# and the CLI help's example
@pytest.mark.parametrize("text", ["3x1:2x1,3:1:2", "3", "3:2,3:1:2,5x3:2x1"])
def test_parse_layer_spec_matches_jax(text):
    try:
        want = jax_rf.parse_layer_spec(text)
    except ValueError:
        with pytest.raises(ValueError):
            parse_layer_spec(text)
        return
    assert parse_layer_spec(text) == want
    assert (receptive_field_from_layers(want)
            == jax_rf.receptive_field_from_layers(want))


# --------------------------------------------- against independent oracles

# README.md:96-112: MACs in billions for a 10 s clip (128 x 1000 input), the
# cases and tolerances of tests/test_tools.py
@pytest.mark.parametrize("cfg,kw,macs_b,tol", [
    *[(MNConfig(width_mult=w), {}, b, 0.013)
      for w, b in ((0.4, 0.11), (0.5, 0.16), (1.0, 0.54), (2.0, 2.06), (3.0, 4.55),
                   (4.0, 8.03))],
    *[(MNConfig(), {"input_f": m}, b, 0.012)
      for m, b in ((40, 0.21), (64, 0.27), (256, 1.08))],
    *[(MNConfig(), {"input_t": MelConfig(hopsize=h).num_frames(320000)}, b, 0.012)
      for h, b in ((480, 0.36), (640, 0.27), (800, 0.22))],
    *[(DyMNConfig(width_mult=w), {}, b, tol)
      for w, b, tol in ((0.4, 0.12, 0.015), (1.0, 0.58, 0.03), (2.0, 2.20, 0.1))],
])
def test_macs_match_reference_table(cfg, kw, macs_b, tol):
    got = count_macs(cfg, **kw) / 1e9
    assert abs(got - macs_b) <= tol, (got, macs_b)


@pytest.mark.parametrize("name", ["mn04_as", "mn10_as_fc", "dymn04_as",
                                  "dymn10_replace_se_as"])
def test_complexity_param_count_is_the_modules(name, capsys):
    n_params = sum(p.numel() for p in build_model(name).parameters())
    assert count_module_params(name) == n_params
    report_complexity(name, measure="macs")
    assert f"has {n_params / 1e6:.2f} million parameters" in capsys.readouterr().out


def test_complexity_report_mn04(capsys):
    report_complexity("mn04_as", measure="macs")
    out = capsys.readouterr().out
    assert "0.11 billion multiply-accumulate" in out
    assert "0.98 million parameters" in out


def _hook_macs(model, input_f, input_t):
    """(module name, MACs) of every Conv2d and Linear in forward order,
    counted by the reference's forward hooks (upstream
    helpers/flop_count.py:10-35) at batch 1."""
    seen = []

    def conv_hook(name):
        def hook(m, inp, out):
            _, _, h, w = out.shape
            kernel_ops = m.kernel_size[0] * m.kernel_size[1] * (m.in_channels // m.groups)
            bias_ops = 1 if m.bias is not None else 0
            seen.append((name, m.out_channels * (kernel_ops + bias_ops) * h * w))
        return hook

    def linear_hook(name):
        def hook(m, inp, out):
            batch = inp[0].shape[0] if inp[0].dim() == 2 else 1
            bias_ops = m.bias.nelement() if m.bias is not None else 0
            seen.append((name, batch * (m.weight.nelement() + bias_ops)))
        return hook

    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d):
            m.register_forward_hook(conv_hook(name))
        elif isinstance(m, nn.Linear):
            m.register_forward_hook(linear_hook(name))
    with torch.no_grad():
        model.eval()(torch.zeros(1, 1, input_f, input_t))
    return seen


@pytest.mark.parametrize("name", ["mn04_as", "mn10_as"])
def test_mn_macs_match_forward_hooks(name):
    model = build_model(name)
    hooks = _hook_macs(model, 128, 100)
    plan = layer_plan(REGISTRY[name].model_cfg, 128, 100)
    assert len(hooks) == len(plan)
    for (module, got), layer in zip(hooks, plan):
        assert got == layer.macs(), f"{module} (plan {layer.name}): {got} != {layer.macs()}"
    assert sum(m for _, m in hooks) == count_macs(REGISTRY[name].model_cfg, 128, 100)


# ------------------------------------------------------------------- the CLI

@pytest.mark.parametrize("argv", [
    ["complexity", "--model_name", "mn10_as"],
    ["complexity", "--model_name", "dymn04_as"],
    ["complexity", "--model_name", "mn10_as_hop_5", "--clip_seconds", "4"],
    ["complexity", "--model_name", "mn10_as", "--measure", "memory"],
    ["complexity", "--model_name", "dymn04_as", "--measure", "memory", "--bits", "32"],
    ["complexity", "--transformer"],
    ["complexity", "--transformer", "--embed_dim", "192", "--depth", "4",
     "--stride", "16", "--input_t", "500"],
    ["receptive-field", "--model_name", "mn10_as_fc_s2211"],
    ["receptive-field", "--model_name", "dymn10_as"],
    ["receptive-field", "--model_width", "1.0", "--strides", "2", "2", "1", "1"],
    ["receptive-field", "--model_name", "mn04_as", "--se_dims", "cf",
     "--head_type", "fully_convolutional"],
    ["receptive-field", "--layers", "3:2,3:1:2,5x3:2x1"],
], ids=lambda a: "_".join(a).replace("-", ""))
def test_cli_prints_what_jax_prints(argv, capsys):
    cli.main(argv)
    got = capsys.readouterr().out
    jax_cli.main(argv)
    want = capsys.readouterr().out
    assert got and got == want


def _mp3_hdf5(path, clips=3, seconds=1, sr=32000):
    """An AudioSet-format mp3-HDF5 as bench.py's host-fed fixture lays it
    out: vlen mp3 bytes, packed-bit targets, 'Y'-prefixed names."""
    rng = np.random.default_rng(7)
    t = np.arange(seconds * sr) / sr
    with h5py.File(path, "w") as f:
        d = f.create_dataset("mp3", (clips,), dtype=h5py.special_dtype(vlen=np.dtype("uint8")))
        targets = np.zeros((clips, 66), np.uint8)
        for i in range(clips):
            wave = (0.25 * np.sin(2 * np.pi * (100 + 7.3 * i) * t)
                    + 0.05 * rng.normal(size=t.size)).astype(np.float32)
            d[i] = np.frombuffer(codec_oracles.encode_mp3_lame(wave, sr, bitrate=64,
                                                               mode="mono"), np.uint8)
            c = int(rng.integers(0, 527))
            targets[i, c // 8] |= 0x80 >> (c % 8)
        f.create_dataset("target", data=targets)
        f.create_dataset("audio_name",
                         data=np.asarray([f"Ytest{i:05d}.mp3".encode() for i in range(clips)]))


def test_convert_dataset_matches_jax(tmp_path, capsys):
    from efficientat_tpu.data.hdf5 import convert_mp3_hdf5_to_pcm
    from efficientat_tpu_torch.data import native

    if not codec_oracles.have_lame():
        pytest.skip("system lame not available for the mp3 fixture")
    if not native.available():
        pytest.skip("the native mp3 decoder does not build here")
    src, dst, want = (str(tmp_path / n) for n in ("mp3.hdf", "pcm.hdf", "jax.hdf"))
    _mp3_hdf5(src)
    cli.main(["convert-dataset", "--src", src, "--dst", dst])
    assert capsys.readouterr().out == f"wrote {dst}\n"
    convert_mp3_hdf5_to_pcm(src, want)
    with h5py.File(dst, "r") as g, h5py.File(want, "r") as w:
        assert set(g) == set(w) == {"pcm", "target", "audio_name"}
        assert dict(g.attrs) == dict(w.attrs) == {"sample_rate": 32000}
        assert len(g["pcm"]) == len(w["pcm"]) == 3
        for a, b in zip(g["pcm"], w["pcm"]):
            assert a.dtype == np.int16 and len(a) >= 32000
            np.testing.assert_array_equal(a, b)
        for key in ("target", "audio_name"):
            np.testing.assert_array_equal(g[key][...], w[key][...])
