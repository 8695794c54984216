"""Port's exact-length eval (``time_valid``, FSD50K's ``--variable_eval_length``)
against the JAX package's on the CPU: the masking helpers, MN and DyMN with
``time_valid`` against flax, the masked eval step against JAX's, a padded
batch against each clip alone at batch 1, and ``evaluate fsd50k
--variable_eval_length``."""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from efficientat_tpu.models import dymn as jdymn
from efficientat_tpu.models import layers as jlayers
from efficientat_tpu.models import mn as jmn
from efficientat_tpu_torch.data.core import bucket_pad_collate
from efficientat_tpu_torch.models import layers as tlayers
from efficientat_tpu_torch.models.convert import from_flax_dymn, from_flax_mn
from efficientat_tpu_torch.models.dymn import DyMN, DyMNConfig
from efficientat_tpu_torch.models.mn import MN, MNConfig
from efficientat_tpu_torch.ops.melspec import MelConfig
from efficientat_tpu_torch.train.cli import run_evaluate
from efficientat_tpu_torch.train.loop import eval_step

# the same masked forward in NCHW torch and NHWC XLA, fp32 sums in another
# order; measured gaps against flax are below 2.4e-7
ATOL_FLAX = 1e-5
# a padded masked row against its clip alone at batch 1, both in the port:
# the valid mel frames and every valid activation are the same numbers,
# computed in blocks of another size (measured below 1e-6)
ATOL_BATCH1 = 1e-5
# the port's masked eval step against JAX's: the two packages' log-mels are
# held within 5e-5 of each other (tests/test_torch_melspec.py), the rest as
# above
ATOL_STEP = 1e-4

FRAMES = 100                      # input mel frames of the padded batch
TIME_VALID = np.array([100, 57, 31])

MN_CONFIGS = {
    "mlp": dict(),
    "fully_convolutional": dict(head_type="fully_convolutional"),
    # f and t SE (their sizes follow the input's frames) and the MHA head
    "mha_se_cft": dict(head_type="multihead_attention_pooling", se_dims="cft",
                       input_dim_t=FRAMES),
    "dilated": dict(dilated=True),
    "reduced_tail_s2211": dict(reduced_tail=True, strides=(2, 2, 1, 1)),
}
DYMN_CONFIGS = {
    "all": dict(),
    "replace_se": dict(use_dy_blocks="replace_se"),
    "fc_head_s2211": dict(head_type="fully_convolutional", strides=(2, 2, 1, 1)),
}


def _nchw_input(seed=0, batch=3):
    return np.random.default_rng(seed).normal(
        size=(batch, 1, 128, FRAMES)).astype(np.float32)


def _jittered_flax(module, x_nhwc, seed):
    """flax init plus N(0, 0.05) on every leaf, BatchNorm statistics too, so
    that BN(0) != 0 and a missing mask shows."""
    variables = jax.jit(module.init)(jax.random.PRNGKey(seed), x_nhwc)
    g = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + g.normal(scale=0.05, size=a.shape).astype(np.float32), variables)


def _port_and_flax(cfg, seed=1):
    """The port's model and the flax model with the same jittered weights."""
    x = jnp.asarray(_nchw_input().transpose(0, 2, 3, 1))
    if isinstance(cfg, DyMNConfig):
        fmodel = jdymn.DyMN(jdymn.DyMNConfig(**dataclasses.asdict(cfg)))
        model, convert = DyMN(cfg), from_flax_dymn
    else:
        fmodel = jmn.MN(jmn.MNConfig(**dataclasses.asdict(cfg)))
        model, convert = MN(cfg), from_flax_mn
    variables = _jittered_flax(fmodel, x, seed)
    model.load_state_dict(convert(jax.tree.map(np.asarray, variables), cfg), strict=True)
    return model.eval(), fmodel, variables


@pytest.mark.parametrize("kernel,stride,dilation",
                         [(3, 2, 1), (3, 1, 1), (5, 2, 1), (5, 1, 2), (3, 1, 2)])
def test_conv_out_count_matches_jax(kernel, stride, dilation):
    t = np.arange(1, 40)
    want = np.asarray(jlayers.conv_out_count(jnp.asarray(t), kernel, stride, dilation))
    got = tlayers.conv_out_count(torch.from_numpy(t), kernel, stride, dilation)
    np.testing.assert_array_equal(got.numpy(), want)
    assert [tlayers.conv_out_count(int(v), kernel, stride, dilation) for v in t] \
        == want.tolist()


def test_time_mask_and_masked_time_mean_match_jax():
    x = _nchw_input(seed=2)
    tv = torch.from_numpy(TIME_VALID)
    nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    want = np.asarray(jlayers.time_mask(nhwc, jnp.asarray(TIME_VALID)))
    got = tlayers.time_mask(torch.from_numpy(x), tv).numpy()
    np.testing.assert_array_equal(got, want.transpose(0, 3, 1, 2))
    want = np.asarray(jlayers.masked_time_mean(nhwc, jnp.asarray(TIME_VALID)))
    got = tlayers.masked_time_mean(torch.from_numpy(x), tv).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # a row's masked mean is the plain mean of its valid frames
    np.testing.assert_allclose(got[1], x[1, :, :, :57].mean(axis=(1, 2)), atol=1e-6)


@pytest.mark.parametrize("se_axis", [1, 2, 3], ids=["c", "f", "t"])
def test_squeeze_excitation_time_valid_matches_jax(se_axis):
    x = tlayers.time_mask(torch.from_numpy(_nchw_input(seed=3)),
                          torch.from_numpy(TIME_VALID))
    dim = x.shape[se_axis]
    se = tlayers.SqueezeExcitation(dim, 8, se_axis).eval()
    torch.nn.init.normal_(se.fc1.weight, std=0.3)
    torch.nn.init.normal_(se.fc2.weight, std=0.3)
    jse = jlayers.SqueezeExcitation(dim, 8, {1: 3, 2: 1, 3: 2}[se_axis])
    params = {"params": {n: {"kernel": getattr(se, n).weight.detach().numpy().T,
                             "bias": getattr(se, n).bias.detach().numpy()}
                         for n in ("fc1", "fc2")}}
    with torch.no_grad():
        got = se(x, torch.from_numpy(TIME_VALID)).numpy()
    want = np.asarray(jse.apply(params, jnp.asarray(x.numpy().transpose(0, 2, 3, 1)),
                                jnp.asarray(TIME_VALID)))
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", list(MN_CONFIGS))
def test_mn_time_valid_matches_flax(name):
    cfg = MNConfig(width_mult=0.4, num_classes=10, **MN_CONFIGS[name])
    model, fmodel, variables = _port_and_flax(cfg)
    x = _nchw_input()
    with torch.no_grad():
        logits, emb = model(torch.from_numpy(x), torch.from_numpy(TIME_VALID))
    apply = jax.jit(lambda v, xx, tv: fmodel.apply(v, xx, False, tv))
    f_logits, f_emb = apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)),
                            jnp.asarray(TIME_VALID))
    np.testing.assert_allclose(logits.numpy(), np.asarray(f_logits), rtol=0, atol=ATOL_FLAX)
    np.testing.assert_allclose(emb.numpy(), np.asarray(f_emb), rtol=0, atol=ATOL_FLAX)


@pytest.mark.parametrize("name", list(DYMN_CONFIGS))
def test_dymn_time_valid_matches_flax(name):
    cfg = DyMNConfig(width_mult=0.4, num_classes=10, **DYMN_CONFIGS[name])
    model, fmodel, variables = _port_and_flax(cfg)
    x = _nchw_input()
    with torch.no_grad():
        logits, emb = model(torch.from_numpy(x), 30.0, torch.from_numpy(TIME_VALID))
    apply = jax.jit(lambda v, xx, tv: fmodel.apply(v, xx, False, 30.0, tv))
    f_logits, f_emb = apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)),
                            jnp.asarray(TIME_VALID))
    np.testing.assert_allclose(logits.numpy(), np.asarray(f_logits), rtol=0, atol=ATOL_FLAX)
    np.testing.assert_allclose(emb.numpy(), np.asarray(f_emb), rtol=0, atol=ATOL_FLAX)


@pytest.mark.parametrize("kind", ["mn", "dymn"])
def test_full_length_time_valid_equals_unmasked(kind):
    cfg = (DyMNConfig if kind == "dymn" else MNConfig)(width_mult=0.4, num_classes=10)
    model = _port_and_flax(cfg)[0]
    x = torch.from_numpy(_nchw_input(seed=4, batch=2))
    args = (1.0,) if kind == "dymn" else ()
    with torch.no_grad():
        plain = model(x, *args)
        full = model(x, *args, torch.full((2,), FRAMES))
    for a, b in zip(plain, full):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-6)


# clips of 0.6-2 s: the bucket pads them all to 64000 samples
CLIP_SAMPLES = [20000, 32000, 47000, 64000]


def _clips(seed=0):
    g = np.random.default_rng(seed)
    return [(g.normal(size=n) * 0.1).astype(np.float32) for n in CLIP_SAMPLES]


def _padded_batch(clips):
    batch = bucket_pad_collate(32000)([{"wave": w} for w in clips])
    tv = (batch["wave_samples"].astype(np.int64) - 1) // MelConfig().hopsize + 1
    return torch.from_numpy(batch["wave"]), torch.from_numpy(tv)


@pytest.mark.parametrize("kind", ["mn", "dymn"])
def test_padded_batch_equals_each_clip_alone(kind):
    cfg = (DyMNConfig if kind == "dymn" else MNConfig)(width_mult=0.4, num_classes=10)
    model = _port_and_flax(cfg, seed=5)[0]
    clips = _clips()
    wave, tv = _padded_batch(clips)
    assert wave.shape == (4, 64000) and tv.tolist() == [63, 100, 147, 200]
    got = eval_step(model, MelConfig(), wave, temperature=30.0, time_valid=tv)
    for row, clip in zip(got, clips):
        alone = eval_step(model, MelConfig(), torch.from_numpy(clip[None]),
                          temperature=30.0)[0]
        np.testing.assert_allclose(row.numpy(), alone.numpy(), rtol=0, atol=ATOL_BATCH1)
    # without the mask the padded row misses the bound tenfold
    unmasked = eval_step(model, MelConfig(), wave, temperature=30.0)
    assert float((unmasked[0] - got[0]).abs().max()) > 10 * ATOL_BATCH1


@pytest.mark.parametrize("kind", ["mn", "dymn"])
def test_eval_step_time_valid_matches_jax(kind):
    from efficientat_tpu.ops.melspec import MelConfig as JaxMelConfig
    from efficientat_tpu.train.loop import make_eval_step

    cfg = (DyMNConfig if kind == "dymn" else MNConfig)(width_mult=0.4, num_classes=10)
    model, fmodel, variables = _port_and_flax(cfg, seed=6)
    wave, tv = _padded_batch(_clips(seed=1))
    state = collections.namedtuple("State", "params batch_stats")(
        variables["params"], variables["batch_stats"])
    step = make_eval_step(fmodel, JaxMelConfig(), masked=True)
    want = np.asarray(jax.jit(step)(state, jnp.asarray(wave.numpy()), jnp.float32(30.0),
                                    jnp.asarray(tv.numpy(), jnp.int32)))
    got = eval_step(model, MelConfig(), wave, temperature=30.0, time_valid=tv)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_STEP)


SMALL = ["--batch_size", "2", "--model_width", "0.4", "--num_workers", "1",
         "--device", "cpu", "--variable_eval_length"]


@pytest.fixture
def _in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the metrics logger writes runs/ here


def test_evaluate_fsd50k_variable_eval_length_runs(_in_tmp):
    metrics = run_evaluate("fsd50k", ["--synthetic", "4", "--clip_seconds", "1", *SMALL])
    assert set(metrics) >= {"mAP", "ROC", "val_loss"}
    assert np.isfinite(metrics["val_loss"])


def test_evaluate_variable_lengths_run_each_clip_at_its_length(_in_tmp, monkeypatch):
    # an eval split of clips of four lengths: each batch is padded to its
    # bucket, and eval_step gets every row's valid frames
    from efficientat_tpu_torch.data.core import Dataset
    from efficientat_tpu_torch.train import loop, tasks

    clips = _clips(seed=2)

    class VarDataset(Dataset):
        def __len__(self):
            return len(clips)

        def get(self, index, rng):
            return {"wave": clips[index], "fname": f"v{index}",
                    "target": (np.arange(200) % (index + 2) == 0).astype(np.float32)}

    monkeypatch.setattr(tasks, "build_datasets",
                        lambda spec, args, eval_only=False: (None, None, VarDataset()))
    seen = []

    def spy(*args, **kwargs):
        seen.append((args[2].shape, kwargs["time_valid"].tolist()))
        return eval_step(*args, **kwargs)

    monkeypatch.setattr(loop, "eval_step", spy)
    metrics = run_evaluate("fsd50k", SMALL)
    assert np.isfinite(metrics["val_loss"])
    assert seen == [((2, 32000), [63, 100]), ((2, 64000), [147, 200])]
