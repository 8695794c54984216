"""Port's Tagger and CLI against the JAX Tagger on one checkpoint file."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_oracle import make_dymn_state_dict, make_mn_state_dict

from efficientat_tpu.data.wavecodec import encode
from efficientat_tpu.infer.tag import Tagger as JaxTagger
from efficientat_tpu_torch.infer.tag import Tagger
from efficientat_tpu_torch.models.convert import load_pretrained
from efficientat_tpu_torch.models.registry import get_model_config
from efficientat_tpu_torch.ops.mel_kernel import log_mel_spectrogram_fused

ROOT = Path(__file__).resolve().parents[1]
DEMO = str(ROOT / "assets" / "demo_scene.wav")
NAME = "mn04_as"
# mel and MN both in fp32 on the CPU, summed in another order on each side,
# then the sigmoid; measured gaps are ~1e-6
ATOL_PROBS = 5e-5


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("resources")
    sd = make_mn_state_dict(get_model_config(NAME).model_cfg, seed=0)
    torch.save(sd, d / get_model_config(NAME).file)
    return str(d)


@pytest.fixture(scope="module")
def taggers(ckpt_dir):
    return (JaxTagger(NAME, model_dir=ckpt_dir),
            Tagger(NAME, model_dir=ckpt_dir, device="cpu"))


@pytest.mark.parametrize("codec", ["f32", "i16", "mulaw8"])
def test_predict_matches_jax(taggers, codec):
    jax_tagger, tagger = taggers
    rng = np.random.default_rng(0)
    waves = np.clip(rng.normal(size=(2, 32000)) * 0.2, -1, 1).astype(np.float32)
    coded = encode(waves, codec)
    want = jax_tagger.predict(coded)
    got = tagger.predict(coded)
    assert got.shape == want.shape == (2, 527)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_PROBS)


def test_tag_demo_clip_matches_jax(taggers):
    jax_tagger, tagger = taggers
    want = jax_tagger.tag(DEMO, top_k=5)
    got = tagger.tag(DEMO, top_k=5)
    assert [label for label, _ in got] == [label for label, _ in want]
    np.testing.assert_allclose([p for _, p in got], [p for _, p in want],
                               rtol=0, atol=ATOL_PROBS)


def test_ensemble_averages_logits(ckpt_dir):
    one = Tagger(NAME, model_dir=ckpt_dir, device="cpu")
    two = Tagger([NAME, NAME], model_dir=ckpt_dir, device="cpu")
    waves = np.random.default_rng(1).normal(size=(1, 32000)).astype(np.float32) * 0.1
    np.testing.assert_allclose(two.predict(waves), one.predict(waves), rtol=0, atol=1e-6)


def test_random_weights_are_seeded():
    waves = np.random.default_rng(2).normal(size=(1, 16000)).astype(np.float32) * 0.1
    with pytest.warns(UserWarning, match="random weights"):
        a, b, c = (Tagger(NAME, pretrained=False, device="cpu", seed=s)
                   for s in (3, 3, 4))
    sa, sb, sc = (t.members[0].state_dict() for t in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["features.0.0.weight"], sc["features.0.0.weight"])
    probs = a.predict(waves)
    assert probs.shape == (1, 527) and np.isfinite(probs).all()


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_pretrained(NAME, str(tmp_path))
    with pytest.raises(FileNotFoundError):
        Tagger(NAME, model_dir=str(tmp_path), device="cpu")


def test_load_pretrained_refuses_other_class_count(ckpt_dir):
    # the checkpoint file's own class count loads; another one needs
    # classifier-head surgery (efficientat_tpu/models/convert.py:83-100),
    # not ported yet
    model = load_pretrained(NAME, ckpt_dir, num_classes=527)
    assert model.state_dict()["classifier.5.weight"].shape[0] == 527
    with pytest.raises(NotImplementedError, match="head surgery"):
        load_pretrained(NAME, ckpt_dir, num_classes=10)
    with pytest.raises(NotImplementedError, match="head surgery"):
        Tagger(NAME, model_dir=ckpt_dir, num_classes=50, device="cpu")


# an ImageNet DyMN: its Tagger must run at t_max 30, not forward's default 1
DYMN = "dymn04_im"


@pytest.fixture(scope="module")
def dymn_dir(tmp_path_factory):
    from efficientat_tpu.models.registry import get_model_config as jax_config

    d = tmp_path_factory.mktemp("dymn")
    spec = jax_config(DYMN)
    torch.save(make_dymn_state_dict(spec.model_cfg, seed=1), d / spec.file)
    return str(d)


@pytest.mark.parametrize("codec", ["f32", "mulaw8"])
def test_dymn_predict_matches_jax(dymn_dir, codec):
    assert get_model_config(DYMN).model_cfg.t_max == 30.0
    waves = np.clip(np.random.default_rng(3).normal(size=(2, 32000)) * 0.2,
                    -1, 1).astype(np.float32)
    coded = encode(waves, codec)
    want = JaxTagger(DYMN, model_dir=dymn_dir).predict(coded)
    got = Tagger(DYMN, model_dir=dymn_dir, device="cpu").predict(coded)
    assert got.shape == want.shape == (2, 527)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_PROBS)


def test_dymn_serves_at_t_max(dymn_dir):
    tagger = Tagger(DYMN, model_dir=dymn_dir, device="cpu")
    model = tagger.members[0]
    waves = np.random.default_rng(4).normal(size=(2, 32000)).astype(np.float32) * 0.1
    mel = log_mel_spectrogram_fused(torch.from_numpy(waves), tagger.mel_cfg)[:, None]
    with torch.no_grad():
        at = {t: torch.sigmoid(model(mel, t)[0]).numpy() for t in (1.0, 30.0)}
    probs = tagger.predict(waves)
    np.testing.assert_allclose(probs, at[30.0], rtol=0, atol=1e-6)
    assert np.abs(probs - at[1.0]).max() > 1e-4


def test_dymn_random_weights_full_width():
    waves = np.random.default_rng(5).normal(size=(2, 32000)).astype(np.float32) * 0.1
    with pytest.warns(UserWarning, match="random weights"):
        tagger = Tagger("dymn10_as", pretrained=False, device="cpu")
    probs = tagger.predict(waves)
    assert probs.shape == (2, 527) and np.isfinite(probs).all()


def test_mixed_mn_dymn_ensemble_averages_logits(ckpt_dir, dymn_dir, tmp_path):
    # one directory holding both files: the ensemble's probs are the
    # sigmoid of the mean of the members' logits
    for d in (ckpt_dir, dymn_dir):
        for f in os.listdir(d):
            os.symlink(os.path.join(d, f), tmp_path / f)
    waves = np.random.default_rng(6).normal(size=(2, 32000)).astype(np.float32) * 0.1
    both = Tagger([NAME, DYMN], model_dir=str(tmp_path), device="cpu")
    logit = lambda p: np.log(p) - np.log1p(-p)
    ones = [Tagger(n, model_dir=str(tmp_path), device="cpu").predict(waves)
            for n in (NAME, DYMN)]
    want = 1.0 / (1.0 + np.exp(-(logit(ones[0].astype(np.float64))
                                 + logit(ones[1].astype(np.float64))) / 2))
    np.testing.assert_allclose(both.predict(waves), want, rtol=0, atol=1e-5)


def test_cli_tag_runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "efficientat_tpu_torch.cli", "tag",
         "--no-pretrained", "--device", "cpu", "--model_name", NAME,
         "--audio_path", DEMO],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ": " in ln and "*" not in ln]
    assert len(lines) == 10
