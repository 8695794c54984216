"""Port's Tagger and CLI against the JAX Tagger on one checkpoint file."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch_oracle import make_dymn_state_dict, make_mn_state_dict
from torch_threads import one_torch_thread  # noqa: F401

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


def test_predict_runs_each_member_through_the_module_function(ckpt_dir, monkeypatch):
    # the replicated path reaches each member through the module's
    # _member_logits, where a caller can plant another (the benchmark's faults)
    from efficientat_tpu_torch.infer import tag

    tagger = Tagger([NAME, NAME], model_dir=ckpt_dir, device="cpu")
    waves = np.random.default_rng(1).normal(size=(2, 32000)).astype(np.float32) * 0.1
    want = tagger.predict(waves)
    seen = []
    produce = tag._member_logits
    monkeypatch.setattr(tag, "_member_logits",
                        lambda model, mel: seen.append(model) or produce(model, mel) * 0)
    got = tagger.predict(waves)
    assert seen == tagger.members
    np.testing.assert_array_equal(got, np.full_like(want, 0.5))


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


# the release-file digest manifest, <model_dir>/checkpoints.sha256: each
# case's manifest lines ({digest}: the file's sha256, {wrong}: another) and
# whether the file loads
DIGEST_CASES = {
    "right": (["{digest}  {file}"], True),
    "upper_case": (["{DIGEST}  {file}"], True),
    "star_name": (["{digest} *{file}"], True),
    "unlisted": (["{wrong}  other.pt"], True),
    "wrong": (["{wrong}  {file}"], False),
    "last_line_wrong": (["{digest}  {file}", "{wrong}  {file}"], False),
    "last_line_right": (["{wrong}  {file}", "{digest}  {file}"], True),
}


def _digest_dir(root, case, seed=0):
    """A model dir holding NAME's seeded file and the case's manifest."""
    import hashlib

    spec = get_model_config(NAME)
    root.mkdir(parents=True, exist_ok=True)
    path = root / spec.file
    torch.save(make_mn_state_dict(spec.model_cfg, seed=seed), path)
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    wrong = hashlib.sha256(b"another file").hexdigest()
    lines, loads = DIGEST_CASES[case]
    (root / "checkpoints.sha256").write_text("".join(
        line.format(digest=digest, DIGEST=digest.upper(), wrong=wrong,
                    file=spec.file) + "\n" for line in lines))
    return str(root), loads


@pytest.mark.parametrize("case", list(DIGEST_CASES))
def test_load_pretrained_checks_the_digest_manifest(tmp_path, case):
    from efficientat_tpu.models.convert import load_pretrained as jax_load_pretrained

    model_dir, loads = _digest_dir(tmp_path, case)
    if loads:
        model = load_pretrained(NAME, model_dir)
        assert model.classifier[5].out_features == 527
        return
    with pytest.raises(ValueError, match=f"^checksum mismatch for {get_model_config(NAME).file}"):
        load_pretrained(NAME, model_dir)
    # the JAX loader refuses the same file against the same manifest
    with pytest.raises(ValueError, match="^checksum mismatch for"):
        jax_load_pretrained(NAME, model_dir=model_dir)


def test_every_loader_reaches_the_digest_check(tmp_path, monkeypatch):
    # the Tagger, the windowed EATagger and train --pretrained (which reads
    # resources/ in the working directory)
    from efficientat_tpu_torch.infer.windowed import EATagger
    from efficientat_tpu_torch.train.cli import run_train

    model_dir, _ = _digest_dir(tmp_path / "resources", "wrong")
    for cls in (Tagger, EATagger):
        with pytest.raises(ValueError, match="^checksum mismatch for"):
            cls(NAME, model_dir=model_dir, device="cpu")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="^checksum mismatch for"):
        run_train("esc50", ["--pretrained", "--model_name", NAME, "--synthetic", "4",
                            "--batch_size", "2", "--n_epochs", "1", "--clip_seconds", "1",
                            "--num_workers", "1", "--device", "cpu",
                            "--ckpt_dir", str(tmp_path / "ck")])
    _digest_dir(tmp_path / "resources", "right")
    assert Tagger(NAME, model_dir=model_dir, device="cpu").predict(
        np.zeros((1, 32000), np.float32)).shape == (1, 527)


# head type -> (registry name, the keys surgery drops); the head-type
# names of the registry have width 1.0 (mn10_as_fc)
SURGERY = {
    "mlp": ("mn04_as", ("classifier.5.",)),
    "fully_convolutional": ("mn10_as_fc", ("classifier.0.", "classifier.1.")),
}


@pytest.fixture(scope="module")
def surgery_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("surgery")
    for name, _ in SURGERY.values():
        spec = get_model_config(name)
        torch.save(make_mn_state_dict(spec.model_cfg, seed=2), d / spec.file)
    return str(d)


@pytest.mark.parametrize("head", list(SURGERY))
def test_surgery_matches_jax_load_pretrained(surgery_dir, head):
    # a 527-class file loaded as a 10-class model: every tensor outside the
    # head's class-sized layers equals JAX's load_pretrained result, and so
    # does the embedding; the head has 10 classes and keeps its fresh init
    from efficientat_tpu.models.convert import load_pretrained as jax_load_pretrained
    from efficientat_tpu_torch.models.convert import from_flax_mn

    name, dropped = SURGERY[head]
    model = load_pretrained(name, surgery_dir, num_classes=10).eval()
    jmodel, variables, _ = jax_load_pretrained(name, num_classes=10,
                                               model_dir=surgery_dir)
    want = from_flax_mn(jax.tree.map(np.asarray, variables), model.cfg)
    file_sd = torch.load(os.path.join(surgery_dir, get_model_config(name).file))
    got = model.state_dict()
    assert set(got) == set(want)
    for key, value in got.items():
        if key.startswith(dropped):
            if value.dim():  # the class-sized tensors (not BN's counter)
                assert value.shape[0] == 10, key
                assert value.shape != file_sd[key].shape, key
        else:
            torch.testing.assert_close(value, file_sd[key], rtol=0, atol=0, msg=key)
            if not key.endswith("num_batches_tracked"):  # flax keeps no counter
                torch.testing.assert_close(value, want[key], rtol=0, atol=0, msg=key)
    x = np.random.default_rng(7).normal(size=(2, 1, 128, 100)).astype(np.float32)
    with torch.no_grad():
        logits, emb = model(torch.from_numpy(x))
    _, f_emb = jax.jit(jmodel.apply)(variables, jax.numpy.asarray(x.transpose(0, 2, 3, 1)))
    assert logits.shape == (2, 10)
    np.testing.assert_allclose(emb.numpy(), np.asarray(f_emb), rtol=1e-5, atol=1e-4)


def test_surgery_head_is_seeded_and_same_count_loads_strict(surgery_dir):
    name = SURGERY["mlp"][0]
    a, b, c = (load_pretrained(name, surgery_dir, num_classes=10, seed=s)
               for s in (0, 0, 1))
    assert torch.equal(a.classifier[5].weight, b.classifier[5].weight)
    assert not torch.equal(a.classifier[5].weight, c.classifier[5].weight)
    file_sd = torch.load(os.path.join(surgery_dir, get_model_config(name).file))
    for model in (load_pretrained(name, surgery_dir),
                  load_pretrained(name, surgery_dir, num_classes=527)):
        for key, value in model.state_dict().items():
            torch.testing.assert_close(value, file_sd[key], rtol=0, atol=0, msg=key)


def test_surgery_attention_pooling_head(tmp_path, monkeypatch):
    # no registry name has this head: a name of the port's registry gets one
    # for the test
    import dataclasses

    from efficientat_tpu_torch.models import registry

    spec = dataclasses.replace(
        get_model_config(NAME), name="mn04_mha", file="mn04_mha.pt",
        model_cfg=dataclasses.replace(get_model_config(NAME).model_cfg,
                                      head_type="multihead_attention_pooling"))
    monkeypatch.setitem(registry.REGISTRY, spec.name, spec)
    source = registry.build_model(spec.name, generator=torch.Generator().manual_seed(3))
    torch.save(source.state_dict(), tmp_path / spec.file)
    model = load_pretrained(spec.name, str(tmp_path), num_classes=20)
    for key, value in model.state_dict().items():
        if key.startswith(("classifier.subspace_proj.", "classifier.head_weight")):
            assert value.shape != source.state_dict()[key].shape or key.endswith("head_weight")
        else:
            torch.testing.assert_close(value, source.state_dict()[key], rtol=0, atol=0)
    assert model.classifier.subspace_proj.out_features == 20 * 2 * 4
    same = load_pretrained(spec.name, str(tmp_path))
    assert torch.equal(same.classifier.head_weight, source.classifier.head_weight)


def test_surgery_refuses_a_file_that_differs_outside_the_head(surgery_dir, tmp_path):
    name = SURGERY["mlp"][0]
    sd = torch.load(os.path.join(surgery_dir, get_model_config(name).file))
    del sd["features.0.0.weight"]
    torch.save(sd, tmp_path / get_model_config(name).file)
    with pytest.raises(RuntimeError, match="features.0.0.weight"):
        load_pretrained(name, str(tmp_path), num_classes=10)


def test_tagger_with_another_class_count(ckpt_dir):
    tagger = Tagger(NAME, model_dir=ckpt_dir, num_classes=50, device="cpu",
                    labels=[str(i) for i in range(50)])
    probs = tagger.predict(np.zeros((1, 32000), np.float32))
    assert probs.shape == (1, 50) and np.isfinite(probs).all()


def test_train_esc50_pretrained_loads_the_audioset_file(tmp_path, monkeypatch):
    # train esc50 --pretrained: the 527-class file into a 50-class model
    from efficientat_tpu_torch.train.cli import run_train

    monkeypatch.chdir(tmp_path)
    (tmp_path / "resources").mkdir()
    spec = get_model_config(NAME)
    file_sd = make_mn_state_dict(spec.model_cfg, seed=4)
    torch.save(file_sd, tmp_path / "resources" / spec.file)
    loaded = {}
    monkeypatch.setattr(torch.nn.Module, "load_state_dict",
                        _record_load(torch.nn.Module.load_state_dict, loaded))
    result = run_train("esc50", ["--pretrained", "--model_name", NAME, "--synthetic", "4",
                                 "--batch_size", "2", "--n_epochs", "1",
                                 "--clip_seconds", "1", "--num_workers", "1",
                                 "--device", "cpu", "--ckpt_dir", str(tmp_path / "ck")])
    assert result.step == 2 and np.isfinite(result.history[0]["train_loss"])
    assert result.model.classifier[5].out_features == 50
    for key, value in loaded["sd"].items():
        if not key.startswith("classifier.5."):
            torch.testing.assert_close(value, file_sd[key], rtol=0, atol=0, msg=key)


def _record_load(load, into):
    """``nn.Module.load_state_dict`` that keeps the last whole state dict
    loaded strictly (the weights the run starts from)."""
    def wrapped(self, sd, strict=True, **kw):
        if strict:
            into["sd"] = {k: v.clone() for k, v in sd.items()}
        return load(self, sd, strict=strict, **kw)
    return wrapped


# the JAX bf16 Tagger rounds BatchNorm and every activation to bf16 (flax
# dtype); the port's autocasts the convs and Linears only and keeps
# BatchNorm fp32. One measurement on these files, 4 clips of 1 s: port bf16
# against JAX bf16 3.70e-3 (mn04_as) and 3.64e-3 (dymn04_im), JAX bf16
# against JAX fp32 3.55e-3 / 3.56e-3, port bf16 against port fp32 4.1e-4 /
# 3.6e-4
ATOL_BF16 = 1e-2


@pytest.mark.parametrize("name", [NAME, "dymn04_im"])
def test_bf16_tagger_matches_jax_bf16(ckpt_dir, tmp_path, name):
    import jax.numpy as jnp

    from efficientat_tpu.models.registry import get_model_config as jax_config

    d = ckpt_dir
    if name != NAME:
        d = str(tmp_path)
        torch.save(make_dymn_state_dict(jax_config(name).model_cfg, seed=0),
                   tmp_path / jax_config(name).file)
    waves = np.clip(np.random.default_rng(0).normal(size=(4, 32000)) * 0.2,
                    -1, 1).astype(np.float32)
    want = JaxTagger(name, model_dir=d, dtype=jnp.bfloat16).predict(waves)
    bf16 = Tagger(name, model_dir=d, device="cpu", dtype=torch.bfloat16)
    got = bf16.predict(waves)
    fp32 = Tagger(name, model_dir=d, device="cpu").predict(waves)
    assert got.dtype == np.float32 and got.shape == (4, 527)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_BF16)
    np.testing.assert_allclose(got, fp32, rtol=0, atol=ATOL_BF16)
    assert np.abs(got - fp32).max() > 1e-5  # the members ran in bf16


def test_bf16_tagger_keeps_the_mel_fp32(ckpt_dir, monkeypatch):
    from efficientat_tpu_torch.infer import tag

    seen = []
    fused = tag.log_mel_spectrogram_fused

    def spy(*args, **kwargs):
        seen.append(torch.is_autocast_enabled("cpu"))
        out = fused(*args, **kwargs)
        seen.append(out.dtype)
        return out

    monkeypatch.setattr(tag, "log_mel_spectrogram_fused", spy)
    Tagger(NAME, model_dir=ckpt_dir, device="cpu", dtype=torch.bfloat16).predict(
        np.zeros((1, 32000), np.float32))
    assert seen == [False, torch.float32]


def test_cli_tag_bf16_runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "efficientat_tpu_torch.cli", "tag", "--bf16",
         "--no-pretrained", "--device", "cpu", "--model_name", NAME,
         "--audio_path", DEMO],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ": " in ln and "*" not in ln]
    assert len(lines) == 10


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
