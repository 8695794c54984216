"""Port's windowed tagging (``infer/windowed.py``, ``cli.py windowed-tag``)
against the JAX package's on the CPU, and the manifest's windowed row."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_manifest import MANIFEST, assert_digest_close, write_synth_checkpoint
from torch_oracle import make_mn_state_dict
from torch_threads import one_torch_thread  # noqa: F401

from efficientat_tpu.infer.tag import Tagger as JaxTagger
from efficientat_tpu.infer.windowed import tag_audio_window as jax_tag_audio_window
from efficientat_tpu.infer.windowed import window_signal as jax_window_signal
from efficientat_tpu.models.registry import get_model_config as jax_config
from efficientat_tpu_torch.infer import Tagger, tag_audio_window
from efficientat_tpu_torch.infer.windowed import EATagger, window_signal
from efficientat_tpu_torch.models.registry import get_model_config

ROOT = Path(__file__).resolve().parents[1]
DEMO = str(ROOT / "assets" / "demo_scene.wav")
NAME = "mn04_as"
# mel and MN in fp32 on the CPU, sums in another order on each side, then
# the sigmoid (tests/test_torch_tag.py's bound); measured 6.0e-8
ATOL_PROBS = 5e-5
# chunks of max_batch windows against one batch: the same rows, convs run
# at another batch size (measured 6.0e-8)
ATOL_CHUNKS = 1e-6


def _write_ckpt(d, name, seed):
    torch.save(make_mn_state_dict(jax_config(name).model_cfg, seed=seed),
               os.path.join(d, get_model_config(name).file))


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("resources")
    _write_ckpt(str(d), NAME, seed=0)
    return str(d)


@pytest.fixture(scope="module")
def tagger(ckpt_dir):
    return Tagger(NAME, model_dir=ckpt_dir, device="cpu")


# window 400 samples, hop 100: no samples, below one window, one window,
# between whole windows, and whole windows
@pytest.mark.parametrize("length", [0, 150, 400, 450, 700, 1234])
def test_window_signal_matches_jax(length):
    wave = np.random.default_rng(length).normal(size=length).astype(np.float32)
    got = window_signal(wave, 400, 100)
    want = jax_window_signal(wave, 400, 100)
    assert got.shape == want.shape and got.shape[0] >= 1
    np.testing.assert_array_equal(got, want)


def _assert_rows_match(got, want, atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g["start"], g["end"]) == (w["start"], w["end"])
        assert [lab for lab, _ in g["tags"]] == [lab for lab, _ in w["tags"]]
        np.testing.assert_allclose([p for _, p in g["tags"]], [p for _, p in w["tags"]],
                                   rtol=0, atol=atol)


def test_tag_audio_window_matches_jax(tagger, ckpt_dir):
    want = jax_tag_audio_window(JaxTagger(NAME, model_dir=ckpt_dir), DEMO, 4.0, 2.0,
                                top_k=5)
    got = tag_audio_window(tagger, DEMO, 4.0, 2.0, top_k=5)
    assert len(got) == 4  # 10 s at 4 s / 2 s
    _assert_rows_match(got, want, ATOL_PROBS)


@pytest.mark.parametrize("max_batch", [1, 3, 4, 100])
def test_chunked_equals_unchunked(tagger, max_batch):
    whole = tag_audio_window(tagger, DEMO, 2.0, 1.0, top_k=4)
    chunked = tag_audio_window(tagger, DEMO, 2.0, 1.0, top_k=4, max_batch=max_batch)
    _assert_rows_match(chunked, whole, ATOL_CHUNKS)


def test_eatagger_defaults_20_10(ckpt_dir):
    eat = EATagger(NAME, model_dir=ckpt_dir, device="cpu")
    rows = eat.tag_audio_window(DEMO)
    assert [(r["start"], r["end"]) for r in rows] == [(0.0, 20.0)]
    assert len(rows[0]["tags"]) == 10
    want = jax_tag_audio_window(JaxTagger(NAME, model_dir=ckpt_dir), DEMO, 20.0, 10.0)
    _assert_rows_match(rows, want, ATOL_PROBS)


def test_manifest_windowed_row(tmp_path):
    # scripts/build_parity_manifest.py::check_windowed: mn04_as with the
    # converter's synthetic weights, 2 s windows, 1 s hop, top 3
    row = next(r for r in MANIFEST["paths"] if r["name"] == f"__windowed__[{NAME}]")
    write_synth_checkpoint(str(tmp_path), NAME)
    tagger = Tagger(NAME, model_dir=str(tmp_path), device="cpu")
    rows = tag_audio_window(tagger, str(ROOT / row["audio"]), 2.0, 1.0, top_k=3)
    assert len(rows) == row["n_windows"]
    assert [lab for lab, _ in rows[0]["tags"]] == [lab for lab, _ in row["first_window_tags"]]
    probs = [[p for _, p in r["tags"]] for r in rows]
    assert_digest_close(probs, row["top3_probs"])


def _layout(text):
    """The printout with the labels and probabilities blanked."""
    return [re.sub(r"^    .*: \d\.\d{3}$", "    <label>: <p>", ln)
            for ln in text.splitlines()]


def test_cli_windowed_tag_prints_the_jax_layout():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    args = ["windowed-tag", "--no-pretrained", "--model_name", NAME,
            "--audio_path", DEMO, "--window_size", "4", "--hop_length", "2"]
    out = {}
    for pkg, extra in (("efficientat_tpu_torch", ["--device", "cpu"]),
                       ("efficientat_tpu", [])):
        proc = subprocess.run([sys.executable, "-m", f"{pkg}.cli", *args, *extra],
                              cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr
        out[pkg] = proc.stdout
    got, want = _layout(out["efficientat_tpu_torch"]), _layout(out["efficientat_tpu"])
    assert got == want
    assert got[0] == "[    0.00s -     4.00s]" and len(got) == 4 * 4
