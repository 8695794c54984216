"""The plain reference against the port on the CPU at a small size, the
frozen MAC counts against the port's counter, and the K1 count's bounds.
This file alone imports both the reference and the port."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import gen, spec
from portbench.count import k1
from portbench.mixes import train
from portbench.reference import mel as rmel
from portbench.reference import steps

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.Bench(ROOT)
SEED = 2 ** 31 + 11


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_log_mel_matches_the_ports_float64_oracle():
    from efficientat_tpu_torch.ops.filterbank import kaldi_mel_banks
    from efficientat_tpu_torch.ops.melspec import MelConfig, mel_oracle_f64

    mel = BENCH.config("mn10_as")["mel"]
    wave = gen.waves(3, 20000, [-46, -6], gen.generator(SEED, gen.INPUTS, "cpu"), "cpu")
    banks = kaldi_mel_banks(128, 1024, 32000, 0.0, rmel.effective_fmax(mel))
    ours = rmel.log_mel(wave, mel, banks).numpy()
    oracle = mel_oracle_f64(wave.numpy(), MelConfig(), banks.numpy())
    assert np.abs(ours - oracle).max() < 1e-6  # both float64, cast to float32 once


@pytest.mark.parametrize("fmin,fmax", [(0.0, 15000.0), (7.0, 15861.0), (3.0, 14188.0)])
def test_mel_banks_match_the_port(fmin, fmax):
    from efficientat_tpu_torch.ops.filterbank import kaldi_mel_banks

    mel = BENCH.config("mn10_as")["mel"]
    host = kaldi_mel_banks(128, 1024, 32000, fmin, fmax)  # float64, cast once
    jitter = kaldi_mel_banks(128, 1024, 32000, torch.tensor(fmin), torch.tensor(fmax))
    assert (rmel.mel_banks(mel, fmin, fmax, "cpu", torch.float64) - host).abs().max() < 1e-7
    assert (rmel.mel_banks(mel, fmin, fmax, "cpu") - jitter).abs().max() < 1e-6


@pytest.mark.parametrize("name", ["mn10_as", "dymn10_as"])
def test_serve_probs_match_the_tagger(name):
    from efficientat_tpu_torch.infer.tag import Tagger

    cfg = BENCH.config(name)
    weights = gen.weights(cfg, SEED, "cpu")
    tagger = Tagger(cfg["registry_name"], pretrained=False, device="cpu")
    tagger.members[0].load_state_dict(weights, strict=True)
    wave = gen.waves(2, 32000, [-46, -6], gen.generator(SEED, gen.INPUTS, "cpu"), "cpu")
    ref = steps.serve_probs(cfg, weights, wave).numpy()
    got = tagger.predict(wave.numpy())
    # the port's CPU log-mel is fp32 (3e-5 from float64 near the floor);
    # a wrong layer in the reference moves the probs by 1e-2 or more
    assert np.abs(got - ref).max() < 1e-5
    assert ref.std() > 0.01  # the seeded weights give probs that differ


def test_kd_step_matches_the_train_step(monkeypatch):
    """One KD step of the port against the reference given the port's own
    training-mode log-mel, so that what is compared is the rest of the
    step: mixup, forward, loss, backward and Adam."""
    from efficientat_tpu_torch.ops.melspec import log_mel_spectrogram

    cfg = BENCH.config("mn10_as")
    traffic = dict(BENCH.traffic("train.b120"), batch=4, clip_seconds=1, pool=2,
                   checked_steps=2)
    session = train.Session(cfg, traffic, SEED, "cpu")
    mels = iter([log_mel_spectrogram(b["wave"], session.mel_cfg, training=True, draws=d.mel)
                 for b, (d, _) in zip(session.pool, session.checked)])
    monkeypatch.setattr(rmel, "log_mel", lambda wave, mel, banks, dft_dtype=None: next(mels))
    numbers, failed = session.check({"loss_gap": 1e-6, "grad_gap": 1e-5, "change_gap": 1e-3})
    assert failed == 0
    for name, (value, limit) in numbers.items():
        assert value <= limit, (name, value)


@pytest.mark.parametrize("name", ["mn10_as", "dymn10_as"])
def test_frozen_macs_match_the_ports_counter(name):
    from efficientat_tpu_torch.models.registry import get_model_config
    from efficientat_tpu_torch.tools.macs import count_macs

    cfg = BENCH.config(name)
    assert cfg["macs_per_10s_clip"] == count_macs(get_model_config(cfg["registry_name"]).model_cfg)


def test_config_files_hold_the_registry_widths():
    from efficientat_tpu_torch.models.registry import build_model

    for name in ("mn10_as", "dymn10_as"):
        cfg = BENCH.config(name)
        with torch.device("meta"):
            model = build_model(cfg["registry_name"])
        ours = {k: tuple(v.shape) for k, v in gen.weights(cfg, SEED, "cpu").items()}
        assert ours == {k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("batch,ms", [(64, 0.144), (120, 0.270), (256, 0.577)])
def test_k1_count(batch, ms):
    mel = json.loads((ROOT / "portbench/configs/mn10_as.json").read_text())["mel"]
    assert round(1e3 * k1.bound_s(batch, 320000, mel), 3) == ms
