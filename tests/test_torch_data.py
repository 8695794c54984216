"""The port's copies of the host data code against the JAX package's originals.

The copies are verbatim but for import paths, so on the same seeded numpy
inputs every result must be identical, bit for bit.
"""

from pathlib import Path

import numpy as np
import pytest

from efficientat_tpu.data import audio_io as jaudio_io
from efficientat_tpu.data import core as jcore
from efficientat_tpu.data import wavecodec as jwavecodec
from efficientat_tpu.utils import labels as jlabels
from efficientat_tpu_torch.data import audio_io, core, wavecodec
from efficientat_tpu_torch.utils import labels

DEMO = Path(__file__).resolve().parents[1] / "assets" / "demo_scene.wav"


def _tree_equal(got, want):
    assert type(got) is type(want) or isinstance(want, np.ndarray)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _tree_equal(g, w)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("target_sr", [32000, 16000])
def test_load_waveform(target_sr):
    got = audio_io.load_waveform(str(DEMO), target_sr=target_sr)
    want = jaudio_io.load_waveform(str(DEMO), target_sr=target_sr)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("orig_sr,target_sr", [(44100, 32000), (48000, 32000),
                                               (32000, 16000), (32000, 32000)])
def test_resample(orig_sr, target_sr):
    wave = np.random.default_rng(0).normal(size=4410).astype(np.float32) * 0.1
    np.testing.assert_array_equal(audio_io.resample(wave, orig_sr, target_sr),
                                  jaudio_io.resample(wave, orig_sr, target_sr))
    np.testing.assert_array_equal(audio_io.stride_resample(wave, 32000, 8000),
                                  jaudio_io.stride_resample(wave, 32000, 8000))


@pytest.mark.parametrize("codec", wavecodec.CODECS)
@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_encode(codec, dtype):
    assert wavecodec.CODECS == jwavecodec.CODECS
    rng = np.random.default_rng(1)
    wave = np.clip(rng.normal(size=(3, 1000)) * 0.3, -1.0, 1.0)
    wave = ((wave * 32767).astype(np.int16) if dtype == np.int16
            else wave.astype(np.float32))
    got = wavecodec.encode(wave, codec)
    want = jwavecodec.encode(wave, codec)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        wavecodec.encode(wave, "flac")


def test_mulaw_decode():
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(wavecodec.mulaw_decode(codes),
                                  jwavecodec.mulaw_decode(codes))


@pytest.mark.parametrize("length,target", [(1000, 4000), (32000, 32600),
                                           (5, 700), (300, 300)])
def test_exact_eval_pad(length, target):
    wave = np.random.default_rng(length).normal(size=length).astype(np.float32)
    np.testing.assert_array_equal(core.exact_eval_pad(wave, target),
                                  jcore.exact_eval_pad(wave, target))


@pytest.mark.parametrize("weight_sum", [True, False])
def test_balanced_sample_weights(weight_sum):
    targets = (np.random.default_rng(2).random((200, 30)) > 0.8).astype(np.float32)
    got = core.balanced_sample_weights(targets, weight_sum=weight_sum)
    np.testing.assert_array_equal(
        got, jcore.balanced_sample_weights(targets, weight_sum=weight_sum))
    rng_a, rng_b = (np.random.default_rng(3) for _ in range(2))
    np.testing.assert_array_equal(
        core.weighted_sample_without_replacement(got, 50, rng_a),
        jcore.weighted_sample_without_replacement(got, 50, rng_b))


def _dataset(mod, n=10, samples=800):
    """A seeded in-memory dataset built from ``mod``'s classes, wrapped in
    roll, gain and mixup as the task builders wrap theirs."""

    class Waves(mod.Dataset):
        def __len__(self):
            return n

        def get(self, index, rng):
            g = np.random.default_rng(index)
            return {"wave": g.normal(size=samples).astype(np.float32),
                    "target": (g.random(6) > 0.5).astype(np.float32),
                    "fname": f"clip{index}", "index": index}

    ds = mod.PreprocessDataset(Waves(), mod.roll_aug)
    ds = mod.PreprocessDataset(ds, mod.gain_aug)
    return mod.MixupDataset(ds, beta=2.0, rate=0.7)


@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_epoch(shuffle):
    def epoch(mod):
        sampler = mod.SequentialSampler(10, shuffle=shuffle, seed=4)
        loader = mod.Loader(_dataset(mod), batch_size=4, sampler=sampler,
                            num_threads=2, seed=5)
        return len(loader), list(loader.epoch(1))

    (n_got, got), (n_want, want) = epoch(core), epoch(jcore)
    assert n_got == n_want == 3 and len(got) == 3
    _tree_equal(got, want)


def test_weighted_epoch_sampler():
    w = np.random.default_rng(6).random(100)
    for replacement in (False, True):
        got = core.WeightedEpochSampler(w, 30, replacement, seed=7).indices(2)
        want = jcore.WeightedEpochSampler(w, 30, replacement, seed=7).indices(2)
        np.testing.assert_array_equal(got, want)


def test_audioset_labels():
    assert labels.AUDIOSET_LABELS == jlabels.AUDIOSET_LABELS
    assert labels.AUDIOSET_IDS == jlabels.AUDIOSET_IDS
    assert labels.NUM_AUDIOSET_CLASSES == 527
