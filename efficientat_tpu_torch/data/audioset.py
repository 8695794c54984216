"""AudioSet dataset (reference: datasets/audioset.py).

Copy of ``efficientat_tpu/data/audioset.py``, verbatim but for import paths:
the port imports nothing of the JAX package.

10 s clips, 527 multi-label classes, stored as {balanced, unbalanced,
eval}_segments HDF5 files. Location comes from ``dataset_dir`` or the
``EATPU_AUDIOSET_DIR`` env var (the reference forces users to edit a module
constant, audioset.py:19-22 — replaced with configuration here).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from efficientat_tpu_torch.data.core import (
    ConcatDataset,
    MixupDataset,
    PreprocessDataset,
    WeightedEpochSampler,
    balanced_sample_weights,
    roll_aug,
)
from efficientat_tpu_torch.data.hdf5 import open_audio_hdf5

NUM_CLASSES = 527


def _dir(dataset_dir: Optional[str]) -> str:
    d = dataset_dir or os.environ.get("EATPU_AUDIOSET_DIR")
    if not d:
        raise ValueError(
            "AudioSet location not set: pass dataset_dir= or set EATPU_AUDIOSET_DIR")
    return d


def _paths(dataset_dir):
    d = _dir(dataset_dir)

    def pick(stem):
        # prefer PCM conversion when present
        for suffix in ("_pcm.hdf", "_mp3.hdf"):
            p = os.path.join(d, stem + suffix)
            if os.path.exists(p):
                return p
        return os.path.join(d, stem + "_mp3.hdf")

    return {
        "balanced": pick("balanced_train_segments"),
        "unbalanced": pick("unbalanced_train_segments"),
        "eval": pick("eval_segments"),
    }


def _open(path, resample_rate, gain_augment=0, wave_codec="f32"):
    return open_audio_hdf5(path, sample_rate=32000, clip_length_seconds=10.0,
                           resample_rate=resample_rate, gain_augment=gain_augment,
                           num_classes=NUM_CLASSES, wave_codec=wave_codec)


def _wrap(ds, roll, wavmix):
    if roll:
        ds = PreprocessDataset(ds, roll_aug)
    if wavmix:
        ds = MixupDataset(ds)
    return ds


def _check_codec(wave_codec, wavmix):
    # roll (np.roll) is dtype-agnostic; wavmix blends in float — keep
    # float32 waves for wavmix runs
    if wave_codec != "f32" and wavmix:
        raise ValueError(f"wave_codec={wave_codec!r} cannot be combined "
                         "with wavmix (a host-side float blend)")


def get_training_set(dataset_dir=None, resample_rate=32000, roll=False,
                     wavmix=False, gain_augment=0, wave_codec="f32"):
    """Balanced train split only (audioset.py:242-250)."""
    _check_codec(wave_codec, wavmix)
    p = _paths(dataset_dir)
    return _wrap(_open(p["balanced"], resample_rate, gain_augment,
                       wave_codec), roll, wavmix)


def get_full_training_set(dataset_dir=None, resample_rate=32000, roll=False,
                          wavmix=False, gain_augment=0, wave_codec="f32"):
    """balanced + unbalanced concat — order matters for the sampler weights
    (audioset.py:189-191,217-221)."""
    _check_codec(wave_codec, wavmix)
    p = _paths(dataset_dir)
    ds = ConcatDataset([
        _open(p["balanced"], resample_rate, gain_augment, wave_codec),
        _open(p["unbalanced"], resample_rate, gain_augment, wave_codec),
    ])
    return _wrap(ds, roll, wavmix)


def get_test_set(dataset_dir=None, resample_rate=32000):
    return _open(_paths(dataset_dir)["eval"], resample_rate)


def get_ft_weighted_sampler(dataset_dir=None, epoch_len=100_000,
                            replacement=False, seed=0):
    """Class-balanced sampler over balanced+unbalanced (audioset.py:180-214)."""
    import h5py

    p = _paths(dataset_dir)
    all_targets = []
    for key in ("balanced", "unbalanced"):
        with h5py.File(p[key], "r") as f:
            t = np.asarray(f["target"][...])
            if t.dtype == np.uint8 and t.shape[-1] * 8 >= NUM_CLASSES > t.shape[-1]:
                t = np.unpackbits(t, axis=-1, count=NUM_CLASSES)
            all_targets.append(t.astype(np.float32))
    weights = balanced_sample_weights(np.concatenate(all_targets, axis=0))
    return WeightedEpochSampler(weights, epoch_len, replacement, seed)
