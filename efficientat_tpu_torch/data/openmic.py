"""OpenMIC-2018 dataset (reference: datasets/openmic.py).

Copy of ``efficientat_tpu/data/openmic.py``, verbatim but for import paths:
the port imports nothing of the JAX package.

20 instrument classes; the 40-dim target is [20 instrument probabilities,
20 observed-mask bits] (openmic.py:154-156). Waveform mixup zeroes
unobserved labels and ORs the masks (openmic.py:64-98) — handled by
``MixupDataset(mask_aware=True)``. Masked BCE lives in the train loop.
Location: ``dataset_dir`` arg or ``EATPU_OPENMIC_DIR`` env var; expects
{openmic_train, openmic_test} HDF5 files.
"""

from __future__ import annotations

import os

from efficientat_tpu_torch.data.core import MixupDataset, PreprocessDataset, roll_aug
from efficientat_tpu_torch.data.hdf5 import open_audio_hdf5

NUM_CLASSES = 20  # plus 20 mask bits in the target vector


def _dir(dataset_dir):
    d = dataset_dir or os.environ.get("EATPU_OPENMIC_DIR")
    if not d:
        raise ValueError("OpenMIC location not set: pass dataset_dir= or set EATPU_OPENMIC_DIR")
    return d


def _pick(d, stem):
    for suffix in ("_pcm.hdf", "_mp3.hdf"):
        p = os.path.join(d, stem + suffix)
        if os.path.exists(p):
            return p
    return os.path.join(d, stem + "_mp3.hdf")


def _open(path, resample_rate, gain_augment=0, wave_codec="f32"):
    return open_audio_hdf5(path, sample_rate=32000, clip_length_seconds=10.0,
                           resample_rate=resample_rate,
                           gain_augment=gain_augment, num_classes=40,
                           wave_codec=wave_codec)


def get_training_set(dataset_dir=None, resample_rate=32000, roll=True,
                     wavmix=True, gain_augment=12, wave_codec="f32"):
    # coded transport needs the float augments off (raises otherwise)
    if wave_codec != "f32" and wavmix:
        raise ValueError(f"wave_codec={wave_codec!r} cannot be combined "
                         "with wavmix (a host-side float blend)")
    ds = _open(_pick(_dir(dataset_dir), "openmic_train"), resample_rate,
               gain_augment, wave_codec=wave_codec)
    if roll:
        ds = PreprocessDataset(ds, roll_aug)
    if wavmix:
        ds = MixupDataset(ds, mask_aware=True, n_labels=NUM_CLASSES)
    return ds


def get_test_set(dataset_dir=None, resample_rate=32000):
    return _open(_pick(_dir(dataset_dir), "openmic_test"), resample_rate)
