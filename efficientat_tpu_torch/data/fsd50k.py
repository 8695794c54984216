"""FSD50K dataset (reference: datasets/fsd50k.py).

Copy of ``efficientat_tpu/data/fsd50k.py``, verbatim but for import paths:
the port imports nothing of the JAX package.

200 multi-label classes, HDF5-packed audio; 10 s crops with RANDOM offset
when the clip is longer (fsd50k.py:50-59); ``variable_eval`` evaluates
full-length clips at batch size 1 (fsd50k.py:179-196).
Location: ``dataset_dir`` arg or ``EATPU_FSD50K_DIR`` env var; expects
{FSD50K.train, FSD50K.val, FSD50K.eval} HDF5 files (mp3 or pcm variants).
"""

from __future__ import annotations

import os

from efficientat_tpu_torch.data.core import MixupDataset, PreprocessDataset, roll_aug
from efficientat_tpu_torch.data.hdf5 import open_audio_hdf5

NUM_CLASSES = 200


def _dir(dataset_dir):
    d = dataset_dir or os.environ.get("EATPU_FSD50K_DIR")
    if not d:
        raise ValueError("FSD50K location not set: pass dataset_dir= or set EATPU_FSD50K_DIR")
    return d


def _pick(d, stem):
    for suffix in ("_pcm.hdf", "_mp3.hdf"):
        p = os.path.join(d, stem + suffix)
        if os.path.exists(p):
            return p
    return os.path.join(d, stem + "_mp3.hdf")


def _open(path, resample_rate, gain_augment=0, clip_length=10.0,
          random_offset=True, wave_codec="f32"):
    return open_audio_hdf5(path, sample_rate=32000,
                           clip_length_seconds=clip_length,
                           resample_rate=resample_rate,
                           gain_augment=gain_augment, num_classes=NUM_CLASSES,
                           random_offset_crop=random_offset,
                           wave_codec=wave_codec)


def get_training_set(dataset_dir=None, resample_rate=32000, roll=True,
                     wavmix=True, gain_augment=12, wave_codec="f32"):
    # coded transport needs the float augments off (raises otherwise)
    if wave_codec != "f32" and wavmix:
        raise ValueError(f"wave_codec={wave_codec!r} cannot be combined "
                         "with wavmix (a host-side float blend)")
    ds = _open(_pick(_dir(dataset_dir), "FSD50K.train"), resample_rate,
               gain_augment, wave_codec=wave_codec)
    if roll:
        ds = PreprocessDataset(ds, roll_aug)
    if wavmix:
        ds = MixupDataset(ds)
    return ds


def get_valid_set(dataset_dir=None, resample_rate=32000, variable_eval=False):
    clip = None if variable_eval else 10.0
    return _open(_pick(_dir(dataset_dir), "FSD50K.val"), resample_rate,
                 clip_length=clip, random_offset=False)


def get_eval_set(dataset_dir=None, resample_rate=32000, variable_eval=False):
    clip = None if variable_eval else 10.0
    return _open(_pick(_dir(dataset_dir), "FSD50K.eval"), resample_rate,
                 clip_length=clip, random_offset=False)
