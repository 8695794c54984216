"""ESC-50 dataset (reference: datasets/esc50.py).

Copy of ``efficientat_tpu/data/esc50.py``, verbatim but for import paths:
the port imports nothing of the JAX package.

2000 wav clips, 50 classes, 5-fold cross-validation via the ``fold`` column
of ``meta/esc50.csv``; 5 s clips at 32 kHz, one-hot targets. Audio decode
uses this package's native WAV path (the reference uses librosa).
Location: ``dataset_dir`` arg or ``EATPU_ESC50_DIR`` env var.
"""

from __future__ import annotations

import csv
import os
import numpy as np

from efficientat_tpu_torch.data.audio_io import load_waveform
from efficientat_tpu_torch.data.core import Dataset, MixupDataset, PreprocessDataset, roll_aug
from efficientat_tpu_torch.data.hdf5 import pad_or_truncate

NUM_CLASSES = 50
CLIP_SECONDS = 5.0


def _dir(dataset_dir):
    d = dataset_dir or os.environ.get("EATPU_ESC50_DIR")
    if not d:
        raise ValueError("ESC-50 location not set: pass dataset_dir= or set EATPU_ESC50_DIR")
    return d


class ESC50Dataset(Dataset):
    def __init__(self, dataset_dir=None, fold: int = 1, train: bool = True,
                 resample_rate: int = 32000, gain_augment: int = 0):
        d = _dir(dataset_dir)
        meta_csv = os.path.join(d, "meta", "esc50.csv")
        self.audio_path = os.path.join(d, "audio")
        with open(meta_csv) as f:
            rows = list(csv.DictReader(f))
        if train:
            rows = [r for r in rows if int(r["fold"]) != fold]
        else:
            rows = [r for r in rows if int(r["fold"]) == fold]
        self.rows = rows
        self.resample_rate = resample_rate
        self.gain_augment = gain_augment
        self.clip_samples = int(CLIP_SECONDS * resample_rate)

    def __len__(self):
        return len(self.rows)

    def get(self, index, rng):
        row = self.rows[index]
        wave = load_waveform(os.path.join(self.audio_path, row["filename"]),
                             target_sr=self.resample_rate)
        if self.gain_augment:
            gain = int(rng.integers(0, self.gain_augment * 2)) - self.gain_augment
            wave = wave * np.float32(10.0 ** (gain / 20.0))
        wave = pad_or_truncate(wave, self.clip_samples)
        target = np.zeros(NUM_CLASSES, np.float32)
        target[int(row["target"])] = 1.0
        return {"wave": wave.astype(np.float32), "fname": row["filename"],
                "target": target}


def get_training_set(dataset_dir=None, resample_rate=32000, roll=True,
                     wavmix=True, gain_augment=12, fold=1):
    """Roll + waveform mixup default ON for fine-tuning (ex_esc50.py:200-202)."""
    ds = ESC50Dataset(dataset_dir, fold, True, resample_rate, gain_augment)
    if roll:
        ds = PreprocessDataset(ds, roll_aug)
    if wavmix:
        ds = MixupDataset(ds)
    return ds


def get_test_set(dataset_dir=None, resample_rate=32000, fold=1):
    return ESC50Dataset(dataset_dir, fold, False, resample_rate)
