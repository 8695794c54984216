"""DCASE 2020 Task 1a (TAU Urban Acoustic Scenes) dataset.

Copy of ``efficientat_tpu/data/dcase20.py``, verbatim but for import paths:
the port imports nothing of the JAX package.

Reference: datasets/dcase20.py — tab-separated metadata with scene/device/
city labels (label-encoded), train/test split via evaluation_setup csvs,
optional on-disk cache of resampled waveforms, and a one-hot-converting
waveform-mixup variant. Items return scene target + device/city side labels
(the training loop logs per-device accuracy; mixstyle targets device
generalization).

Location: ``dataset_dir`` arg or ``EATPU_DCASE20_DIR`` env var.
"""

from __future__ import annotations

import csv
import os
from typing import List, Optional

import numpy as np

from efficientat_tpu_torch.data.audio_io import load_waveform
from efficientat_tpu_torch.data.core import Dataset, PreprocessDataset, gain_aug, roll_aug

NUM_CLASSES = 10


def _dir(dataset_dir):
    d = dataset_dir or os.environ.get("EATPU_DCASE20_DIR")
    if not d:
        raise ValueError("DCASE20 location not set: pass dataset_dir= or set EATPU_DCASE20_DIR")
    return d


def _label_encode(values: List[str]) -> np.ndarray:
    """sklearn LabelEncoder semantics: sorted unique -> index."""
    classes = sorted(set(values))
    lut = {c: i for i, c in enumerate(classes)}
    return np.asarray([lut[v] for v in values], np.int32)


def _read_tsv(path):
    with open(path) as f:
        return list(csv.DictReader(f, delimiter="\t"))


class DCASE20Dataset(Dataset):
    def __init__(self, dataset_dir=None, resample_rate: int = 32000,
                 cache_path: Optional[str] = None):
        self.root = _dir(dataset_dir)
        rows = _read_tsv(os.path.join(self.root, "meta.csv"))
        self.files = [r["filename"] for r in rows]
        self.scene = _label_encode([r["scene_label"] for r in rows])
        self.device = _label_encode([r["source_label"] for r in rows])
        self.city = _label_encode([r["identifier"].split("-")[0] for r in rows])
        self.resample_rate = resample_rate
        self.cache_path = None
        if cache_path is not None:
            self.cache_path = os.path.join(
                cache_path, f"dcase20_r{resample_rate}", "files_cache")
            os.makedirs(self.cache_path, exist_ok=True)

    def __len__(self):
        return len(self.files)

    def _load(self, index):
        if self.cache_path:
            cpath = os.path.join(self.cache_path, f"{index}.npy")
            if os.path.exists(cpath):
                return np.load(cpath)
            wave = load_waveform(os.path.join(self.root, self.files[index]),
                                 target_sr=self.resample_rate)
            np.save(cpath, wave)
            return wave
        return load_waveform(os.path.join(self.root, self.files[index]),
                             target_sr=self.resample_rate)

    def get(self, index, rng):
        return {
            "wave": self._load(index).astype(np.float32),
            "fname": self.files[index],
            "target": int(self.scene[index]),
            "device": int(self.device[index]),
            "city": int(self.city[index]),
            "index": index,
        }


class SelectionDataset(Dataset):
    """Subset by precomputed indices (dcase20.py:67-86)."""

    def __init__(self, dataset: Dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def get(self, index, rng):
        return self.dataset.get(self.indices[index], rng)


class OneHotMixupDataset(Dataset):
    """DCASE mixup: converts scene index to one-hot, mixes mean-centered
    waveforms (dcase20.py:89-121)."""

    def __init__(self, dataset: Dataset, beta: float = 2.0, rate: float = 0.5,
                 num_classes: int = NUM_CLASSES):
        self.dataset = dataset
        self.beta = beta
        self.rate = rate
        self.num_classes = num_classes

    def __len__(self):
        return len(self.dataset)

    def _onehot(self, y):
        out = np.zeros(self.num_classes, np.float32)
        out[int(y)] = 1.0
        return out

    def get(self, index, rng):
        it1 = dict(self.dataset.get(index, rng))
        y1 = self._onehot(it1["target"])
        if rng.random() < self.rate:
            it2 = self.dataset.get(int(rng.integers(0, len(self.dataset))), rng)
            y2 = self._onehot(it2["target"])
            lam = rng.beta(self.beta, self.beta)
            lam = max(lam, 1.0 - lam)
            x1 = it1["wave"] - it1["wave"].mean()
            x2 = it2["wave"] - it2["wave"].mean()
            x = x1 * lam + x2 * (1.0 - lam)
            it1["wave"] = (x - x.mean()).astype(np.float32)
            it1["target"] = y1 * lam + y2 * (1.0 - lam)
            return it1
        it1["target"] = y1
        return it1


def _split_indices(root, split_csv, files):
    split_files = {r["filename"] for r in _read_tsv(os.path.join(root, split_csv))}
    return [i for i, f in enumerate(files) if f in split_files]


def get_training_set(dataset_dir=None, cache_path=None, resample_rate=32000,
                     roll=False, gain_augment=0, wavmix=False):
    base = DCASE20Dataset(dataset_dir, resample_rate, cache_path)
    idx = _split_indices(base.root, os.path.join("evaluation_setup", "fold1_train.csv"),
                         base.files)
    ds = SelectionDataset(base, idx)
    if roll:
        ds = PreprocessDataset(ds, roll_aug)
    if gain_augment:
        ds = PreprocessDataset(ds, lambda it, rng: gain_aug(it, rng, gain_augment))
    if wavmix:
        ds = OneHotMixupDataset(ds)
    return ds


def get_test_set(dataset_dir=None, cache_path=None, resample_rate=32000):
    base = DCASE20Dataset(dataset_dir, resample_rate, cache_path)
    idx = _split_indices(base.root, os.path.join("evaluation_setup", "fold1_evaluate.csv"),
                         base.files)
    return SelectionDataset(base, idx)
