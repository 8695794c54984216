"""Knowledge-distillation teacher store.

Reference: ex_audioset.py:104-118,162-180 — a .npy of PaSST-ensemble logits
(one row per training clip), sharpened by ``sigmoid(logits / T)`` at load,
and a pickled filename->row-index dict; clips without teacher predictions
get index -1 and a zeroed distillation loss.
"""

from __future__ import annotations

import os
import pickle
from typing import Sequence, Tuple

import numpy as np

# Published PaSST-ensemble teacher assets (reference ex_audioset.py:24-27);
# download both into resources/ to reproduce the reference KD training.
PREDS_URL = ("https://github.com/fschmid56/EfficientAT/releases/download/"
             "v0.0.1/passt_enemble_logits_mAP_495.npy")
FNAME_TO_INDEX_URL = ("https://github.com/fschmid56/EfficientAT/releases/"
                      "download/v0.0.1/fname_to_index.pkl")


class TeacherStore:
    def __init__(self, preds_path: str, fname_to_index_path: str,
                 temperature: float = 1.0):
        if not os.path.isfile(preds_path):
            raise FileNotFoundError(
                f"teacher predictions not found: {preds_path} "
                f"(download {PREDS_URL})")
        logits = np.load(preds_path)
        self.preds = (1.0 / (1.0 + np.exp(-logits / temperature))).astype(np.float32)
        with open(fname_to_index_path, "rb") as f:
            self.fname_to_index = pickle.load(f)
        self.num_classes = self.preds.shape[1]

    def lookup(self, fnames: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """(teacher probs (B, C), valid (B,)) — invalid rows are zeros."""
        idx = np.asarray([self.fname_to_index.get(f, -1) for f in fnames])
        valid = (idx >= 0).astype(np.float32)
        rows = self.preds[np.maximum(idx, 0)]
        rows = rows * valid[:, None]
        return rows, valid


class SyntheticTeacherStore:
    """Teacher stand-in for smoke tests: deterministic pseudo-probs."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes

    def lookup(self, fnames):
        import zlib

        b = len(fnames)
        # zlib.crc32 is a stable digest; Python's str hash is salted per
        # process, which would make synthetic-KD runs non-reproducible.
        seed = zlib.crc32("\x00".join(str(f) for f in fnames).encode())
        rng = np.random.default_rng(seed)
        return (rng.random((b, self.num_classes)).astype(np.float32),
                np.ones((b,), np.float32))
