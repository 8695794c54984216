"""AudioSet class labels (527 classes).

Copy of ``efficientat_tpu/utils/labels.py``, verbatim but for import paths:
the port imports nothing of the JAX package.

Parsed lazily from the bundled ``class_labels_indices.csv`` (public AudioSet
metadata, same file the reference ships in metadata/; parsed at import time
there, helpers/utils.py:35-50 — we parse on first access instead).
"""

from __future__ import annotations

import csv
from pathlib import Path

_CSV_PATH = Path(__file__).parent / "class_labels_indices.csv"


def _load():
    with open(_CSV_PATH, "r") as f:
        rows = list(csv.reader(f, delimiter=","))
    ids = [r[1] for r in rows[1:]]
    labels = [r[2] for r in rows[1:]]
    return ids, labels


AUDIOSET_IDS, AUDIOSET_LABELS = _load()
NUM_AUDIOSET_CLASSES = len(AUDIOSET_LABELS)
