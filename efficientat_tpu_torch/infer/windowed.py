"""Long-form audio tagging in sliding windows (port of
efficientat_tpu/infer/windowed.py; reference surface:
windowed_inference.py:12-124, ``EATagger.tag_audio_window``).

Where the reference runs the model once a window at batch 1, every window
of a file goes through ``Tagger.predict`` as one batch (K1 and the members
once), or in chunks of ``max_batch`` windows. The JAX version pads the last
chunk to one compiled shape; eager PyTorch has no such shape to keep, so
the last chunk runs at its own size.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from efficientat_tpu_torch.infer.tag import Tagger


def window_signal(wave: np.ndarray, window_samples: int, hop_samples: int) -> np.ndarray:
    """Split (T,) into (n_windows, window_samples): the tail zero-padded to
    whole windows, and at least one window (windowed_inference.py:89-96)."""
    n = max(int(np.ceil(max(len(wave) - window_samples, 0) / hop_samples)) + 1, 1)
    padded_len = (n - 1) * hop_samples + window_samples
    wave = np.pad(wave, (0, padded_len - len(wave)))
    idx = np.arange(n)[:, None] * hop_samples + np.arange(window_samples)[None, :]
    return wave[idx]


def tag_audio_window(
    tagger: Tagger,
    audio_path: str,
    window_size: float = 10.0,
    hop_length: float = 2.5,
    top_k: int = 10,
    max_batch: Optional[int] = None,
) -> List[dict]:
    """Tag a long recording in sliding windows of ``window_size`` seconds,
    ``hop_length`` apart. Returns [{"start": s, "end": e, "tags": [(label,
    prob), ...]}, ...] with the ``top_k`` labels of each window.
    ``max_batch`` caps the windows of one ``predict``."""
    from efficientat_tpu_torch.data import load_waveform

    sr = tagger.mel_cfg.sr
    wave = load_waveform(audio_path, target_sr=sr)
    win = int(window_size * sr)
    hop = int(hop_length * sr)
    windows = window_signal(wave, win, hop)  # (N, win)
    step = max_batch or len(windows)
    probs = np.concatenate([tagger.predict(windows[i:i + step])
                            for i in range(0, len(windows), step)])

    results = []
    for i, p in enumerate(probs):
        order = np.argsort(p)[::-1][:top_k]
        results.append({
            "start": i * hop_length,
            "end": i * hop_length + window_size,
            "tags": [(tagger.labels[j], float(p[j])) for j in order],
        })
    return results


class EATagger(Tagger):
    """The reference's ``EATagger`` (windowed_inference.py:12-124): construct
    by model name (or names, for an ensemble), call
    ``tag_audio_window(path, window_size, hop_length)``."""

    def tag_audio_window(self, audio_path: str, window_size: float = 20.0,
                         hop_length: float = 10.0, top_k: int = 10,
                         max_batch: Optional[int] = None) -> List[dict]:
        return tag_audio_window(self, audio_path, window_size, hop_length,
                                top_k, max_batch)
