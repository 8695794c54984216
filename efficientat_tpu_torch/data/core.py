"""Host data pipeline core: datasets, augmentation wrappers, sampler, loader.

Copy of ``efficientat_tpu/data/core.py``, verbatim but for import paths:
the port imports nothing of the JAX package.

Reference equivalents: datasets/helpers/audiodatasets.py (PreprocessDataset,
roll, gain), datasets/audioset.py:66-103 (wav mixup, AddIndex),
datasets/audioset.py:180-214 (class-balanced weighted sampler),
helpers/init.py (per-worker RNG seeding), torch DataLoader (num_workers=12).

TPU-first redesign:
- RNG is explicit: every item access receives a numpy Generator derived from
  (base_seed, epoch, index) via SeedSequence — deterministic, order
  independent, and safe under any thread count (the reference relies on
  torch's implicit global RNG plus worker_init_fn reseeding).
- The loader is a thread-pool prefetcher producing fixed-shape numpy batches
  (decode releases the GIL inside h5py/numpy); batches are ready for
  jax.device_put, overlapping host decode with device compute.
- Weighted sampling without replacement uses the Gumbel-top-k trick
  (Efraimidis-Spirakis order sampling) — O(N log k) for 100k draws out of
  2M, no sequential rejection loop.
"""

from __future__ import annotations

import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


class Dataset:
    """Map-style dataset: __len__ + get(index, rng) -> dict."""

    def __len__(self):  # pragma: no cover - interface
        raise NotImplementedError

    def get(self, index: int, rng: np.random.Generator) -> Dict[str, Any]:
        raise NotImplementedError


class ConcatDataset(Dataset):
    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def get(self, index, rng):
        di = int(np.searchsorted(self._offsets, index, side="right")) - 1
        return self.datasets[di].get(index - int(self._offsets[di]), rng)


class PreprocessDataset(Dataset):
    """Apply fn(item, rng) -> item on the fly (audiodatasets.py:7-23)."""

    def __init__(self, dataset: Dataset, fn: Callable):
        self.dataset = dataset
        self.fn = fn

    def __len__(self):
        return len(self.dataset)

    def get(self, index, rng):
        return self.fn(self.dataset.get(index, rng), rng)


def roll_aug(item: Dict[str, Any], rng: np.random.Generator,
             shift_range: int = 4000) -> Dict[str, Any]:
    """Random circular shift of the waveform by U[-range, range] samples
    (audiodatasets.py:26-38)."""
    shift = int(rng.integers(-shift_range, shift_range + 1))
    item = dict(item)
    item["wave"] = np.roll(item["wave"], shift, axis=-1)
    return item


def gain_aug(item: Dict[str, Any], rng: np.random.Generator,
             gain_augment: int = 12) -> Dict[str, Any]:
    """Random gain of U{-g..g-1} dB (audiodatasets.py:41-51 /
    datasets/audioset.py:58-63)."""
    gain = int(rng.integers(0, gain_augment * 2)) - gain_augment
    item = dict(item)
    item["wave"] = item["wave"] * np.float32(10.0 ** (gain / 20.0))
    return item


class MixupDataset(Dataset):
    """Waveform-level mixup: with prob ``rate`` mix with a random second
    clip using Beta(beta, beta), mean-centering both (audioset.py:66-91).
    ``mask_aware=True`` implements OpenMIC's variant: zero unobserved label
    probs before mixing and OR the observed masks (openmic.py:64-98)."""

    def __init__(self, dataset: Dataset, beta: float = 2.0, rate: float = 0.5,
                 mask_aware: bool = False, n_labels: int = 20):
        self.dataset = dataset
        self.beta = beta
        self.rate = rate
        self.mask_aware = mask_aware
        self.n_labels = n_labels

    def __len__(self):
        return len(self.dataset)

    def get(self, index, rng):
        it1 = self.dataset.get(index, rng)
        if rng.random() >= self.rate:
            return it1
        idx2 = int(rng.integers(0, len(self.dataset)))
        it2 = self.dataset.get(idx2, rng)
        lam = rng.beta(self.beta, self.beta)
        lam = max(lam, 1.0 - lam)
        x1 = it1["wave"] - it1["wave"].mean()
        x2 = it2["wave"] - it2["wave"].mean()
        x = x1 * lam + x2 * (1.0 - lam)
        x = x - x.mean()
        y1 = np.asarray(it1["target"], np.float32).copy()
        y2 = np.asarray(it2["target"], np.float32).copy()
        if self.mask_aware:
            n = self.n_labels
            m1 = (y1[n:] > 0.5).astype(np.float32)
            m2 = (y2[n:] > 0.5).astype(np.float32)
            y1[:n] *= m1
            y2[:n] *= m2
            y = y1 * lam + y2 * (1.0 - lam)
            y[n:] = np.maximum(m1, m2)
        else:
            y = y1 * lam + y2 * (1.0 - lam)
        out = dict(it1)
        out["wave"] = x.astype(np.float32)
        out["target"] = y
        return out


def balanced_sample_weights(targets: np.ndarray, offset: float = 100.0,
                            weight_sum: bool = True) -> np.ndarray:
    """Per-sample class-balancing weights (audioset.py:185-214):
    per-class weight 1000/(offset + freq); per-sample sum (or max) over its
    labels."""
    targets = np.asarray(targets, np.float32)
    per_class = 1000.0 / (offset + targets.sum(axis=0, keepdims=True))
    w = targets * per_class
    return w.sum(axis=1) if weight_sum else w.max(axis=1)


def weighted_sample_without_replacement(weights: np.ndarray, k: int,
                                        rng: np.random.Generator) -> np.ndarray:
    """k indices ~ weighted sampling w/o replacement via Gumbel top-k."""
    w = np.asarray(weights, np.float64)
    logw = np.where(w > 0, np.log(np.maximum(w, 1e-30)), -np.inf)
    keys = logw + rng.gumbel(size=len(w))
    return np.argpartition(-keys, k - 1)[:k]


class WeightedEpochSampler:
    """Reference ``get_ft_weighted_sampler`` semantics (audioset.py:180-183):
    ``epoch_len`` draws per epoch, weighted, without replacement by default."""

    def __init__(self, weights: np.ndarray, epoch_len: int = 100_000,
                 replacement: bool = False, seed: int = 0):
        self.weights = np.asarray(weights, np.float64)
        self.epoch_len = epoch_len
        self.replacement = replacement
        self.seed = seed

    def indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
        if self.replacement:
            p = self.weights / self.weights.sum()
            return rng.choice(len(self.weights), size=self.epoch_len, p=p)
        return weighted_sample_without_replacement(self.weights, self.epoch_len, rng)


class SequentialSampler:
    def __init__(self, n: int, shuffle: bool = False, seed: int = 0):
        self.n, self.shuffle, self.seed = n, shuffle, seed

    def indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(self.n)
        if self.shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
            rng.shuffle(idx)
        return idx


def _reflect_index(j: int, m: int) -> int:
    """Index into a length-m signal under numpy 'reflect' extension."""
    if m == 1:
        return 0
    period = 2 * (m - 1)
    j = j % period
    return j if j < m else period - j


def exact_eval_pad(wave: np.ndarray, target_len: int,
                   preemph: float = 0.97) -> np.ndarray:
    """Pad ``wave`` to ``target_len`` so the padded clip's log-mel frames
    [0, num_frames(len(wave))) are IDENTICAL to the unpadded clip's.

    The mel front-end pre-emphasizes (y[i] = w[i+1] - c*w[i], length L-1)
    and then reflect-pads y by n_fft//2 for centered framing
    (ops/melspec.py). A zero pad changes y near the boundary, perturbing the
    last ~n_fft/hop frames. Instead the first 513 pad samples solve the
    recurrence  w[L+k] = y[reflect(L-1+k)] + c*w[L+k-1]  so that the
    pre-emphasized padded signal continues exactly as the reflect extension
    of the unpadded y. Frames past the valid count are zeroed on device by
    the model's time masking, so their content never matters.
    """
    w = np.asarray(wave, np.float64)
    length = w.size
    out = np.zeros(target_len, np.float64)
    out[:length] = w
    m = length - 1  # pre-emphasized length
    n_ext = min(513, target_len - length)
    if n_ext > 0 and m >= 2:
        y = w[1:] - preemph * w[:-1]
        prev = w[length - 1]
        for k in range(n_ext):
            cur = y[_reflect_index(m + k, m)] + preemph * prev
            out[length + k] = cur
            prev = cur
    return out.astype(np.float32)


def bucket_pad_collate(bucket_samples: int = 32000):
    """Collate for variable-length waveforms: pad every clip in the batch to
    the batch max rounded up to a multiple of ``bucket_samples`` (limits the
    number of distinct compiled shapes), and emit ``wave_samples`` with the
    true lengths for masked pooling. Uses ``exact_eval_pad`` so the valid
    mel frames are bit-identical to an unpadded forward."""

    def collate(items):
        items = [dict(it) for it in items]
        lens = np.asarray([len(it["wave"]) for it in items], np.int32)
        target = int(-(-lens.max() // bucket_samples) * bucket_samples)
        if any(0 < target - n < 513 for n in lens):
            # leave room for the 513-sample exact pad continuation
            target += bucket_samples
        for it in items:
            it["wave"] = exact_eval_pad(np.asarray(it["wave"], np.float32), target)
        out = _collate(items)
        out["wave_samples"] = lens
        return out

    return collate


def _collate(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], str):
            out[key] = vals  # strings (fnames) stay a list
        elif isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]):
            out[key] = np.stack([np.asarray(v) for v in vals])
        else:
            out[key] = vals
    return out


# smallest per-task item slice worth the submission overhead
_MIN_SLICE = 4


class Loader:
    """Threaded prefetching batch loader.

    Produces dict batches with stacked numpy arrays; per-item RNG derives
    from (seed, epoch, index) so results are independent of thread timing.
    """

    def __init__(self, dataset: Dataset, batch_size: int, sampler=None,
                 num_threads: Optional[int] = None, drop_last: bool = False,
                 seed: int = 0, prefetch: int = 4, collate_fn=None):
        # batch pipelines allocate large fresh buffers every step; on
        # lazily-backed VM RAM a THP first-touch costs ~90x (utils/host.py)
        from efficientat_tpu_torch.utils.host import disable_thp_first_touch

        disable_thp_first_touch()
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or SequentialSampler(len(dataset))
        if num_threads is None:
            # decode is CPU-bound (GIL released in h5py/numpy/native decode):
            # more threads than cores only adds GIL/scheduler contention —
            # measured 2-4x WORSE on a 1-core host (16 -> 45 clips/s going
            # 4 threads -> 1). One thread still overlaps decode with the
            # consumer's device dispatch.
            import os
            num_threads = min(8, os.cpu_count() or 1)
        self.num_threads = num_threads
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.collate_fn = collate_fn or _collate

    def __len__(self):
        n = len(self.sampler.indices(0))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int = 0):
        """Iterate batches for one epoch (a generator)."""
        indices = self.sampler.indices(epoch)
        if self.drop_last:
            indices = indices[: len(indices) // self.batch_size * self.batch_size]
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]

        def fetch_slice(ids):
            items = []
            for idx in ids:
                rng = np.random.default_rng(
                    np.random.SeedSequence([self.seed, epoch, int(idx)]))
                items.append(self.dataset.get(int(idx), rng))
            return items

        # Each batch is split into up to ``num_threads`` slices submitted
        # as independent pool tasks (flat, never nested — nesting can
        # deadlock a bounded pool), so a single batch's decode fans out
        # across every core instead of running serially in one worker:
        # batch latency drops ~num_threads x on multi-core hosts. Item
        # RNG is keyed by (seed, epoch, index), so the split cannot
        # change results.
        n_slices = max(1, min(self.num_threads,
                              -(-self.batch_size // _MIN_SLICE)))

        def submit_batch(ids):
            step = -(-len(ids) // n_slices)
            return [pool.submit(fetch_slice, ids[i:i + step])
                    for i in range(0, len(ids), step)]

        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            futures = queue.Queue()
            it = iter(batches)

            def submit_next():
                try:
                    futures.put(submit_batch(next(it)))
                    return True
                except StopIteration:
                    return False

            for _ in range(min(self.prefetch, len(batches))):
                submit_next()
            produced = 0
            while produced < len(batches):
                futs = futures.get()
                submit_next()  # keep the pipeline full before blocking
                items = [item for f in futs for item in f.result()]
                yield self.collate_fn(items)
                produced += 1
