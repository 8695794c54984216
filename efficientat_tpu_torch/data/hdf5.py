"""HDF5-backed audio datasets.

Copy of ``efficientat_tpu/data/hdf5.py``, verbatim but for import paths:
the port imports nothing of the JAX package.

The reference stores AudioSet/FSD50K/OpenMIC as HDF5 files holding raw mp3
bytes + packed label bits, decoded per item in DataLoader workers
(datasets/audioset.py:106-177). Two backends here:

- ``MP3Hdf5Dataset``: same on-disk format ('mp3' vlen-uint8, 'target'
  packed bits or float, 'audio_name'); decode via PyAV (optional dep).
- ``PCMHdf5Dataset``: int16 PCM variant ('pcm') — recommended on air-gapped
  or FFmpeg-less hosts; ``convert_mp3_hdf5_to_pcm`` migrates once.

Both keep the reference's lazy-open semantics (file handle opened on first
access *per thread*, audioset.py:127-128,148-149) via threading.local, and
its pad/truncate + stride-decimation resample behavior (:50-55,163-177).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from efficientat_tpu_torch.data.audio_io import stride_resample
from efficientat_tpu_torch.data.core import Dataset


def _unpack_target(raw, num_classes: int) -> np.ndarray:
    raw = np.asarray(raw)
    if raw.dtype == np.uint8 and raw.size * 8 >= num_classes > raw.size:
        return np.unpackbits(raw, axis=-1, count=num_classes).astype(np.float32)
    return raw.astype(np.float32)


def pad_or_truncate(x: np.ndarray, audio_length: Optional[int],
                    rng: Optional[np.random.Generator] = None,
                    random_offset: bool = False) -> np.ndarray:
    """Zero-pad to length, or cut (front cut, or random-offset crop when
    ``random_offset`` — FSD50K's behavior, datasets/fsd50k.py:50-59)."""
    if audio_length is None or len(x) == audio_length:
        return x
    if len(x) < audio_length:
        return np.concatenate(
            [x, np.zeros(audio_length - len(x), dtype=x.dtype)])
    if random_offset and rng is not None:
        off = int(rng.integers(0, len(x) - audio_length + 1))
        return x[off:off + audio_length]
    return x[:audio_length]


class _LazyH5:
    """Per-thread lazy h5py file handle."""

    def __init__(self, path: str):
        self.path = path
        self._local = threading.local()

    @property
    def file(self):
        f = getattr(self._local, "f", None)
        if f is None:
            import h5py

            f = h5py.File(self.path, "r")
            self._local.f = f
        return f

    def dataset(self, key: str):
        """Per-thread cached h5py Dataset: ``file[key]`` builds a fresh
        wrapper object each call (~0.3 ms — as long as the read itself
        for small items), so the hot read path caches it."""
        cache = getattr(self._local, "dsets", None)
        if cache is None:
            cache = self._local.dsets = {}
        d = cache.get(key)
        if d is None:
            d = cache[key] = self.file[key]
        return d


class _BaseHdf5Dataset(Dataset):
    audio_key = None  # set by subclass

    def __init__(self, hdf5_path: str, sample_rate: int = 32000,
                 clip_length_seconds: Optional[float] = 10.0,
                 resample_rate: int = 32000, gain_augment: int = 0,
                 num_classes: Optional[int] = None, random_offset_crop: bool = False,
                 int16_waves: bool = False, wave_codec: Optional[str] = None):
        # wave_codec ("f32" | "i16" | "mulaw8", data/wavecodec.py): how
        # waves transport host->device — i16 halves the bytes (exact for
        # int16 PCM sources), mulaw8 quarters them (lossy ~38 dB SNR);
        # the train step decodes on device (train/loop.py).
        # ``int16_waves=True`` is sugar for wave_codec="i16".
        # Incompatible with host-side float augments (gain).
        from efficientat_tpu_torch.data.wavecodec import CODECS

        if wave_codec is None:
            wave_codec = "i16" if int16_waves else "f32"
        if wave_codec not in CODECS:
            raise ValueError(f"wave_codec={wave_codec!r}: pick one of {CODECS}")
        if wave_codec != "f32" and gain_augment:
            raise ValueError("compressed wave transport (wave_codec="
                             f"{wave_codec!r}) cannot be combined with "
                             "gain_augment (a host-side float augment); "
                             "leave waves float32 for gain-augmented tasks")
        self.wave_codec = wave_codec
        self.int16_waves = wave_codec == "i16"
        self.h5 = _LazyH5(hdf5_path)
        self.sample_rate = sample_rate
        self.resample_rate = resample_rate
        self.clip_samples = (None if clip_length_seconds is None
                             else int(clip_length_seconds * sample_rate))
        self.gain_augment = gain_augment
        self.num_classes = num_classes
        self.random_offset_crop = random_offset_crop
        import h5py

        with h5py.File(hdf5_path, "r") as f:
            self._len = len(f[self.audio_key])

    def __len__(self):
        return self._len

    # -- bulk-cached metadata -------------------------------------------
    # audio_name/target are tiny per item but each h5py __getitem__ costs
    # tens of microseconds of HDF5+Python overhead; one bulk read into
    # process-shared numpy arrays removes 2 of the 3 per-item calls on the
    # hot path. Targets stay in their raw on-disk form (packed uint8 for
    # AudioSet: ~66 B/item) and are unpacked per access; a size guard
    # keeps pathological float targets on disk.
    _META_CACHE_MAX_BYTES = 1 << 30

    def _meta(self):
        meta = getattr(self, "_meta_cache", None)
        if meta is None:
            f = self.h5.file
            names = f["audio_name"][...]
            targets, has_target = None, "target" in f
            if has_target:
                d = f["target"]
                if d.dtype.itemsize * d.size <= self._META_CACHE_MAX_BYTES:
                    targets = d[...]
            meta = self._meta_cache = (names, targets, has_target)
        return meta

    def _decode(self, index: int) -> np.ndarray:
        raise NotImplementedError

    def get(self, index, rng):
        wave = self._decode(index)
        if self.gain_augment:
            gain = int(rng.integers(0, self.gain_augment * 2)) - self.gain_augment
            wave = wave * np.float32(10.0 ** (gain / 20.0))
        wave = pad_or_truncate(wave, self.clip_samples, rng,
                               self.random_offset_crop)
        wave = stride_resample(wave, self.sample_rate, self.resample_rate)
        names, targets, has_target = self._meta()
        name = names[index]
        if isinstance(name, bytes):
            name = name.decode()
        # filename normalization as the reference: strip 'Y' prefix + '.mp3'
        # (audioset.py:151-153) so KD teacher-index lookups match
        if name.endswith(".mp3"):
            name = name[:-4]
        if name.startswith("Y"):
            name = name[1:]
        if targets is not None:
            target = _unpack_target(targets[index], self.num_classes or 0)
        elif has_target:  # over the cache size guard: stay on disk
            target = _unpack_target(self.h5.dataset("target")[index],
                                    self.num_classes or 0)
        else:
            target = None
        from efficientat_tpu_torch.data.wavecodec import encode

        item = {"wave": encode(wave, self.wave_codec), "fname": name}
        if target is not None:
            item["target"] = target
        return item


class MP3Hdf5Dataset(_BaseHdf5Dataset):
    audio_key = "mp3"

    def _decode(self, index):
        from efficientat_tpu_torch.data.audio_io import decode_mp3

        blob = np.asarray(self.h5.dataset("mp3")[index]).tobytes()
        pcm, _sr = decode_mp3(blob)
        return pcm.reshape(-1)


class PCMHdf5Dataset(_BaseHdf5Dataset):
    audio_key = "pcm"

    def _decode(self, index):
        pcm = np.asarray(self.h5.dataset("pcm")[index])
        if pcm.dtype == np.int16:
            if self.wave_codec != "f32":  # encode() takes int16 directly
                return pcm
            return (pcm / 32768.0).astype(np.float32)
        return pcm.astype(np.float32)


def open_audio_hdf5(path: str, **kwargs) -> _BaseHdf5Dataset:
    """Open either storage format by probing the keys."""
    import h5py

    with h5py.File(path, "r") as f:
        has_pcm = "pcm" in f
    cls = PCMHdf5Dataset if has_pcm else MP3Hdf5Dataset
    return cls(path, **kwargs)


def write_pcm_hdf5(path: str, waves, targets, names, sample_rate: int = 32000):
    """Write the PCM HDF5 format (int16 'pcm', float/packed 'target',
    'audio_name'). Used by converters and test fixtures."""
    import h5py

    with h5py.File(path, "w") as f:
        vlen = h5py.special_dtype(vlen=np.dtype("int16"))
        d = f.create_dataset("pcm", (len(waves),), dtype=vlen)
        for i, w in enumerate(waves):
            d[i] = np.clip(np.asarray(w) * 32768.0, -32768, 32767).astype(np.int16)
        f.create_dataset("target", data=np.asarray(targets))
        f.create_dataset("audio_name",
                         data=np.asarray([str(n).encode() for n in names]))
        f.attrs["sample_rate"] = sample_rate


def convert_mp3_hdf5_to_pcm(src: str, dst: str, sample_rate: int = 32000):
    """One-time migration: reference mp3-HDF5 -> int16 PCM HDF5 (decoded
    by the first-party decoder). PCM reads are ~40x faster than decode and
    enable the int16 transport path (`int16_waves`); the files are ~8x
    larger. CLI: ``python -m efficientat_tpu.cli convert-dataset``."""
    import h5py

    from efficientat_tpu_torch.data.audio_io import decode_mp3

    with h5py.File(src, "r") as fin, h5py.File(dst, "w") as fout:
        n = len(fin["mp3"])
        vlen = h5py.special_dtype(vlen=np.dtype("int16"))
        d = fout.create_dataset("pcm", (n,), dtype=vlen)
        for i in range(n):
            pcm, _ = decode_mp3(np.asarray(fin["mp3"][i]).tobytes())
            d[i] = np.clip(pcm.reshape(-1) * 32768.0, -32768, 32767).astype(np.int16)
        for key in ("target", "audio_name"):
            if key in fin:
                fout.create_dataset(key, data=fin[key][...])
        fout.attrs["sample_rate"] = sample_rate
