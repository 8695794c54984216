"""Host-side audio decode + resample.

Copy of ``efficientat_tpu/data/audio_io.py``, verbatim but for import paths:
the port imports nothing of the JAX package.

The reference decodes with librosa/PyAV/FFmpeg (C libraries) on the host
(inference.py:45, datasets/audioset.py:32-47); decode never runs on the
accelerator. Here:

- WAV: parsed natively (stdlib/scipy fallback; fast C++ path in
  ``native/`` when built — see efficientat_tpu_torch.data.native).
- MP3: first-party C++ MPEG-1/2/2.5 Layer III decoder
  (native/eat_mp3.cpp, verified to ~1e-6 vs libmpg123); falls back to
  the optional ``av`` (PyAV) package when the native library isn't built.
- Resampling: polyphase windowed-sinc (scipy.signal.resample_poly), the
  same class of kernel librosa's default uses. The AudioSet HDF5 datasets'
  "naive" stride-slice decimation (datasets/audioset.py:163-177) is kept
  separately as ``stride_resample`` for training parity.
"""

from __future__ import annotations

import math
import warnings

import numpy as np


def _to_float32(pcm: np.ndarray) -> np.ndarray:
    if pcm.dtype == np.float32:
        return pcm
    if pcm.dtype == np.float64:
        return pcm.astype(np.float32)
    if pcm.dtype == np.int16:
        return (pcm / 32768.0).astype(np.float32)
    if pcm.dtype == np.int32:
        return (pcm / 2147483648.0).astype(np.float32)
    if pcm.dtype == np.uint8:
        return ((pcm.astype(np.float32) - 128.0) / 128.0)
    raise ValueError(f"unsupported PCM dtype {pcm.dtype}")


def resample(wave: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase windowed-sinc resampling (high quality, host CPU).

    Native C++ polyphase when built (scipy-compatible Kaiser design,
    agreement ~2e-7); scipy.signal.resample_poly otherwise.
    """
    if orig_sr == target_sr:
        return wave
    from efficientat_tpu_torch.data import native

    if native.available() and wave.ndim == 1:
        return native.resample(wave, orig_sr, target_sr)
    import scipy.signal

    g = math.gcd(orig_sr, target_sr)
    return scipy.signal.resample_poly(wave, target_sr // g, orig_sr // g).astype(np.float32)


def stride_resample(wave: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """The reference AudioSet pipeline's decimation-without-filtering:
    32k->16k is ``x[::2]``, 32k->8k is ``x[::4]`` (datasets/audioset.py:163-177).
    Kept for bit-faithful training-data parity; aliases by design."""
    if orig_sr == target_sr:
        return wave
    if orig_sr % target_sr != 0:
        raise ValueError(f"stride_resample needs integer ratio, got {orig_sr}->{target_sr}")
    return np.ascontiguousarray(wave[:: orig_sr // target_sr])


def load_wav(path: str):
    """Decode a RIFF WAV file -> (float32 array (channels, samples), sr).

    Prefers the native C++ parser (native/eat_native.cpp) when built; falls
    back to scipy. The native path mono-mixes in C and is GIL-free.
    """
    from efficientat_tpu_torch.data import native

    if native.available():
        wave, sr = native.read_wav(path, mixdown=True)
        return wave[None, :], sr
    import scipy.io.wavfile

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # scipy warns on non-data chunks
        sr, pcm = scipy.io.wavfile.read(path)
    pcm = _to_float32(np.asarray(pcm))
    if pcm.ndim == 1:
        pcm = pcm[None, :]
    else:
        pcm = pcm.T  # (channels, samples)
    return pcm, sr


def decode_mp3(blob: bytes):
    """Decode mp3 bytes -> (float32 (channels, samples), sr).

    Reference surface: datasets/audioset.py:32-47 (PyAV/FFmpeg there).
    Here the first-party C++ decoder (native/eat_mp3.cpp) is the primary
    path — zero Python/FFmpeg dependencies; PyAV is the fallback when the
    native library hasn't been built.
    """
    from efficientat_tpu_torch.data import native

    if native.available():
        return native.decode_mp3(blob)
    try:
        import av
    except ImportError as e:
        raise ImportError(
            "MP3 decoding needs the native library (run `make -C native` "
            "once; zero dependencies) or the optional 'av' (PyAV/FFmpeg) "
            "package."
        ) from e
    import io

    container = av.open(io.BytesIO(blob))
    stream = next(s for s in container.streams if s.type == "audio")
    sr = stream.rate
    chunks = [frame.to_ndarray() for frame in container.decode(stream)]
    pcm = np.concatenate(chunks, axis=-1)
    if pcm.dtype == np.int16:
        pcm = (pcm / 32768.0).astype(np.float32)
    if pcm.ndim == 1:
        pcm = pcm[None, :]
    return pcm.astype(np.float32), sr


def load_waveform(path: str, target_sr: int = 32000, mono: bool = True) -> np.ndarray:
    """Decode an audio file to float32 at ``target_sr``; mono mixes channels.

    Equivalent surface to the reference's ``librosa.core.load(path, sr=sr,
    mono=True)`` (inference.py:45).
    """
    path = str(path)
    if path.lower().endswith(".mp3"):
        with open(path, "rb") as f:
            pcm, sr = decode_mp3(f.read())
    else:
        pcm, sr = load_wav(path)
    if mono:
        pcm = pcm.mean(axis=0)
    else:
        pcm = pcm[0]
    return resample(pcm, sr, target_sr)
