"""ctypes bindings for the native host runtime (native/eat_native.cpp).

Copy of ``efficientat_tpu/data/native.py``, verbatim but for import paths:
the port imports nothing of the JAX package.

Build once with ``make -C native`` (or ``python -m efficientat_tpu_torch.data.native
build``). All entry points degrade gracefully to the pure-Python paths in
``audio_io``/``core`` when the shared library is absent.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libeat_native.so")

_lib = None


def build(quiet: bool = True) -> bool:
    """Compile the shared library in-tree. Returns success."""
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR],
                       check=True, capture_output=quiet)
        return True
    except Exception:
        return False


_load_attempted = False
_load_lock = __import__("threading").Lock()


def load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _lib is not None:
        return _lib
    # serialized: loader worker threads race the first load, and a reader
    # that merely saw _load_attempted=True mid-load must not conclude the
    # library is absent (it would silently fall back for the whole process)
    with _load_lock:
        if _lib is not None:
            return _lib
        if _load_attempted:
            return None
        _load_attempted = True
        if not os.path.exists(_SO_PATH) and not build():
            return None  # no toolchain: callers fall back to pure-Python paths
        lib = _bind(ctypes.CDLL(_SO_PATH))
        if lib is None and build():
            # stale library from an older source tree: rebuilt — reload
            lib = _bind(ctypes.CDLL(_SO_PATH))
        _lib = lib
        return lib


def _bind(lib: ctypes.CDLL) -> Optional[ctypes.CDLL]:
    """Declare signatures; None when the .so predates the current API
    (missing symbols) so callers degrade instead of raising."""
    try:
        lib.eat_read_wav.restype = ctypes.c_int
        lib.eat_read_wav.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)]
        lib.eat_resample.restype = ctypes.c_int
        lib.eat_resample.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64)]
        lib.eat_free.argtypes = [ctypes.c_void_p]
        lib.eat_mp3_decode.restype = ctypes.c_int
        lib.eat_mp3_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.eat_pool_create.restype = ctypes.c_void_p
        lib.eat_pool_create.argtypes = [ctypes.c_int]
        lib.eat_pool_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int64]
        lib.eat_pool_next.restype = ctypes.c_int64
        lib.eat_pool_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64)]
        lib.eat_pool_destroy.argtypes = [ctypes.c_void_p]
    except AttributeError:
        return None
    return lib


def available() -> bool:
    return load() is not None


def read_wav(path: str, mixdown: bool = True):
    """(wave float32 (n,), sample_rate) via the native parser."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library not built (run make -C native)")
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    sr = ctypes.c_int()
    rc = lib.eat_read_wav(path.encode(), int(mixdown), ctypes.byref(out),
                          ctypes.byref(n), ctypes.byref(sr))
    if rc != 0:
        raise IOError(f"eat_read_wav({path}) failed with code {rc}")
    wave = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    lib.eat_free(out)
    return wave, sr.value


def resample(wave: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    lib = load()
    if lib is None:
        raise RuntimeError("native library not built (run make -C native)")
    wave = np.ascontiguousarray(wave, dtype=np.float32)
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    rc = lib.eat_resample(wave.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          len(wave), sr_in, sr_out, ctypes.byref(out),
                          ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"eat_resample failed with code {rc}")
    res = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    lib.eat_free(out)
    return res


def decode_mp3(blob: bytes):
    """First-party MPEG-1/2/2.5 Layer III decode (native/eat_mp3.cpp).

    Returns (float32 (channels, samples), sample_rate).
    """
    lib = load()
    if lib is None:
        raise RuntimeError("native library not built (run make -C native)")
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    rc = lib.eat_mp3_decode(blob, len(blob), ctypes.byref(out),
                            ctypes.byref(n), ctypes.byref(sr), ctypes.byref(ch))
    if rc != 0:
        raise ValueError(f"eat_mp3_decode failed with code {rc}")
    pcm = np.ctypeslib.as_array(out, shape=(ch.value, n.value)).copy()
    lib.eat_free(out)
    return pcm, sr.value


class NativePrefetchPool:
    """Threaded native decode+resample pool.

    Submit (id, path) jobs; collect fixed-length float32 clips. Decode and
    resampling run in C++ threads with no GIL involvement.
    """

    def __init__(self, n_threads: int = 4, target_sr: int = 32000,
                 clip_samples: Optional[int] = None):
        lib = load()
        if lib is None:
            raise RuntimeError("native library not built (run make -C native)")
        self._lib = lib
        self._pool = lib.eat_pool_create(n_threads)
        self.target_sr = target_sr
        self.clip_samples = -1 if clip_samples is None else clip_samples

    def submit(self, job_id: int, path: str):
        self._lib.eat_pool_submit(self._pool, job_id, path.encode(),
                                  self.target_sr, self.clip_samples)

    def next(self, max_samples: Optional[int] = None):
        """Blocks; returns (job_id, wave float32)."""
        cap = max_samples or (self.clip_samples if self.clip_samples > 0
                              else 32000 * 60 * 10)
        buf = np.empty(cap, np.float32)
        status = ctypes.c_int()
        n = ctypes.c_int64()
        jid = self._lib.eat_pool_next(
            self._pool, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            cap, ctypes.byref(status), ctypes.byref(n))
        if status.value != 0:
            raise IOError(f"native decode failed (job {jid}, code {status.value})")
        return jid, buf[:n.value].copy()

    def close(self):
        if self._pool:
            self._lib.eat_pool_destroy(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "build":
        ok = build(quiet=False)
        print("built" if ok else "build failed")
