"""Build and load the port's CUDA kernels at first use.

Each ``csrc/*.cu`` file has a plain ``extern "C"`` interface and is compiled
by ``nvcc`` into its own shared library, loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds. Libraries go to ``build/efficientat_tpu_torch/``
beside the package and are named by a hash of the source and the flags, so a
changed source rebuilds. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "efficientat_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS = {}
_LOCK = threading.Lock()
# nvcc's stderr (ptxas registers and spills) for each library built here
BUILD_LOG = {}


def nvcc_path() -> str:
    for path in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` for sm_90a if needed and load it."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
        lib_path = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
            BUILD_LOG[name] = proc.stderr
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        _LIBS[name] = lib
        return lib
