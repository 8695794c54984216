"""Build and load the port's CUDA kernels at first use.

Each ``csrc/*.cu`` file has a plain ``extern "C"`` interface and is compiled
by ``nvcc`` into its own shared library, loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds. Libraries go to ``build/efficientat_tpu_torch/``
beside the package and are named by a hash of the source, every header of
``csrc/`` (``*.cuh``, which a source may include) and the flags, so a changed
source or header rebuilds. Nothing here runs at import time. Each library
compiled counts ``build.nvcc.<name>`` and each loaded ``build.load.<name>``
(``utils/profiling.COUNTERS``), so a run tells a warm start from one that
compiled.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from efficientat_tpu_torch.utils.profiling import count

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


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` for sm_90a if needed and load it."""
    return load_libraries([name])[name]


def load_libraries(names) -> dict:
    """``load_library`` for each of ``names``: the sources that need a build
    compile side by side, one nvcc each, all started together."""
    with _LOCK:
        builds = {}
        for name in names:
            if name in _LIBS:
                continue
            lib_path = _lib_path(name)
            if lib_path.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            builds[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
        try:
            for name, (tmp, proc) in builds.items():
                _, err = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {CSRC / name}.cu:\n{err}")
                BUILD_LOG[name] = err
                os.replace(tmp, _lib_path(name))
                count(f"build.nvcc.{name}")
        finally:
            for _, proc in builds.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for name in names:
            if name not in _LIBS:
                _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
                count(f"build.load.{name}")
        return {name: _LIBS[name] for name in names}
