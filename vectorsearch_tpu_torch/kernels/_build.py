"""Build and load the port's CUDA kernels.

`nvcc` compiles every source under vectorsearch_tpu_torch/csrc/ into one
shared library with a plain C interface, loaded with ctypes. It runs at
first use, never at import: the CPU test host has no nvcc. Output goes to
csrc/_build/ (gitignored); the library's file name carries a hash of the
sources and flags, so an edit to any source builds a new library, the way
vectorsearch_tpu/native keys its rebuild on the source hash.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
_OUT = os.path.join(_CSRC, "_build")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
)
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def _sources() -> list[str]:
    return sorted(
        glob.glob(os.path.join(_CSRC, "*.cu"))
        + glob.glob(os.path.join(_CSRC, "*.cuh"))
    )


def _stamp() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path() -> str:
    """Build the library if this source set has not been built; return
    its path."""
    so = os.path.join(_OUT, f"libvstorch_{_stamp()}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_OUT, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *FLAGS, "-o", tmp, *_sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr}{proc.stdout}"
        )
    os.replace(tmp, so)  # atomic: concurrent builders never load a torn file
    return so


def load() -> ctypes.CDLL:
    """The built kernel library, built on first call in this process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(library_path())
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.vs_grouped_scores_abi.argtypes = []
            lib.vs_grouped_scores_abi.restype = i32
            if lib.vs_grouped_scores_abi() != 1:
                raise RuntimeError("kernel library ABI mismatch")
            lib.vs_grouped_scores.argtypes = [ptr] * 9 + [i32] * 6 + [ptr]
            lib.vs_grouped_scores.restype = i32
            _LIB = lib
        return _LIB
