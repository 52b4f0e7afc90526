"""Build and load the port's CUDA kernels.

`nvcc` compiles every source under vectorsearch_tpu_torch/csrc/ into one
shared library with a plain C interface, loaded with ctypes: one nvcc per
`.cu` file, all started together, then one link. It runs at first use,
never at import: the CPU test host has no nvcc. Output goes to
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
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
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
    nvcc = _nvcc()
    units = [s for s in _sources() if s.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(u)}.o" for u in units]
    procs = [
        subprocess.Popen(
            [nvcc, *FLAGS, "-c", u, "-o", o],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for u, o in zip(units, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    try:
        failed = [(u, p.returncode, log) for u, p, log in zip(units, procs, logs)
                  if p.returncode != 0]
        if not failed:
            link = subprocess.run([nvcc, *FLAGS, "-shared", "-o", tmp, *objs],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                failed = [("link", link.returncode, link.stderr + link.stdout)]
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{os.path.basename(u)} ({rc}):\n{log}" for u, rc, log in failed))
    os.replace(tmp, so)  # atomic: concurrent builders never load a torn file
    return so


def load() -> ctypes.CDLL:
    """The built kernel library, built on first call in this process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(library_path())
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.vs_abi_version.argtypes = []
            lib.vs_abi_version.restype = i32
            if lib.vs_abi_version() != 7:
                raise RuntimeError("kernel library ABI mismatch")
            for name, argtypes in (
                ("vs_grouped_scores", [ptr] * 11 + [i32] * 6 + [ptr]),
                ("vs_kmeans_assign", [ptr] * 7 + [i32] * 3 + [ptr]),
                ("vs_kmeans_accumulate", [ptr] * 9 + [i32] * 5 + [ptr]),
                ("vs_kmeans_accumulate_loads", [ptr] * 7 + [i32] * 2 + [ptr]),
                ("vs_flat_bands_s8", [ptr] * 8 + [i32] * 6 + [ptr]),
                ("vs_flat_bands_bf16", [ptr] * 7 + [i32] * 6 + [ptr]),
            ):
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = i32
            _LIB = lib
        return _LIB


def launch_device(name: str, tensors):
    """The one CUDA device of a kernel wrapper's `tensors`, or None when
    all lie on the CPU (the wrapper then runs its plain version). Tensors
    on another device type, or on several devices, raise: a kernel
    launches or the call fails, never a silent fallback."""
    if all(t.device.type == "cpu" for t in tensors):
        return None
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            f"{name}: tensors must share one CUDA device, got "
            f"{[str(t.device) for t in tensors]}"
        )
    return dev


def check_args(name: str, want: dict) -> None:
    """Raise unless each argument `arg: (tensor, dtype, shape)` has that
    dtype and shape and is contiguous and 16-byte aligned, as the kernels'
    vector loads need."""
    for arg, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: {arg} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}"
            )
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be contiguous and 16-byte aligned")
