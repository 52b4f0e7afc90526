"""ctypes loader for the native host codec (codec.cpp).

Builds lazily with the in-image toolchain on first use if the shared
library is missing (g++ is baked into the image; no pip packages needed):
with OpenMP, and where that build fails (a compiler without libgomp) once
more without it, which gives the same bytes on one thread. Falls back to
the numpy implementations when no build succeeds —
`vectorsearch_tpu_torch.quant.codec` consults `lib()` per call, and
`build_kind()` says which of the three a process uses.

Several processes may load it at once (test workers, a server and its
child processes): the build runs under an exclusive `flock` of the
Makefile, which every checkout has, so one process builds while the others
wait and then load its result; the library is linked under a temporary
name and installed by `os.replace`, so no process ever maps a partly
written file.

Set VSTPU_NO_NATIVE=1 to force the numpy path (used by parity tests).
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(__file__)
_SO = os.path.join(_DIR, "libvscodec.so")
_STAMP = os.path.join(_DIR, ".build_stamp")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_KIND: str | None = None  # the loaded library's build: "openmp" or "serial"
_TRIED = False
# the builds to try, in order: (kind, make's variable overrides)
_BUILDS = (("openmp", ()), ("serial", ("OPENMP=",)))


def _expected_stamp() -> str:
    """Hash of the source and Makefile + the host CPU identity.

    The .so is built -march=native: a VM restart can land the persisted
    binary on a different host CPU, where loading it risks SIGILL (same
    pathology as the stale XLA:CPU AOT cache — see CLAUDE.md). Keying the
    stamp on /proc/cpuinfo's model+flags forces a rebuild in that case,
    and hashing codec.cpp and the Makefile forces one when the source or
    the flags change.
    """
    h = hashlib.sha256()
    for name in ("codec.cpp", "Makefile"):
        try:
            with open(os.path.join(_DIR, name), "rb") as f:
                h.update(f.read())
        except OSError:
            pass
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"model name", b"flags")):
                    h.update(line)
                    break  # first core is enough
    except OSError:
        pass
    return h.hexdigest()


@contextlib.contextmanager
def _build_lock():
    """Exclusive across processes: an flock of the Makefile."""
    with open(os.path.join(_DIR, "Makefile"), "rb") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _build() -> str | None:
    """Link the library under a temporary name, the OpenMP build first and
    the serial one where that fails, then install it by os.replace and
    write its stamp (the hash and the build's kind). Returns the kind, or
    None if no build succeeded. The caller holds _build_lock()."""
    tmp = os.path.join(_DIR, f"libvscodec.{os.getpid()}.so.tmp")
    for kind, overrides in _BUILDS:
        try:
            subprocess.run(
                ["make", "-C", _DIR, "-s", "-B", f"OUT={os.path.basename(tmp)}",
                 *overrides],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, _SO)
            with open(_STAMP, "w") as f:
                f.write(f"{_expected_stamp()} {kind}")
            return kind
        except (OSError, subprocess.SubprocessError):
            with contextlib.suppress(OSError):
                os.unlink(tmp)
    return None


def _stamp_kind() -> str | None:
    """The installed library's build kind if its stamp matches this
    source and host, else None."""
    try:
        with open(_STAMP) as f:
            digest, _, kind = f.read().strip().partition(" ")
    except OSError:
        return None
    return kind if digest == _expected_stamp() and kind in dict(_BUILDS) else None


def lib() -> ctypes.CDLL | None:
    """The loaded native library, or None (numpy fallback)."""
    global _LIB, _KIND, _TRIED
    if os.environ.get("VSTPU_NO_NATIVE") == "1":
        return None
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            with _build_lock():
                # another process may have built it while this one waited
                kind = _stamp_kind() if os.path.exists(_SO) else None
                kind = kind or _build()
                if kind is None:
                    return None
                cdll = ctypes.CDLL(_SO)
        except OSError:
            return None
        i64 = ctypes.c_int64
        p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        p_i8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        cdll.vs_quantize_f32.argtypes = [p_f32, i64, i64, p_u8]
        cdll.vs_dequantize_f32.argtypes = [p_u8, i64, i64, p_f32]
        cdll.vs_pack_wire.argtypes = [p_u8, i64, i64, p_i8, p_f32, p_f32, p_f32]
        cdll.vs_abi_version.restype = ctypes.c_int
        if cdll.vs_abi_version() != 1:
            return None
        _LIB, _KIND = cdll, kind
        return _LIB


def build_kind() -> str:
    """Which codec this process uses: "openmp" or "serial" (the native
    library's build), or "numpy" (no library, or VSTPU_NO_NATIVE=1)."""
    return "numpy" if lib() is None else _KIND


def quantize_f32(v: np.ndarray) -> np.ndarray | None:
    l = lib()
    if l is None or v.dtype != np.float32 or v.ndim != 2:
        return None
    v = np.ascontiguousarray(v)
    n, d = v.shape
    out = np.empty((n, 8 + d), np.uint8)
    l.vs_quantize_f32(v, n, d, out)
    return out


def dequantize_f32(wire: np.ndarray) -> np.ndarray | None:
    l = lib()
    if l is None or wire.dtype != np.uint8 or wire.ndim != 2:
        return None
    wire = np.ascontiguousarray(wire)
    n, stride = wire.shape
    d = stride - 8
    out = np.empty((n, d), np.float32)
    l.vs_dequantize_f32(wire, n, d, out)
    return out


def pack_wire(wire: np.ndarray):
    """Returns (codes, scale, offset, inv_norm) or None."""
    l = lib()
    if l is None or wire.dtype != np.uint8 or wire.ndim != 2:
        return None
    wire = np.ascontiguousarray(wire)
    n, stride = wire.shape
    d = stride - 8
    codes = np.empty((n, d), np.int8)
    scale = np.empty(n, np.float32)
    offset = np.empty(n, np.float32)
    inv_norm = np.empty(n, np.float32)
    l.vs_pack_wire(wire, n, d, codes, scale, offset, inv_norm)
    return codes, scale, offset, inv_norm
