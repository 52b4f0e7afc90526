"""Device selection, memory budget and host conversion for the port.

The JAX package reads its accelerator through `jax.devices()` and sizes
the index budget from `memory_stats()` or a table of TPU generations
(vectorsearch_tpu/engine/engine.py `_device_hbm_budget`). Here the card
reports its own memory, so the table is gone.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .quant.layout import PackedVectors

# the caller's ask for a device: `cpu`, `cuda` or `cuda:N`. The port's
# counterpart of the JAX_PLATFORMS=cpu that the JAX entry is driven with
DEVICE_ENV = "VSTPU_DEVICE"

NO_DEVICE = (
    "no CUDA card and no {env}: vectorsearch_tpu_torch runs on an NVIDIA "
    "GPU; pass a device, or set {env}=cpu to run on the CPU"
).format(env=DEVICE_ENV)


class NoDeviceError(RuntimeError):
    """No device was named, none was asked for in the environment, and
    there is no CUDA card to take."""


def resolve(device) -> torch.device:
    """`device` as a torch.device. None takes the caller's ask in the
    environment (VSTPU_DEVICE), else the first CUDA card; with neither it
    raises NoDeviceError. The CPU is used only when asked for by name: a
    missing card never turns into a silent CPU run."""
    if device is None:
        device = os.environ.get(DEVICE_ENV)
        if not device:
            if not torch.cuda.is_available():
                raise NoDeviceError(NO_DEVICE)
            device = "cuda"
    return torch.device(device)


def hbm_budget(device) -> int | None:
    """Bytes of device memory the packed indexes may occupy: 85% of the
    card's total, leaving room for scan transients (score grids, refine
    gathers, batcher inputs). VSTPU_HBM_BUDGET_GB overrides. None on the
    CPU: no cap."""
    env = os.environ.get("VSTPU_HBM_BUDGET_GB")
    if env:
        return int(float(env) * 2**30)
    device = resolve(device)
    if device.type != "cuda":
        return None
    _free, total = torch.cuda.mem_get_info(device)
    return int(total * 0.85)


def to_host(t) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array. `np.asarray`
    raises on a CUDA tensor, so every device read goes through here."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def to_device(a, device, dtype=None) -> torch.Tensor:
    """Upload a numpy array (or tensor) to `device`, optionally cast. An
    array always becomes a tensor of its own memory: on the CPU `.to`
    would hand back a view of the caller's array, whose storage can be
    neither resized (IVFIndex.release_device) nor freed by the index."""
    if not isinstance(a, torch.Tensor):
        # read-only arrays (e.g. views of JAX buffers) are copied first:
        # torch tensors must be writable
        a = torch.from_numpy(np.require(a, requirements="W"))
        return a.to(device=device, dtype=dtype, copy=True)
    return a.to(device=device, dtype=dtype)


def read_back(*tensors) -> list[np.ndarray]:
    """Device tensors as numpy arrays after one wait on the card: each is
    queued as a copy into a pinned host tensor of its own, then one event
    after the copies is waited for. The arrays are copies in ordinary
    memory, so the pinned tensors go back to PyTorch's cache at once,
    however long the caller keeps the answers. The caller counts the wait.
    CPU tensors are returned as to_host returns them."""
    if not any(t.is_cuda for t in tensors):
        return [to_host(t) for t in tensors]
    out = []
    for t in tensors:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        out.append(host)
    for dev in {t.device for t in tensors if t.is_cuda}:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        done.synchronize()
    return [h.numpy().copy() for h in out]


# the device dtypes of packed rows' fields: int8 codes, f32 scale / offset /
# inv_norm
PACKED_DTYPES = (torch.int8, torch.float32, torch.float32, torch.float32)


def upload_packed(packed: PackedVectors, device) -> PackedVectors:
    """Packed rows (host arrays or tensors) on `device` in PACKED_DTYPES."""
    return PackedVectors(
        *[to_device(a, device, dt) for a, dt in zip(packed, PACKED_DTYPES)]
    )


def pin_exact_f32() -> None:
    """Full-f32 matrix products on the card: TF32 off. The counterpart of
    JAX's `Precision.HIGHEST` (and of `preferred_element_type=f32` on bf16
    operands: the port widens bf16 and int8 operands to f32 first, so
    every product it runs is an f32 matmul and this one flag decides).
    PyTorch's default already says so. Set once, process-wide, when the
    package is imported: a flag saved and restored around each call would
    race between the engine's search threads."""
    torch.backends.cuda.matmul.allow_tf32 = False


def check_exact_f32(t: torch.Tensor) -> None:
    """Raise if products on `t`'s device would run in TF32 (the caller
    turned it back on after importing the package). A no-op on the CPU,
    where the flag does not apply."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "vectorsearch_tpu_torch needs full-f32 matmuls: "
            "torch.backends.cuda.matmul.allow_tf32 must stay False"
        )
