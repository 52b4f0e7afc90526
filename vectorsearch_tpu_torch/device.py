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


def default_device() -> torch.device:
    """The first CUDA card when one exists, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def resolve(device) -> torch.device:
    """`device` as a torch.device; None picks default_device()."""
    return default_device() if device is None else torch.device(device)


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
    """Upload a numpy array (or tensor) to `device`, optionally cast."""
    if not isinstance(a, torch.Tensor):
        # read-only arrays (e.g. views of JAX buffers) are copied first:
        # torch tensors must be writable
        a = torch.from_numpy(np.require(a, requirements="W"))
    return a.to(device=device, dtype=dtype)


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
