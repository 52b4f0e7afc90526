"""The port imports neither jax, aiohttp nor triton, builds nothing at
import, and its kernel wrapper runs the plain version only for CPU
tensors."""
import os
import subprocess
import sys

import pytest
import torch

from vectorsearch_tpu_torch.kernels import flat, grouped_scan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax_and_builds_nothing():
    code = """
import importlib, pkgutil, sys
import vectorsearch_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from vectorsearch_tpu_torch.kernels import _build
assert _build._LIB is None, "a kernel was built at import"
bad = [m for m in ("jax", "aiohttp", "triton") if m in sys.modules]
assert not bad, bad
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    # api/ (4), utils/ (2) and __main__ joined the 21 modules of the search,
    # build and engine slices
    assert int(out.stdout.strip().splitlines()[-1]) >= 28


def test_package_pins_full_f32_products(monkeypatch):
    """Importing the package turns TF32 off once; a CUDA tensor refuses
    to run its products after a caller turns it back on, a CPU tensor is
    not affected (an object with is_cuda set stands in for a CUDA tensor
    on a machine without a card)."""
    from types import SimpleNamespace

    from vectorsearch_tpu_torch.device import check_exact_f32

    assert torch.backends.cuda.matmul.allow_tf32 is False
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        check_exact_f32(SimpleNamespace(is_cuda=True))
    check_exact_f32(torch.zeros(1))


def test_host_reexports_the_shared_modules():
    """chip_smoke.py and other callers reach the codec, store and noop
    embedder through the port; they are the JAX package's own objects."""
    from vectorsearch_tpu.embed.noop import NoopAI
    from vectorsearch_tpu.quant import layout
    from vectorsearch_tpu.store import Store
    from vectorsearch_tpu_torch import host

    assert (host.NoopAI, host.Store, host.layout) == (NoopAI, Store, layout)


def _args(device):
    g, qt, d, kk, cap = 2, 8, 16, 3, 64
    return (
        torch.zeros((g, qt, d), dtype=torch.bfloat16, device=device),
        torch.zeros((g, qt), device=device),
        torch.zeros((g,), dtype=torch.int32, device=device),
        torch.zeros((kk, cap, d), dtype=torch.int8, device=device),
        *(torch.zeros((kk, cap), device=device) for _ in range(3)),
    )


def test_wrapper_refuses_non_cpu_non_cuda_tensors():
    """Only CPU tensors take the plain version; anything else must be a
    CUDA launch or an error (a meta tensor stands in for a device the
    kernel does not run on)."""
    before = grouped_scan.LAUNCHES
    with pytest.raises(ValueError):
        grouped_scan.grouped_scores(*_args("meta"), 64, False)
    out, bmax = grouped_scan.grouped_scores(*_args("cpu"), 64, True)
    assert out.shape == (2, 8, 64) and bmax.shape == (2, 8, 1)
    assert grouped_scan.LAUNCHES == before


def _flat_args(device, b=3, n=1500, d=16):
    corpus = (torch.zeros((n, d), dtype=torch.int8, device=device),
              *(torch.zeros((n,), device=device) for _ in range(3)))
    qsum = torch.zeros((b,), device=device)
    s8 = (torch.zeros((b, d), dtype=torch.int8, device=device), torch.ones((b,), device=device),
          qsum, *corpus)
    return s8, (torch.zeros((b, d), dtype=torch.bfloat16, device=device), qsum, *corpus)


def test_flat_wrappers_refuse_non_cpu_non_cuda_tensors():
    before = (flat.S8_LAUNCHES, flat.BF16_LAUNCHES)
    s8, bf16 = _flat_args("meta")
    with pytest.raises(ValueError, match="CUDA device"):
        flat.flat_bands_s8(*s8)
    with pytest.raises(ValueError, match="CUDA device"):
        flat.flat_bands_bf16(*bf16)
    s8, bf16 = _flat_args("cpu")
    assert flat.flat_bands_s8(*s8).shape == (3, 2 * 128)
    assert flat.flat_bands_bf16(*bf16).shape == (3, 2 * 128)
    assert (flat.S8_LAUNCHES, flat.BF16_LAUNCHES) == before

