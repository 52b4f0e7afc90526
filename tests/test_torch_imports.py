"""The port imports neither jax, aiohttp, triton nor anything of the JAX
package, builds nothing at import, and its kernel wrapper runs the plain
version only for CPU tensors."""
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
# Python modules only: native/ builds its libvscodec.so beside itself
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if m.module_finder.find_spec(m.name).origin.endswith(".py")]
for name in names:
    importlib.import_module(name)
from vectorsearch_tpu_torch.kernels import _build
assert _build._LIB is None, "a kernel was built at import"
bad = [m for m in ("jax", "aiohttp", "triton") if m in sys.modules]
assert not bad, bad
jax_pkg = sorted(m for m in sys.modules
                 if m == "vectorsearch_tpu" or m.startswith("vectorsearch_tpu."))
assert not jax_pkg, jax_pkg
# nor the root bench.py / bench_build.py
assert not {"bench", "bench_build"} & set(sys.modules), sys.modules.keys()
print(len(names))
print(" ".join(names))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    count, names = out.stdout.strip().splitlines()[-2:]
    # the 28 modules of the search, build, engine and server slices,
    # parallel/ (4), the port's own copies of the host modules (config,
    # constants, logger, utils.errors, quant/ (3), native, store/ (6),
    # embed/ (7)), the graft entry points (graft_entry), the client SDK
    # (client), the scale checks and their HTTP driver (tools/, 5) and the
    # quickstart (examples/, 2)
    assert int(count) >= 62
    for name in ("tools", "tools.scale_corpus", "tools.bench_10m_serving",
                 "tools.engine_10m_check", "tools.http_driver", "examples",
                 "examples.quickstart"):
        assert f"vectorsearch_tpu_torch.{name}" in names.split()


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
    embedder through the port's host module; they are the port's own
    copies, not the JAX package's objects."""
    from vectorsearch_tpu.embed.noop import NoopAI
    from vectorsearch_tpu.quant import layout
    from vectorsearch_tpu.store import Store
    from vectorsearch_tpu_torch import host
    from vectorsearch_tpu_torch.embed.noop import NoopAI as PortNoopAI
    from vectorsearch_tpu_torch.quant import layout as port_layout
    from vectorsearch_tpu_torch.store import Store as PortStore

    assert (host.NoopAI, host.Store, host.layout) == (PortNoopAI, PortStore, port_layout)
    for ours, theirs in ((host.NoopAI, NoopAI), (host.Store, Store), (host.layout, layout)):
        assert ours is not theirs
        assert getattr(ours, "__module__", ours.__name__).startswith("vectorsearch_tpu_torch.")


def _args(device):
    g, qt, d, kk, cap = 2, 8, 16, 3, 64
    return (
        torch.zeros((g, qt, d), dtype=torch.bfloat16, device=device),
        torch.zeros((g, qt), device=device),
        torch.zeros((g,), dtype=torch.int32, device=device),
        torch.full((kk,), cap, dtype=torch.int32, device=device),
        torch.zeros((kk, cap, d), dtype=torch.int8, device=device),
        *(torch.zeros((kk, cap), device=device) for _ in range(3)),
    )


def _count(device):
    return torch.tensor([2], dtype=torch.int32, device=device)


def test_wrapper_refuses_non_cpu_non_cuda_tensors():
    """Only CPU tensors take the plain version; anything else must be a
    CUDA launch or an error (a meta tensor stands in for a device the
    kernel does not run on)."""
    before = grouped_scan.LAUNCHES
    with pytest.raises(ValueError):
        grouped_scan.grouped_scores(*_args("meta"), 64, False, _count("meta"))
    out, bmax = grouped_scan.grouped_scores(*_args("cpu"), 64, True, _count("cpu"))
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

