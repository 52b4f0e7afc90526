"""The port's graft entry points (vectorsearch_tpu_torch/graft_entry.py)
against the repository root's __graft_entry__.py, on the CPU
(VSTPU_DEVICE=cpu), at the production bucket rounding on both sides.

- entry(): the same example tensors from the same seed, and the port's
  forward (probe + grouped scan) against JAX's `_ivf_scan` on them: scores
  within the coarse tolerance of ROADMAP queue 3 (2e-3: the bf16 query
  rounding and JAX's bf16-class CPU matmuls), top-10 slots as sets except
  near-ties; and against the port's own plain gather formulation
  (index/ivf._ivf_scan) within 1e-5 (the same exact products, summed in
  another order).
- dryrun_multichip on 1 and 4 CPU shards from default_mesh, and on a Mesh
  of 4 shards built directly, passes every assert of the JAX dryrun and
  prints its OK line.
- importing either new module (graft_entry, client) loads neither jax nor
  anything of the JAX package.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vectorsearch_tpu_torch import graft_entry
from vectorsearch_tpu_torch.index import ivf as port_ivf
from vectorsearch_tpu_torch.parallel import Mesh
from vectorsearch_tpu_torch.quant.layout import PackedVectors

from test_torch_grouped_scan import assert_topk_match

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COARSE, EXACT = 2e-3, 1e-5


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    monkeypatch.setenv("VSTPU_DEVICE", "cpu")
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_entry():
    import __graft_entry__

    return __graft_entry__.entry()


def test_entry_args_equal_jax(jax_entry):
    _, jargs = jax_entry
    _, args = graft_entry.entry()
    assert len(args) == len(jargs) == 8
    assert args[0].device.type == "cpu"
    for got, want in zip(args, jargs):
        want = np.asarray(want)
        got = got.numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(got, want)


def test_forward_matches_jax_ivf_scan(jax_entry):
    jfn, jargs = jax_entry
    fn, args = graft_entry.entry()
    s, g = fn(*args)
    assert s.shape == g.shape == (8, graft_entry.K)
    js, jg = jfn(*jargs)
    assert_topk_match(s.numpy(), g.numpy(), np.asarray(js), np.asarray(jg), atol=COARSE)
    # the same tensors through the plain gather formulation of the port
    ps, pg = port_ivf._ivf_scan(*args[:2], PackedVectors(*args[2:6]), *args[6:],
                                nprobe=graft_entry.NPROBE, k=graft_entry.K)
    assert_topk_match(s.numpy(), g.numpy(), ps.numpy(), pg.numpy(), atol=EXACT)


@pytest.mark.parametrize("shards", ["default_mesh(1)", "default_mesh(4)", "Mesh(cpu x 4)"])
def test_dryrun_multichip_on_cpu_shards(shards, capsys):
    if shards.startswith("Mesh"):
        line = graft_entry.dryrun_multichip(mesh=Mesh(("cpu",) * 4))
        n = 4
    else:
        n = int(shards[-2])
        line = graft_entry.dryrun_multichip(n)
    assert line.startswith(f"dryrun_multichip OK: {n}-device mesh")
    for stage in ("kmeans-iter", "flat", "ivf(global-probe)", "ivf+refine ",
                  "ivf+refine==IVFIndex", "rebuild->sharded-replica", "batched-search"):
        assert stage in line, stage
    assert line in capsys.readouterr().out


def test_main_prints_entry_and_dryrun_lines():
    env = dict(os.environ, PYTHONPATH=ROOT, VSTPU_DEVICE="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "vectorsearch_tpu_torch.graft_entry"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "entry OK: ((8, 10), (8, 10))" in out.stdout
    assert "dryrun_multichip OK: 1-device mesh (cpu)" in out.stdout


def test_new_modules_import_no_jax():
    code = """
import sys
import vectorsearch_tpu_torch.client, vectorsearch_tpu_torch.graft_entry
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "vectorsearch_tpu" or m.startswith("vectorsearch_tpu."))
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
