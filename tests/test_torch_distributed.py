"""The port's multi-process runtime (parallel/distributed.py), run in
subprocesses so that no process group outlives a test: torch.distributed
on `gloo` with the CPU asked for by name (VSTPU_DEVICE=cpu), as
tests/test_distributed.py runs jax.distributed on the CPU.

- one process: the TCP rendezvous, idempotence, a global mesh of 4 CPU
  shards and sharded searches over it;
- two processes of 2 CPU shards each: all_reduce and all_gather see every
  rank's rows, put_sharded keeps the host-global shape, and ShardedFlat,
  ShardedIVF and a sharded Lloyd's searched or run in lockstep give the
  answers of one process driving the same 4 shards;
- importing the entry (`vectorsearch_tpu_torch.__main__`) forms no group
  and touches no card, so a `mesh.coordinator` deployment can still join.
"""
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COMMON = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist
from vectorsearch_tpu_torch.parallel import Mesh, ShardedFlat, ShardedIVF
from vectorsearch_tpu_torch.parallel.distributed import (
    gather_shards, global_mesh, maybe_initialize, put_sharded, sum_shards,
)
from vectorsearch_tpu_torch.quant import layout

torch.set_num_threads(1)
rng = np.random.default_rng(0)
centers = rng.normal(size=(6, 32)).astype(np.float32) * 5
v = (centers[rng.integers(0, 6, 96)] + rng.normal(size=(96, 32))).astype(np.float32)
packed = layout.pack_float(v)
ids = np.arange(1, 97, dtype=np.int64)
"""

ONE = COMMON + r"""
coord = sys.argv[2]
assert maybe_initialize("") is False  # no coordinator: a no-op
assert maybe_initialize(coord, num_processes=1, process_id=0)
assert maybe_initialize(coord) is True  # idempotent
assert dist.get_backend() == "gloo" and dist.get_world_size() == 1

mesh = global_mesh(4)
assert mesh.size == 4 and mesh.group is not None and list(mesh.shard_ids) == [0, 1, 2, 3]
parts = put_sharded(np.arange(8 * 3).reshape(8, 3), mesh)
assert [tuple(p.shape) for p in parts] == [(2, 3)] * 4

s, got = ShardedFlat.build(mesh, packed, ids).search(v[:3], k=5, chunk=16)
assert (got[:, 0] == [1, 2, 3]).all(), got
s, got = ShardedIVF.build(mesh, packed, ids, centers).search(v[:5], k=3, nprobe=2, refine=8)
assert (got[:, 0] == ids[:5]).all(), got
print("DISTRIBUTED_OK", flush=True)
"""

TWO = COMMON + r"""
from vectorsearch_tpu_torch.build import lloyd

pid, coord = int(sys.argv[3]), sys.argv[2]
assert maybe_initialize(coord, num_processes=2, process_id=pid)
assert dist.get_world_size() == 2
mesh = global_mesh(2)
assert mesh.size == 4 and mesh.world == 2 and list(mesh.shard_ids) == [2 * pid, 2 * pid + 1]

# every process passes the SAME host-global array and keeps its own rows
data = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
parts = put_sharded(data, mesh)
assert [tuple(p.shape) for p in parts] == [(2, 4), (2, 4)]
assert np.array_equal(torch.cat(parts).numpy(), data[4 * pid : 4 * pid + 4])
# the collectives see every rank's rows
assert np.array_equal(gather_shards(mesh, parts).reshape(8, 4).numpy(), data)
assert float(sum_shards(mesh, [p.sum() for p in parts])) == data.sum()

# lockstep searches equal one process driving the same 4 shards
alone = Mesh(("cpu",) * 4)
q = v[::7] + 0.01
cases = (
    (lambda m: ShardedFlat.build(m, packed, ids), ({"k": 5},)),
    (lambda m: ShardedIVF.build(m, packed, ids, centers),
     ({"k": 5, "nprobe": 2}, {"k": 4, "nprobe": -1, "refine": 8})),
)
for build, searches in cases:
    ranks, one = build(mesh), build(alone)
    for kw in searches:
        s2, i2 = ranks.search(q, **kw)
        s1, i1 = one.search(q, **kw)
        assert np.array_equal(i2, i1), (kw, i2, i1)
        np.testing.assert_allclose(s2, s1, atol=1e-6)

init = v[:6].copy()
r2 = lloyd(packed, init, max_iters=8, chunk=16, mesh=mesh)
r1 = lloyd(packed, init, max_iters=8, chunk=16, mesh=alone)
assert np.array_equal(r2.assignments, r1.assignments)
assert np.array_equal(r2.counts, r1.counts) and r2.iterations == r1.iterations
np.testing.assert_allclose(r2.centroids, r1.centroids, atol=1e-5)
print("MULTIPROCESS_OK", pid, flush=True)
"""

IMPORT_ORDER = r"""
import sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
import vectorsearch_tpu_torch.__main__  # noqa: F401  (must not touch a device)
assert not dist.is_initialized(), "a process group formed at import"
assert not torch.cuda.is_initialized(), "a card was touched at import"
from vectorsearch_tpu_torch.parallel.distributed import maybe_initialize
assert maybe_initialize(sys.argv[2], num_processes=1, process_id=0)
assert dist.get_world_size() == 1
print("IMPORT_ORDER_OK", flush=True)
"""


def _coordinator():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _env():
    return dict(os.environ, VSTPU_DEVICE="cpu", PYTHONPATH=ROOT)


def _run(script, *args, timeout=120):
    return subprocess.run(
        [sys.executable, "-c", script, ROOT, *args], capture_output=True, text=True,
        timeout=timeout, env=_env(), cwd=ROOT,
    )


def test_initialize_and_sharded_search():
    out = _run(ONE, _coordinator())
    assert "DISTRIBUTED_OK" in out.stdout, (out.stdout, out.stderr[-3000:])


def test_two_process_global_mesh():
    coord = _coordinator()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", TWO, ROOT, coord, str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(), cwd=ROOT,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (out, err) in enumerate(outs):
        assert f"MULTIPROCESS_OK {pid}" in out, (pid, out, err[-3000:])


def test_main_import_leaves_init_process_group_possible():
    out = _run(IMPORT_ORDER, _coordinator())
    assert "IMPORT_ORDER_OK" in out.stdout, (out.stdout, out.stderr[-3000:])
