"""Graft entry points (counterpart of the repository root's __graft_entry__.py).

entry()             -> (forward, example_args): the serving step, the IVF
                       probe + grouped bucket scan at nprobe=2, k=10, and
                       its example tensors.
dryrun_multichip(n) -> one step of the whole sharded pipeline on a mesh of
                       n shards, on tiny shapes: a sharded Lloyd's pass,
                       ShardedFlat, ShardedIVF without and with refine (held
                       against the single-device IVFIndex), and an Engine
                       whose rebuild installs a sharded replica that serves
                       concurrent searches through the batcher.

Both take the device rule of every entry point (device.resolve(None)): the
CUDA card, or the CPU where VSTPU_DEVICE=cpu asks for it.

    python -m vectorsearch_tpu_torch.graft_entry                  # the card
    VSTPU_DEVICE=cpu python -m vectorsearch_tpu_torch.graft_entry  # the CPU

The JAX forward is the XLA gather formulation (index/ivf.py `_ivf_scan`
here too, where it stays the plain reference); this one is the grouped scan
the search path runs, which launches the scan kernel on a CUDA tensor. It
is a plain function of tensors, not wrapped in torch.compile.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .device import resolve, to_device
from .index import IVFIndex
from .kernels.grouped_scan import ivf_scan_grouped
from .quant import layout
from .quant.layout import PackedVectors

NPROBE, K = 2, 10
# the sharded refined search against IVFIndex.search's on the same rows
SINGLE_ATOL = 2e-3


def _example_ivf(dim=128, k_clusters=8, n=512, seed=0):
    """The same rows from the same seed as __graft_entry__._example_ivf,
    built into the port's IVFIndex on the resolved device."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k_clusters, dim)).astype(np.float32) * 4
    pts = (
        centers[:, None, :] + rng.normal(size=(k_clusters, n // k_clusters, dim))
    ).astype(np.float32)
    v = pts.reshape(-1, dim)
    packed = layout.pack_float(v)
    ids = np.arange(1, len(v) + 1, dtype=np.int64)
    return IVFIndex.build(packed, ids, centers, device=resolve(None)), v


def forward(queries, centroids_n, codes, scale, offset, inv_norm, counts, mask):
    """Probe + grouped scan: (scores f32 [B, k], cluster * cap + slot)."""
    buckets = PackedVectors(codes, scale, offset, inv_norm)
    return ivf_scan_grouped(
        queries, centroids_n, buckets, counts, mask, nprobe=NPROBE, k=K
    )


def entry():
    """The serving forward step and its example args, in the order of the
    JAX entry's: queries, centroids_n, the four bucket fields, counts,
    bucket_mask."""
    ivf, v = _example_ivf()
    queries = to_device(v[:8], ivf.device, torch.float32)
    example_args = (
        queries,
        ivf.centroids_n,
        ivf.buckets.codes,
        ivf.buckets.scale,
        ivf.buckets.offset,
        ivf.buckets.inv_norm,
        ivf.counts_dev,
        ivf.bucket_mask,
    )
    return forward, example_args


def dryrun_multichip(n_devices: int | None = None, mesh=None) -> str:
    """One full sharded step with tiny shapes on `mesh`, or on
    default_mesh(n_devices) (the first n cards; n CPU shards under
    VSTPU_DEVICE=cpu). Prints and returns the OK line with each stage's
    wall seconds."""
    from .build import lloyd, sample_init
    from .embed.noop import NoopAI
    from .engine import Engine, EngineCache
    from .parallel import ShardedFlat, ShardedIVF, default_mesh
    from .store import Store

    if mesh is None:
        mesh = default_mesh(n_devices)

    dim, kk = 64, 4
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(kk, dim)).astype(np.float32) * 4
    v = (
        centers[:, None, :] + rng.normal(size=(kk, 64, dim))
    ).astype(np.float32).reshape(-1, dim)
    packed = layout.pack_float(v)
    ids = np.arange(1, len(v) + 1, dtype=np.int64)

    stages = []
    last = [time.perf_counter()]

    def mark(name: str) -> None:
        now = time.perf_counter()
        stages.append("%s %.1fs" % (name, now - last[0]))
        last[0] = now

    # --- sharded k-means pass: every shard assigns and sums its rows, the
    # sums added in shard order (all_reduced across ranks) ---
    init = sample_init(packed, kk, seed=1)
    res = lloyd(packed, init, max_iters=2, chunk=32, mesh=mesh)
    assert res.counts.sum() == len(v)
    mark("kmeans-iter(shard sums)")
    queries = v[:4] + 0.01
    flat = ShardedFlat.build(mesh, packed, ids)
    s, i = flat.search(queries, k=5, chunk=64)
    assert (i[:, 0] == ids[:4]).all(), "sharded flat self-match failed"
    mark("flat(gather+merge)")

    ivf = ShardedIVF.build(mesh, packed, ids, res.centroids)
    nprobe = max(1, kk // 2)
    s, i = ivf.search(queries, k=5, nprobe=nprobe)
    assert (i[:, 0] == ids[:4]).all(), "sharded IVF self-match failed"
    mark("ivf(global-probe)")

    # --- the exact-f32 refine stage over the mesh ---
    s, i = ivf.search(queries, k=5, nprobe=nprobe, refine=16)
    assert (i[:, 0] == ids[:4]).all(), "sharded IVF refine self-match failed"
    mark("ivf+refine")

    # --- the same search on one device: the JAX dryrun's second scan route
    # (its Pallas kernel under shard_map) has no counterpart, the port has
    # one scan route, so the sharded answer is held against IVFIndex's ---
    single = IVFIndex.build(packed, ids, res.centroids, device=mesh.devices[0])
    ss, si = single.search(queries, k=5, nprobe=nprobe, refine=16)
    assert (si[:, 0] == ids[:4]).all(), "single-device refine self-match failed"
    np.testing.assert_allclose(s, ss, atol=SINGLE_ATOL)
    mark("ivf+refine==IVFIndex")

    # --- engine-level: a rebuild installs the sharded replica, searches
    # coalesce in the batcher and go through it ---
    store = Store(":memory:")
    eng = Engine(
        store, NoopAI(seed=7), cache=EngineCache(ttl=0.0), mesh=mesh,
        device=mesh.devices[0],
    )
    try:
        eng.upload(
            "o", "c",
            [{"name": f"d{j}", "document": {"text": f"doc {j}"}} for j in range(24)],
        )
        assert eng.refresh_category(1), "mesh rebuild did not run"
        st = eng._state_for(1, create=False)
        assert st.sharded is not None, "rebuild did not install sharded replica"
        mark("rebuild->sharded-replica")

        hits = [None] * 6

        def one(j):
            hits[j] = eng.search("o", "c", f"doc {j}", count=2, centroids=-1)

        threads = [threading.Thread(target=one, args=(j,)) for j in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(h is not None for h in hits), "concurrent searches failed"
        b = eng.stats()["batcher"]
        assert b["rows_served"] >= 6
        mark(f"batched-search({b['rows_served']} rows/{b['dispatches']} dispatches)")
    finally:
        eng.close()
        store.close()

    where = ", ".join(str(d) for d in mesh.devices)
    line = f"dryrun_multichip OK: {mesh.size}-device mesh ({where}) — " + ", ".join(stages)
    print(line, flush=True)
    return line


if __name__ == "__main__":
    from .parallel import local_devices

    fn, args = entry()
    out = fn(*args)
    print("entry OK:", tuple(tuple(t.shape) for t in out))
    dryrun_multichip(min(8, len(local_devices())))
