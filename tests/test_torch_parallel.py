"""Sharded serving (parallel/sharded.py) on an 8-shard CPU mesh, against
the port's single-device indexes and against the JAX package's sharded
indexes on its 8-device virtual CPU mesh, on the same seeded numpy inputs
(the ports of tests/test_parallel.py's scenarios).

JAX's sharded IVF runs both of its per-shard scans: its XLA gather
formulation, and its grouped Pallas kernel in interpret mode
(VSTPU_SHARDED_PALLAS_INTERPRET=1, as tests/test_parallel.py runs it).
The port has one path: on the CPU the grouped-scan kernel's plain version.

Tolerances: coarse scores atol 2e-3 against JAX (the bf16 query rounding
of the scan and JAX's bf16-class CPU matmuls, ROADMAP queue 3); refined
scores (exact-f32 re-rank on both sides) atol 1e-5; the port's sharded
index against its own single-device index atol 1e-5 refined, 2e-3 coarse
(where nprobe reaches K the single index takes its exhaustive scan, which
rounds the queries to s8). Top-k ids are compared as sets, never positions,
with near-ties at the cut allowed (tests/test_torch_grouped_scan.py's
assert_topk_match).
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorsearch_tpu import constants
from vectorsearch_tpu.index import FlatIndex as JaxFlat
from vectorsearch_tpu.index import assign_clusters as jax_assign
from vectorsearch_tpu.parallel import ShardedFlat as JaxShardedFlat
from vectorsearch_tpu.parallel import ShardedIVF as JaxShardedIVF
from vectorsearch_tpu.parallel import default_mesh as jax_default_mesh
from vectorsearch_tpu.quant import layout
from vectorsearch_tpu_torch import constants as port_constants
from vectorsearch_tpu_torch.index import FlatIndex, IVFIndex
from vectorsearch_tpu_torch.parallel import Mesh, ShardedFlat, ShardedIVF

from test_torch_grouped_scan import assert_topk_match

COARSE, EXACT = 2e-3, 1e-5


@pytest.fixture(autouse=True)
def small_buckets(monkeypatch):
    monkeypatch.setattr(constants, "BUCKET_ROUND", 64)
    monkeypatch.setattr(port_constants, "BUCKET_ROUND", 64)
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def meshes():
    """JAX's 8-device virtual CPU mesh and the port's 8 CPU shards."""
    return jax_default_mesh(8), Mesh(("cpu",) * 8)


@pytest.fixture(params=["xla", "pallas"])
def jax_scan(request, monkeypatch):
    """JAX's per-shard scan: the XLA gather, or the Pallas kernel."""
    if request.param == "pallas":
        monkeypatch.setenv("VSTPU_SHARDED_PALLAS_INTERPRET", "1")
    else:
        monkeypatch.delenv("VSTPU_SHARDED_PALLAS_INTERPRET", raising=False)
    return request.param


def make_clustered(n_per=40, k=8, d=64, seed=2):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32) * 5
    pts = (centers[:, None, :] + rng.normal(size=(k, n_per, d))).astype(np.float32)
    return pts.reshape(-1, d), centers


def skewed():
    """8 clusters, centers 0 and 1 nearly parallel: with one cluster a
    shard both lie on shards 0 and 1, and the query sits between them."""
    rng = np.random.default_rng(5)
    d = 64
    base = rng.normal(size=(8, d)).astype(np.float32) * 5
    base[1] = base[0] + rng.normal(size=d).astype(np.float32) * 0.5
    pts = (base[:, None, :] + rng.normal(size=(8, 30, d))).astype(np.float32)
    return pts.reshape(-1, d), base, (base[0] + base[1])[None, :] / 2


def ivf_trio(meshes, v, centers):
    """The port's ShardedIVF and single-device IVFIndex, and JAX's
    ShardedIVF, on one assignment (JAX's), so all hold the same buckets."""
    packed = layout.pack_float(v)
    ids = np.arange(1, len(v) + 1, dtype=np.int64)
    assign = np.asarray(jax_assign(packed, centers))
    jmesh, mesh = meshes
    return (
        ShardedIVF.build(mesh, packed, ids, centers, assignments=assign),
        IVFIndex.build(packed, ids, centers, assignments=assign, device="cpu"),
        JaxShardedIVF.build(jmesh, packed, ids, centers, assignments=assign),
    )


def test_sharded_flat_matches_single(meshes):
    rng = np.random.default_rng(0)
    v = rng.normal(size=(500, 64)).astype(np.float32)
    packed = layout.pack_float(v)
    ids = np.arange(1, 501, dtype=np.int64)
    q = rng.normal(size=(4, 64)).astype(np.float32)
    jmesh, mesh = meshes

    sharded = ShardedFlat.build(mesh, packed, ids)
    assert sharded.rows_per_shard == 63 and sharded.n_local[-1] == 500 - 7 * 63
    got = sharded.search(q, k=10, chunk=64)
    assert_topk_match(*got, *FlatIndex.from_packed(packed, ids, device="cpu").search(q, k=10),
                      atol=EXACT)
    assert_topk_match(*got, *JaxShardedFlat.build(jmesh, packed, ids).search(q, k=10, chunk=64),
                      atol=COARSE)
    assert_topk_match(*got, *JaxFlat.from_packed(packed, ids).search(q, k=10), atol=COARSE)


def test_sharded_flat_small_corpus(meshes):
    """Fewer rows than shards x the 8-row minimum: the pad stays silent."""
    rng = np.random.default_rng(1)
    v = rng.normal(size=(5, 32)).astype(np.float32)
    packed = layout.pack_float(v)
    ids = np.arange(1, 6, dtype=np.int64)
    jmesh, mesh = meshes
    s, i = ShardedFlat.build(mesh, packed, ids).search(v[:1], k=8, chunk=64)
    assert (i[0][:5] != -1).sum() == 5 and sorted(i[0][:5]) == [1, 2, 3, 4, 5]
    assert (i[0][5:] == -1).all() and np.isneginf(s[0][5:]).all()
    assert_topk_match(s, i, *JaxShardedFlat.build(jmesh, packed, ids).search(
        v[:1], k=8, chunk=64), atol=COARSE)


@pytest.mark.parametrize("nprobe", [1, 3, 8, -1])
def test_sharded_ivf_matches_single(meshes, jax_scan, nprobe):
    """Exact-global probing: the same candidates as the single-device
    index at every nprobe, and as JAX's sharded index with either scan."""
    v, centers = make_clustered(n_per=30, k=8)
    q = v[:5] + 0.01
    port, single, jax_ = ivf_trio(meshes, v, centers)
    got = port.search(q, k=5, nprobe=nprobe)
    # nprobe >= K takes the single index's exhaustive scan (s8 queries)
    assert_topk_match(*got, *single.search(q, k=5, nprobe=nprobe), atol=COARSE)
    assert_topk_match(*got, *jax_.search(jnp.asarray(q), k=5, nprobe=nprobe), atol=COARSE)


@pytest.mark.parametrize("nprobe", [1, 3, 8, -1])
def test_sharded_ivf_refine(meshes, jax_scan, nprobe):
    """Refine on each shard's own store: the refined scores of the
    single-device index and of JAX's sharded index."""
    v, centers = make_clustered(n_per=30, k=8)
    q = v[:5] + 0.01
    port, single, jax_ = ivf_trio(meshes, v, centers)
    got = port.search(q, k=5, nprobe=nprobe, refine=16)
    assert_topk_match(*got, *single.search(q, k=5, nprobe=nprobe, refine=16), atol=EXACT)
    assert_topk_match(*got, *jax_.search(jnp.asarray(q), k=5, nprobe=nprobe, refine=16),
                      atol=EXACT)


def test_sharded_ivf_skewed_probe_global(meshes, jax_scan):
    """Cluster skew: the two nprobe-best clusters lie on shards 0 and 1;
    exact-global probing scans both and agrees with one device."""
    v, base, q = skewed()
    port, single, jax_ = ivf_trio(meshes, v, base)
    _, i_port = port.search(q, k=8, nprobe=2)
    assert set(i_port[0]) == set(single.search(q, k=8, nprobe=2)[1][0])
    assert set(i_port[0]) == set(jax_.search(jnp.asarray(q), k=8, nprobe=2)[1][0])


def test_sharded_ivf_nprobe_split(meshes):
    """nprobe=8 over 8 shards: one owned probe each; self-queries hit."""
    v, centers = make_clustered(n_per=30, k=8)
    ids = np.arange(1, len(v) + 1, dtype=np.int64)
    sharded = ShardedIVF.build(meshes[1], layout.pack_float(v), ids, centers)
    assert sharded.clusters_per_shard == 1
    _, i = sharded.search(v[:6] + 0.001, k=1, nprobe=8)
    assert (i[:, 0] == ids[:6]).all()


def test_sharded_ivf_fewer_clusters_than_shards(meshes):
    """3 clusters on 8 shards: 5 shards hold a zero pad cluster only."""
    v, centers = make_clustered(n_per=30, k=3)
    ids = np.arange(1, len(v) + 1, dtype=np.int64)
    sharded = ShardedIVF.build(meshes[1], layout.pack_float(v), ids, centers)
    s, i = sharded.search(v[:3] + 0.001, k=1, nprobe=-1)
    assert (i[:, 0] == ids[:3]).all()
    s, i = sharded.search(v[:3] + 0.001, k=200, nprobe=-1)
    assert (np.sort(i[np.isfinite(s)]) >= 1).all() and (i[~np.isfinite(s)] == -1).all()
    for row in i:
        live = row[row >= 0]
        assert len(set(live)) == len(live) == 90  # every row once, no pad


def test_sharded_ivf_mesh_of_one_shard_is_the_single_index():
    v, centers = make_clustered(n_per=30, k=8)
    packed = layout.pack_float(v)
    ids = np.arange(1, len(v) + 1, dtype=np.int64)
    one = ShardedIVF.build(Mesh(("cpu",)), packed, ids, centers)
    single = IVFIndex.build(packed, ids, centers, device="cpu")
    for nprobe in (1, 3, -1):
        assert_topk_match(*one.search(v[:7], k=5, nprobe=nprobe, refine=8),
                          *single.search(v[:7], k=5, nprobe=nprobe, refine=8), atol=EXACT)


def test_engine_rebuild_installs_sharded_replica(meshes, monkeypatch, tmp_path):
    """A mesh engine runs its k-means on the mesh, installs a ShardedIVF
    replica even when rows changed during the build (the replica is built
    from the reconciled arrays), and serves from it."""
    from test_engine import WordHashAI

    from vectorsearch_tpu_torch.engine import Engine, EngineCache
    from vectorsearch_tpu_torch.engine import engine as engine_mod
    from vectorsearch_tpu_torch.host import Store

    mesh = meshes[1]
    store = Store(str(tmp_path / "db.sqlite"))
    eng = Engine(store, WordHashAI(), cache=EngineCache(ttl=0.0), mesh=mesh, device="cpu")
    eng.upload("alice", "docs", [
        {"name": f"d{i}", "document": {"text": f"w{i % 3} base {i}"}} for i in range(30)
    ])
    cat = store.get_category(store.get_owner("alice").id, "docs")

    build_started, upload_done = threading.Event(), threading.Event()
    real_build = engine_mod.build_centroids
    seen_mesh = []

    def slow_build(*a, **kw):
        seen_mesh.append(kw.get("mesh"))
        build_started.set()
        assert upload_done.wait(30)
        return real_build(*a, **kw)

    monkeypatch.setattr(engine_mod, "build_centroids", slow_build)
    t = threading.Thread(
        target=lambda: eng.refresh_category(cat.id, target_cluster_size=10, chunk=64)
    )
    t.start()
    assert build_started.wait(30)
    mid = eng.upload("alice", "docs", [{"name": "mid", "document": {"text": "zebra row midbuild"}}])
    upload_done.set()
    t.join(timeout=120)
    assert not t.is_alive()

    assert seen_mesh == [mesh]
    st = eng._state_for(cat.id, create=False)
    assert st.sharded is not None and st.sharded.mesh is mesh
    assert eng.stats()["categories"][cat.id]["replica_shards"] == 8
    base = eng._batcher.stats()["dispatches"]
    hits = eng.search("alice", "docs", "zebra row midbuild", count=1, centroids=-1)
    assert hits and hits[0].document_id == mid[0]
    assert eng._batcher.stats()["dispatches"] == base + 1
    eng.close()
    store.close()
