"""The port's k-means build against the JAX package's, on the same seeded
well-separated blobs: the same numpy seeding gives the same initial
centroids, so cluster labels line up. Tolerance: assignment agreement
>= 0.99, equal counts, centroids within 1e-3 (f32 sums in another order).
"""
import importlib

import numpy as np
import pytest
import torch

from vectorsearch_tpu.quant import layout

# the packages export a `kmeans` function that shadows the module name
jk = importlib.import_module("vectorsearch_tpu.build.kmeans")
tk = importlib.import_module("vectorsearch_tpu_torch.build.kmeans")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def blobs(k=6, n_per=80, d=32, seed=0, skew=False):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32) * 8
    sizes = [n_per * (4 if skew and i == 0 else 1) for i in range(k)]
    v = np.concatenate(
        [centers[i] + rng.normal(size=(s, d)).astype(np.float32) for i, s in enumerate(sizes)]
    )
    return layout.pack_float(v)


def assert_same_clustering(got, want):
    assert got.centroids.shape == want.centroids.shape
    assert (got.assignments == want.assignments).mean() >= 0.99
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_allclose(got.centroids, want.centroids, atol=1e-3)


@pytest.mark.parametrize("max_iters,tol", [(50, 0), (1, -1), (2, 10**9)])
def test_lloyd_matches_jax(max_iters, tol):
    packed = blobs()
    init = jk.sample_init(packed, 6, seed=1)
    np.testing.assert_array_equal(tk.sample_init(packed, 6, seed=1), init)
    want = jk.lloyd(packed, init, max_iters=max_iters, chunk=128, tol_changes=tol)
    got = tk.lloyd(packed, init, max_iters=max_iters, chunk=128, tol_changes=tol,
                   device="cpu")
    assert_same_clustering(got, want)
    assert got.iterations == want.iterations


def test_kmeans_matches_jax():
    """Superset seeding on a sample, keep the largest, converge."""
    packed = blobs(k=5, n_per=120)
    want = jk.kmeans(packed, 5, chunk=256, seed=3)
    got = tk.kmeans(packed, 5, chunk=256, seed=3, device="cpu")
    assert_same_clustering(got, want)


def test_build_centroids_matches_jax():
    """Drop-small and one balance round (cluster 0 is 4x the others)."""
    packed = blobs(k=6, n_per=60, skew=True)
    kw = dict(k=6, min_cluster_size=20, max_iters=30, chunk=128, seed=0)
    want = jk.build_centroids(packed, **kw)
    got = tk.build_centroids(packed, device="cpu", **kw)
    assert_same_clustering(got, want)
    assert got.iterations == want.iterations


def test_build_centroids_with_a_sampled_split_matches_jax(monkeypatch):
    """The balance round's sub-build on a seeded sample of the split
    cluster's members in both packages: at k=10 the round splits one
    cluster of 120 rows, and SAMPLE_SIZE 80 draws 80 of them."""
    monkeypatch.setattr(jk.constants, "SAMPLE_SIZE", 80)
    monkeypatch.setattr(tk.constants, "SAMPLE_SIZE", 80)
    sizes = []

    def members(assignments, clusters):
        out = members_by_cluster(assignments, clusters)
        sizes.extend(m.size for m in out)
        return out

    members_by_cluster = tk._members_by_cluster
    monkeypatch.setattr(tk, "_members_by_cluster", members)
    packed = blobs(k=6, n_per=60, skew=True)
    kw = dict(k=10, min_cluster_size=20, max_iters=30, chunk=128, seed=0)
    want = jk.build_centroids(packed, **kw)
    got = tk.build_centroids(packed, device="cpu", **kw)
    assert max(sizes) > 80
    assert_same_clustering(got, want)
    assert got.iterations == want.iterations


def _skewed(k=64, n=20_000, seed=0):
    rng = np.random.default_rng(seed)
    w = np.exp(rng.normal(size=k))
    return rng.choice(k, size=n, p=w / w.sum()).astype(np.int32)


def _as_the_build_picks(a):
    counts = np.bincount(a)
    return np.nonzero(counts > 2 * max(1, int(counts.sum() // len(counts))))[0]


@pytest.mark.parametrize("assignments,clusters", [
    (_skewed(), np.sort(np.random.default_rng(1).choice(64, size=40, replace=False))),
    (_skewed(k=8, n=500), np.array([3])),
    (np.array([0, 2, 2, 5, 0, 2], np.int32), np.array([0, 1, 2, 7])),  # 1 and 7: none
    (_skewed(seed=2), _as_the_build_picks(_skewed(seed=2))),
], ids=["many", "one", "no-members", "as-the-build-picks"])
def test_members_by_cluster_is_each_clusters_nonzero(assignments, clusters):
    got = tk._members_by_cluster(assignments, clusters)
    assert len(got) == len(clusters) > 0
    for c, rows in zip(clusters, got):
        want = np.nonzero(assignments == c)[0]
        assert rows.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(rows, want)


# ---- on a mesh: 8 CPU shards here, JAX's 8-device virtual CPU mesh there


@pytest.fixture(scope="module")
def meshes():
    import jax
    from jax.sharding import Mesh as JaxMesh

    from vectorsearch_tpu_torch.parallel import Mesh

    return JaxMesh(np.array(jax.devices()[:8]), ("data",)), Mesh(("cpu",) * 8)


@pytest.mark.parametrize("max_iters,tol", [(20, 0), (1, -1)])
def test_sharded_lloyd_matches_one_device_and_jax(meshes, max_iters, tol):
    """Each shard assigns and accumulates its own rows; the sums, counts
    and changes added over the shards give one device's clustering and
    JAX's 8-device clustering (sums in another order: the tolerance of
    assert_same_clustering)."""
    packed = blobs(k=4, n_per=128, seed=5)
    init = jk.sample_init(packed, 4, seed=2)
    jmesh, mesh = meshes
    one = tk.lloyd(packed, init, max_iters=max_iters, chunk=64, tol_changes=tol,
                   device="cpu")
    got = tk.lloyd(packed, init, max_iters=max_iters, chunk=64, tol_changes=tol, mesh=mesh)
    want = jk.lloyd(packed, init, max_iters=max_iters, chunk=64, tol_changes=tol,
                    mesh=jmesh)
    assert_same_clustering(got, one)
    assert_same_clustering(got, want)
    assert got.iterations == one.iterations == want.iterations
    assert got.final_changes == one.final_changes


def test_sharded_lloyd_with_shards_past_the_rows(meshes):
    """5 rows over 8 shards: three shards hold none and add nothing."""
    packed = blobs(k=2, n_per=3)
    packed = type(packed)(*[a[:5] for a in packed])
    init = tk.sample_init(packed, 2, seed=0)
    one = tk.lloyd(packed, init, max_iters=5, chunk=64, device="cpu")
    got = tk.lloyd(packed, init, max_iters=5, chunk=64, mesh=meshes[1])
    np.testing.assert_array_equal(got.assignments, one.assignments)
    np.testing.assert_array_equal(got.counts, one.counts)
    np.testing.assert_allclose(got.centroids, one.centroids, atol=1e-6)


def test_build_centroids_on_a_mesh_matches_jax(meshes):
    """The superset, drop-small and balance phases on the mesh (cluster 0
    is 4x the others), against JAX's build on its mesh."""
    packed = blobs(k=6, n_per=60, skew=True)
    kw = dict(k=6, min_cluster_size=20, max_iters=30, chunk=128, seed=0)
    jmesh, mesh = meshes
    want = jk.build_centroids(packed, mesh=jmesh, **kw)
    got = tk.build_centroids(packed, mesh=mesh, **kw)
    assert_same_clustering(got, want)
    assert got.counts.sum() == packed.codes.shape[0]
