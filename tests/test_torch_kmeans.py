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
