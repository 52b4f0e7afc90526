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
