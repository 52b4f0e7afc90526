"""The flat index's band route (FlatIndex.topk at refine > 0, kernels/flat.py
band_candidates) on the CPU, where flat_bands_s8 runs its plain version, on
rows of the flat configuration's law with tombstones:

- the rows of the top m bands hold the streamed scan's coarse top m, except
  rows whose coarse score lies within 1e-6 of the m-th (the two routes round
  the affine terms in another order);
- FlatIndex.search(refine=m) is never worse at any rank than the streamed
  route, by f64 cosine, and equals it (tests/flat_route_cases.py) and the
  JAX package's FlatIndex.search under assert_hits_match wherever those
  return the exact top k: at m = 32, on every query;
- a band scan cut into many launches gives the one launch's answers;
- an empty or tiny index still answers k wide, -inf and -1 past its rows.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flat_route_cases import assert_hits_match, compare_routes, index, law, streamed
from vectorsearch_tpu.index import FlatIndex as JaxFlat
from vectorsearch_tpu.quant import layout as jax_layout
from vectorsearch_tpu_torch.index import FlatIndex
from vectorsearch_tpu_torch.kernels import cosine
from vectorsearch_tpu_torch.kernels import flat as tf

K = 10
B = 12
SIZES = pytest.mark.parametrize("n", [1_000, 5_000, 70_000])
DEPTHS = pytest.mark.parametrize("m", [K, 32])
TIE = 1e-6


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def case(n):
    """Rows, queries, and a CPU FlatIndex with every 17th row and the first
    query's best row tombstoned."""
    v, q = law(n, B, seed=n)
    f = index(v, [], "cpu")
    best = f.search(q[:1], k=1)[1][0, 0]
    dead = np.union1d(np.arange(n, dtype=np.int64)[3::17] + 100, [best])
    return v, q, index(v, dead, "cpu"), dead


@SIZES
@DEPTHS
def test_band_rows_hold_the_streamed_coarse_top_m(n, m):
    _, q, f, _ = case(n)
    qt = torch.from_numpy(q)
    assert f.capacity > f.n
    cand, rows = tf.band_candidates(qt, f.packed, f.n, m, K, f.mask)
    assert rows.shape == (B, 8 * m)
    coarse, slots = cosine.scan_topk_streamed(qt, f.packed, f.n, k=m, valid_mask=f.mask)
    for c, s, r, cd in zip(coarse.numpy(), slots.numpy(), rows.numpy(), cand.numpy()):
        assert len(set(r)) == len(r) and np.isfinite(cd[r < f.n]).all()
        missing = ~np.isin(s, r)
        assert (np.abs(c[missing] - c[-1]) <= TIE).all(), (s[missing], c[missing], c[-1])


def _jax_index(v, dead):
    n = len(v)
    ids = np.arange(n, dtype=np.int64) + 100
    return JaxFlat.create(v.shape[1]).append(jax_layout.pack_float(v), ids).remove_ids(dead)


@SIZES
@DEPTHS
def test_refined_search_never_worse_and_matches_jax(n, m):
    v, q, f, dead = case(n)
    band = f.search(q, k=K, refine=m)
    assert band[0].shape == band[1].shape == (B, K)
    assert not np.isin(band[1], dead).any()
    compare_routes(f, q, band, streamed(f, q, K, m), K, m)
    jf = _jax_index(v, dead)
    want = tuple(np.asarray(a) for a in jf.search(jnp.asarray(q), k=K, refine=m))
    compare_routes(f, q, band, want, K, m)


@pytest.mark.parametrize("tiles", [1, 3, 8])
@pytest.mark.parametrize("m", [K, 32, 200])
def test_chunked_band_scan_equals_one_launch(monkeypatch, tiles, m):
    """BAND_BYTES cut to `tiles` tiles a launch at B=12: 5 to 69 launches over
    70,000 rows, each chunk's top bands merged, against one launch."""
    _, q, f, _ = case(70_000)
    one = f.search(q, k=K, refine=m)
    monkeypatch.setattr(tf, "BAND_BYTES", tiles * tf.BAND_LANES * 4 * B)
    calls = []
    orig = tf.flat_bands_s8
    monkeypatch.setattr(tf, "flat_bands_s8", lambda *a: calls.append(a[3].shape[0]) or orig(*a))
    many = f.search(q, k=K, refine=m)
    assert len(calls) == -(-f.n // (tiles * tf.TILE_N)) and sum(calls) == f.n
    assert_hits_match(many, one)
    np.testing.assert_array_equal(many[0], one[0])


@pytest.mark.parametrize("n", [0, 3, 1025])
def test_small_index_answers_k_wide(n):
    """k above the candidate rows (none at n=0; 1,024 from n=3's one tile
    at k=2,000; 2,048 from n=1,025's two tiles at k=3,000): k columns, the
    live rows first, -inf and id -1 after, the tombstoned row absent."""
    k = {0: 5, 3: 2_000, 1025: 3_000}[n]
    f = FlatIndex.create(16, device="cpu")
    if n:
        v, _ = law(n, 1, seed=n, d=16)
        f = index(v, [100], "cpu")
    q = np.ones((2, 16), np.float32)
    s, ids = f.search(q, k=k, refine=k)
    assert s.shape == ids.shape == (2, k)
    live = max(n - 1, 0)
    assert np.isfinite(s[:, :live]).all() and np.isneginf(s[:, live:]).all()
    assert (ids[:, live:] == -1).all() and not np.isin(ids, [100]).any()
    if n:
        np.testing.assert_array_equal(np.sort(ids[:, :live], axis=-1),
                                      np.tile(np.arange(101, 100 + n), (2, 1)))
