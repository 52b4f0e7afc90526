"""The port's FlatIndex and IVFIndex against the JAX package's, on the
same buckets (carried across with convert.py) or the same inputs.

Tolerances: refined scores (exact-f32 re-rank on both sides) atol 1e-5;
ids agree as sets except at near-ties within that tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorsearch_tpu import constants
from vectorsearch_tpu.index import FlatIndex as JaxFlat
from vectorsearch_tpu.index import IVFIndex as JaxIVF
from vectorsearch_tpu.quant import layout
from vectorsearch_tpu_torch import constants as port_constants
from vectorsearch_tpu_torch import convert
from vectorsearch_tpu_torch.index import FlatIndex, IVFIndex
from vectorsearch_tpu_torch.index.ivf import _oom_fallback

ATOL = 1e-5


@pytest.fixture(autouse=True)
def small_buckets(monkeypatch):
    monkeypatch.setattr(constants, "BUCKET_ROUND", 64)
    monkeypatch.setattr(port_constants, "BUCKET_ROUND", 64)
    monkeypatch.setenv("VSTPU_EXACT_EPILOGUE", "1")
    torch.set_num_threads(2)


def blobs(n_per=40, k=12, d=64, seed=3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32) * 4
    v = (centers[:, None, :] + rng.normal(size=(k, n_per, d))).reshape(-1, d)
    return centers, v.astype(np.float32)


def pair(n_per=40, k=12, d=64):
    centers, v = blobs(n_per, k, d)
    ids = np.arange(1, len(v) + 1, dtype=np.int64)
    jx = JaxIVF.build(layout.pack_float(v), ids, centers)
    return jx, convert.ivf_from_arrays(convert.arrays_from_index(jx), "cpu"), v


def assert_hits_match(a, b, atol=ATOL):
    """(scores, ids) pages agree: scores within atol; id sets agree except
    for entries within atol of the row's last finite score."""
    (s_a, i_a), (s_b, i_b) = a, b
    np.testing.assert_allclose(s_a, s_b, atol=atol)
    for sa, ia, sb, ib in zip(s_a, i_a, s_b, i_b):
        fin = np.isfinite(sa)
        if not fin.any():
            continue
        cut = sa[fin].min()
        for x in set(ia[fin]) ^ set(ib[np.isfinite(sb)]):
            near = np.concatenate([sa[ia == x], sb[ib == x]])
            assert (near <= cut + atol).all(), (x, near, cut)


@pytest.mark.parametrize("nprobe", [1, 3, 8, -1])
def test_ivf_search_matches_jax(nprobe):
    jx, pt, v = pair()
    q = v[::23][:17] + 0.01
    assert_hits_match(
        pt.search(q, k=10, nprobe=nprobe, refine=32),
        jx.search(jnp.asarray(q), k=10, nprobe=nprobe, refine=32),
    )


def test_build_matches_jax_layout():
    """Same corpus, centroids and assignments -> the same buckets."""
    centers, v = blobs()
    packed = layout.pack_float(v)
    ids = np.arange(1, len(v) + 1, dtype=np.int64)
    assign = np.random.default_rng(0).integers(0, len(centers), len(v))
    got = convert.arrays_from_index(
        IVFIndex.build(packed, ids, centers, assignments=assign, device="cpu")
    )
    want = convert.arrays_from_index(
        JaxIVF.build(packed, ids, centers, assignments=assign)
    )
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_insert_spill_and_search_match_jax():
    """Streaming inserts fill bucket slots, then overflow to the spill tail
    (cap=64 here); both indexes serve the new rows identically."""
    jx, pt, v = pair()
    rng = np.random.default_rng(9)
    # 150 rows near cluster 0's 40: 24 fill its bucket, the rest spill
    new = (v[rng.integers(0, 40, 150)] + rng.normal(size=(150, 64)) * 0.05)
    new = new.astype(np.float32)
    packed = layout.pack_float(new)
    new_ids = np.arange(10_001, 10_151)
    jx2, pt2 = jx.insert(packed, new_ids), pt.insert(packed, new_ids)
    assert pt2.spill.live == jx2.spill.live > 0
    assert pt2.n_live == jx2.n_live == len(v) + 150
    np.testing.assert_array_equal(np.sort(pt2.live_ids()), np.sort(jx2.live_ids()))
    assert_hits_match(
        pt2.search(new[:20], k=5, nprobe=2, refine=16),
        jx2.search(jnp.asarray(new[:20]), k=5, nprobe=2, refine=16),
    )


def test_remove_ids_matches_jax():
    jx, pt, v = pair()
    gone = np.arange(1, 40)
    jx2, pt2 = jx.remove_ids(gone), pt.remove_ids(gone)
    s, i = pt2.search(v[:39], k=5, nprobe=3, refine=16)
    assert not np.isin(i, gone).any()
    assert pt2.n_live == jx2.n_live == len(v) - 39
    assert_hits_match((s, i), jx2.search(jnp.asarray(v[:39]), k=5, nprobe=3, refine=16))


def test_compact_drains_spill_and_tombstones():
    _, pt, v = pair()
    pt = pt.insert(layout.pack_float(v[:100] * 1.01), np.arange(5001, 5101))
    pt = pt.remove_ids(np.arange(1, 11))
    assert pt.spill.live > 0
    before = pt.search(v[20:40], k=5, nprobe=-1, refine=16)
    c = pt.compact()
    assert c.spill.live == 0 and c.n_live == pt.n_live
    np.testing.assert_array_equal(np.sort(c.live_ids()), np.sort(pt.live_ids()))
    assert_hits_match(c.search(v[20:40], k=5, nprobe=-1, refine=16), before)


def test_old_snapshot_unchanged_after_insert_and_remove():
    """Copy on write: a reader's index object never changes under it."""
    _, pt, v = pair()
    before = pt.search(v[:8], k=5, nprobe=2, refine=16)
    codes = pt.buckets.codes.clone()
    mask = pt.bucket_mask.clone()
    pt.insert(layout.pack_float(v[:50] * 1.02), np.arange(7001, 7051))
    pt.remove_ids(np.arange(1, 9))
    assert torch.equal(pt.buckets.codes, codes)
    assert torch.equal(pt.bucket_mask, mask)
    after = pt.search(v[:8], k=5, nprobe=2, refine=16)
    np.testing.assert_array_equal(before[0], after[0])
    np.testing.assert_array_equal(before[1], after[1])


def _count_folds(monkeypatch):
    """Count the calls of fold_sidecars from here on."""
    from vectorsearch_tpu_torch.kernels import grouped_scan

    calls = []
    real = grouped_scan.fold_sidecars

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(grouped_scan, "fold_sidecars", counted)
    return calls


@pytest.mark.parametrize("refine", [0, 16])
def test_sidecars_fold_once_per_index(monkeypatch, refine):
    """The kernel's per-slot rows are folded at an index's first grouped
    search and kept: later searches, at any nprobe, fold nothing."""
    _, pt, v = pair()
    calls = _count_folds(monkeypatch)
    first = pt.search(v[:8], k=5, nprobe=2, refine=refine)
    assert len(calls) == 1
    for nprobe in (1, 2, 4):
        pt.search(v[:16], k=5, nprobe=nprobe, refine=refine)
    again = pt.search(v[:8], k=5, nprobe=2, refine=refine)
    assert len(calls) == 1
    np.testing.assert_array_equal(first[0], again[0])
    np.testing.assert_array_equal(first[1], again[1])
    pt.search(v[:8], k=5, nprobe=-1, refine=refine)  # the exhaustive scan folds nothing
    assert len(calls) == 1


def test_writes_fold_anew_and_searches_see_the_new_store(monkeypatch):
    """insert and remove_ids return new instances, which fold their own
    store: an inserted row is found, a deleted id never returns, and the
    index they came from keeps its rows and its answers."""
    _, pt, v = pair()
    calls = _count_folds(monkeypatch)
    before = pt.search(v[:8], k=5, nprobe=3, refine=16)
    assert len(calls) == 1
    new = (v[:30] * 1.01 + 0.02).astype(np.float32)
    new_ids = np.arange(9001, 9031)
    grown = pt.insert(layout.pack_float(new), new_ids)
    assert "folded" not in grown.__dict__
    _, got = grown.search(new, k=1, nprobe=3, refine=8)
    np.testing.assert_array_equal(got[:, 0], new_ids)
    assert len(calls) == 2
    gone = np.concatenate([new_ids[:10], before[1][:, 0]])
    shrunk = grown.remove_ids(gone)
    for nprobe in (1, 3):
        _, got = shrunk.search(np.concatenate([new, v[:8]]), k=5, nprobe=nprobe, refine=16)
        assert not np.isin(got, gone).any()
    assert len(calls) == 3
    # the folded rows follow the store: -inf exactly at dead slots
    col = torch.arange(shrunk.cap)
    live = (col[None] < shrunk.counts_dev[:, None]) & shrunk.bucket_mask
    assert torch.equal(torch.isneginf(shrunk.folded[2]), ~live)
    after = pt.search(v[:8], k=5, nprobe=3, refine=16)
    np.testing.assert_array_equal(before[1], after[1])
    assert len(calls) == 3


def _owning(pt):
    """The same index on tensors that own their storage (tensors made from
    numpy arrays share the arrays' memory, which cannot be released)."""
    from dataclasses import replace

    from vectorsearch_tpu_torch.quant.layout import PackedVectors

    spill = replace(pt.spill, packed=PackedVectors(*[t.clone() for t in pt.spill.packed]),
                    mask=pt.spill.mask.clone())
    return replace(pt, buckets=PackedVectors(*[t.clone() for t in pt.buckets]),
                   bucket_mask=pt.bucket_mask.clone(), counts_dev=pt.counts_dev.clone(),
                   spill=spill)


def test_release_device_frees_the_folded_rows():
    _, pt, v = pair()
    pt = _owning(pt)
    assert "folded" not in pt.__dict__
    bare = pt.hbm_bytes
    pt.search(v[:4], k=3, nprobe=2)
    folded = pt.folded
    assert [t.shape for t in folded] == [pt.bucket_mask.shape] * 3
    assert pt.hbm_bytes == bare + 12 * pt.k_clusters * pt.cap
    pt.release_device()
    assert all(t.untyped_storage().size() == 0 for t in folded)
    assert "folded" not in pt.__dict__
    assert pt.buckets.codes.untyped_storage().size() == 0


def test_release_device_before_any_search():
    _, pt, _ = pair()
    pt = _owning(pt)
    pt.release_device()
    assert "folded" not in pt.__dict__
    assert pt.buckets.codes.untyped_storage().size() == 0


def test_flat_index_matches_jax():
    _, v = blobs(n_per=30, k=5)
    packed = layout.pack_float(v)
    ids = np.arange(100, 100 + len(v), dtype=np.int64)
    jf, pf = JaxFlat.create(64), FlatIndex.create(64, device="cpu")
    for lo in range(0, len(v), 70):  # appends that grow the capacity
        sl = slice(lo, lo + 70)
        part = layout.PackedVectors(*[a[sl] for a in packed])
        jf, pf = jf.append(part, ids[sl]), pf.append(part, ids[sl])
    jf, pf = jf.remove_ids(ids[::7]), pf.remove_ids(ids[::7])
    assert pf.live == jf.live and pf.n == jf.n
    q = v[1::9] + 0.01
    assert_hits_match(pf.search(q, k=6, refine=12), jf.search(jnp.asarray(q), k=6, refine=12))
    assert_hits_match(pf.compact().search(q, k=6), jf.compact().search(jnp.asarray(q), k=6))


def test_oom_fallback_policy():
    """Pure decision table for the OOM retry (same cases as
    tests/test_index.py pins for the JAX package)."""
    assert _oom_fallback(True, 64, 5120, "auto", True, 128) == (
        "downgrade", "flat", False, 128
    )
    act, epi, apx, _ = _oom_fallback(True, 64, 5120, "blockexact", False, 128)
    assert (act, epi, apx) == ("downgrade", "flat", False)
    act, _, _, bm = _oom_fallback(True, 8, 3072, "auto", True, 128)
    assert (act, bm) == ("halve", 64)
    act, _, _, bm = _oom_fallback(True, 64, 5120, "flat", False, 128)
    assert (act, bm) == ("halve", 64)
    act, _, _, bm = _oom_fallback(False, 64, 5120, "auto", True, 128)
    assert (act, bm) == ("halve", 64)
    assert _oom_fallback(False, 64, 5120, None, True, 1)[0] == "raise"


def test_search_retries_on_out_of_memory(monkeypatch):
    """An out-of-memory dispatch at blockexact downgrades to flat at the
    same batch, then halves the batch; the answer is unchanged."""
    from vectorsearch_tpu_torch.index import ivf as port_ivf

    _, pt, v = pair(n_per=40, k=48)
    q = v[::50][:8] + 0.01
    want = pt.search(q, k=5, nprobe=40, refine=16)
    real = port_ivf._scan_refined
    calls = []

    def flaky(queries, *args, epilogue=None, **kw):
        calls.append((queries.shape[0], epilogue))
        if len(calls) <= 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")
        return real(queries, *args, epilogue=epilogue, **kw)

    monkeypatch.setattr(port_ivf, "_scan_refined", flaky)
    monkeypatch.setenv("VSTPU_EPILOGUE", "blockexact")
    got = pt.search(q, k=5, nprobe=40, refine=16)
    assert calls[:3] == [(8, "blockexact"), (8, "flat"), (4, "flat")]
    assert_hits_match(got, want)


def test_search_remembers_what_worked_after_out_of_memory(monkeypatch):
    """After a recovered out-of-memory dispatch, the next search on the
    same index starts at the epilogue and batch that worked (no failing
    dispatch); a write returns a new index, which starts afresh."""
    from vectorsearch_tpu_torch.index import ivf as port_ivf

    _, pt, v = pair(n_per=40, k=48)
    q = v[::50][:8] + 0.01
    want = pt.search(q, k=5, nprobe=40, refine=16)
    real = port_ivf._scan_refined
    calls = []

    def flaky(queries, *args, epilogue=None, **kw):
        calls.append((queries.shape[0], epilogue))
        if epilogue == "blockexact" or queries.shape[0] > 4:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")
        return real(queries, *args, epilogue=epilogue, **kw)

    monkeypatch.setattr(port_ivf, "_scan_refined", flaky)
    monkeypatch.setenv("VSTPU_EPILOGUE", "blockexact")
    first = pt.search(q, k=5, nprobe=40, refine=16)
    assert calls[:3] == [(8, "blockexact"), (8, "flat"), (4, "flat")]
    calls.clear()
    second = pt.search(q, k=5, nprobe=40, refine=16)
    assert calls == [(4, "flat"), (4, "flat")]
    assert_hits_match(second, first)
    assert_hits_match(second, want)

    calls.clear()
    grown = pt.insert(layout.pack_float(v[:2] + 0.5), np.array([10**6, 10**6 + 1]))
    grown.search(q, k=5, nprobe=40, refine=16)
    assert calls[0] == (8, "blockexact")
