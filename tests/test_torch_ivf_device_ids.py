"""The port IVFIndex's id map on the device (`ids_dev`, the mirror of the
host `ids` that IVFIndex.search gathers from) and its search of one read:
the mirror through every write, the answers against the plain scans with
a host id map, and the footprint it adds.

Tolerances: the search against the same scan with the id map done on the
host is bit-equal (the same arithmetic, only the id lookup moved); against
the gather formulation (`_ivf_scan`) scores within 1e-5 and ids equal
except at near-ties, as tests/test_torch_grouped_scan.py holds the two.
"""
import dataclasses

import numpy as np
import pytest
import torch

from vectorsearch_tpu_torch import constants
from vectorsearch_tpu_torch.index import IVFIndex
from vectorsearch_tpu_torch.index import ivf as port_ivf
from vectorsearch_tpu_torch.kernels import grouped_scan
from vectorsearch_tpu_torch.quant import layout

ATOL = 1e-5


@pytest.fixture(autouse=True)
def small_buckets(monkeypatch):
    monkeypatch.setattr(constants, "BUCKET_ROUND", 64)
    torch.set_num_threads(2)


def blobs(n_per=40, k=12, d=64, seed=3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32) * 4
    v = (centers[:, None, :] + rng.normal(size=(k, n_per, d))).reshape(-1, d)
    return centers, v.astype(np.float32)


def index(headroom=1.25, **kw):
    centers, v = blobs(**kw)
    ids = np.arange(1, len(v) + 1, dtype=np.int64) * 7
    return IVFIndex.build(layout.pack_float(v), ids, centers, headroom=headroom,
                          device="cpu"), v


def spilled(ivf, v, m=100):
    """ivf after an insert of m rows near one centroid: more than its
    bucket's free slots, so some land in the bucket and the rest spill."""
    rows = (v[:1] + 0.01 * np.random.default_rng(1).normal(size=(m, v.shape[1])))
    out = ivf.insert(layout.pack_float(rows.astype(np.float32)), np.arange(m) + 90_000)
    assert out.spill.live > 0 and out.live_count > ivf.live_count
    return out


def assert_mirrors(ivf):
    assert ivf.ids_dev.dtype == torch.int64 and ivf.ids_dev.shape == ivf.ids.shape
    np.testing.assert_array_equal(ivf.ids_dev.numpy(), ivf.ids)


def _insert_in_bucket(ivf, v):
    rows = layout.pack_float((v[::50] + 0.01).astype(np.float32))
    out = ivf.insert(rows, np.arange(len(v[::50])) + 50_000)
    assert out.spill.live == 0 and out.live_count > ivf.live_count
    return out


WRITES = {
    "build": lambda ivf, v: ivf,
    "insert_in_bucket": _insert_in_bucket,
    "insert_spilling": spilled,
    "remove_ids": lambda ivf, v: ivf.remove_ids(ivf.ids[ivf.mask_host][::3]),
    "compact": lambda ivf, v: spilled(ivf, v).remove_ids(np.arange(90_000, 90_010)).compact(),
    "frozen_insert": lambda ivf, v: dataclasses.replace(ivf, frozen=True).insert(
        layout.pack_float(v[:5] + 0.01), np.arange(5) + 70_000),
}


@pytest.mark.parametrize("write", list(WRITES))
def test_ids_dev_mirrors_ids(write):
    """ids_dev equals ids after the build and after each write; a write
    leaves the mirror of the instance it was made from as it was (copy on
    write, as bucket_mask)."""
    ivf, v = index()
    before = ivf.ids_dev.clone()
    out = WRITES[write](ivf, v)
    assert_mirrors(out)
    assert torch.equal(ivf.ids_dev, before)
    assert_mirrors(ivf)


def plain(ivf, q, k, nprobe, refine):
    """The same search with the id map on the host, as the search did it
    before: the scan's (scores, global slots) read back, the slots mapped
    through the host `ids` (-1 at -inf), the spill tail's hits merged."""
    qt = torch.from_numpy(q)
    nprobe = ivf.k_clusters if nprobe < 0 else min(nprobe, ivf.k_clusters)
    k_coarse = max(k, refine) if refine else k
    if nprobe == ivf.k_clusters:
        s, g = port_ivf._exhaustive_refined(qt, ivf.buckets, ivf.bucket_mask, k_coarse,
                                            k if refine else k_coarse, refine=bool(refine))
    elif refine:
        s, g = port_ivf._scan_refined(qt, ivf.centroids_n, ivf.buckets, ivf.counts_dev,
                                      ivf.bucket_mask, nprobe, k_coarse, k)
    else:
        s, g = grouped_scan.ivf_scan_grouped(qt, ivf.centroids_n, ivf.buckets, ivf.counts_dev,
                                             ivf.bucket_mask, nprobe, k)
    s, g = s.numpy(), g.numpy()
    flat = ivf.ids.reshape(-1)
    ids = np.where(np.isneginf(s), -1, flat[np.clip(g, 0, flat.size - 1)])
    if ivf.spill.live > 0:
        s2, i2 = ivf.spill.search(q, k, refine=refine)
        both_s, both_i = np.concatenate([s, s2], -1), np.concatenate([ids, i2], -1)
        take = np.argsort(-both_s, axis=-1, kind="stable")[:, :k]
        s, ids = np.take_along_axis(both_s, take, -1), np.take_along_axis(both_i, take, -1)
    return s, ids


@pytest.mark.parametrize("spill", [False, True], ids=["buckets", "spill"])
@pytest.mark.parametrize("refine", [0, 32])
@pytest.mark.parametrize("nprobe", [1, 3, -1])
def test_search_equals_the_scan_with_a_host_id_map(nprobe, refine, spill):
    ivf, v = index()
    if spill:
        ivf = spilled(ivf, v)
    q = (v[::23][:17] + 0.01).astype(np.float32)
    got = ivf.search(q, k=10, nprobe=nprobe, refine=refine)
    want = plain(ivf, q, 10, nprobe, refine)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int64
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("nprobe", [1, 3])
def test_search_agrees_with_the_gather_formulation(nprobe):
    """Without a refine, the search's answers against `_ivf_scan` (the
    probed buckets gathered, the JAX package's XLA formulation) with the
    ids mapped on the host."""
    ivf, v = index()
    q = (v[::23][:17] + 0.01).astype(np.float32)
    s, ids = ivf.search(q, k=10, nprobe=nprobe)
    ws, wg = port_ivf._ivf_scan(torch.from_numpy(q), ivf.centroids_n, ivf.buckets,
                                ivf.counts_dev, ivf.bucket_mask, nprobe, 10)
    ws, wg = ws.numpy(), wg.numpy()
    wi = np.where(np.isneginf(ws), -1, ivf.ids.reshape(-1)[np.clip(wg, 0, ivf.ids.size - 1)])
    np.testing.assert_allclose(s, ws, atol=ATOL)
    for row_s, row_i, row_wi in zip(s, ids, wi):
        cut = row_s[np.isfinite(row_s)].min()
        for x in set(row_i) ^ set(row_wi):
            assert (row_s[row_i == x] <= cut + ATOL).all()


def test_hbm_bytes_counts_the_ids():
    """8 bytes a slot more than codes, sidecars and mask: the int64 mirror;
    12 more once a search has folded the sidecars."""
    ivf, v = index()
    kk, cap, d = ivf.buckets.codes.shape
    assert ivf.hbm_bytes == kk * cap * (d + 13 + 8) + ivf.spill.hbm_bytes
    ivf.search(v[:4], k=3, nprobe=2)
    assert ivf.hbm_bytes == kk * cap * (d + 13 + 8 + 12) + ivf.spill.hbm_bytes


def test_a_budget_that_binds_counts_the_ids():
    """The build's budget arithmetic counts the mirror: a budget that holds
    the store at 13 bytes a slot above its codes but not at 21 clamps the
    capacity down; one that holds it at 21 leaves it as without a budget."""
    centers, v = blobs(n_per=60)  # 60 a cluster: capacity 128, 64 at headroom 1.0
    packed, ids = layout.pack_float(v), np.arange(1, len(v) + 1)
    kw = dict(assignments=np.repeat(np.arange(len(centers)), 60), device="cpu")
    free = IVFIndex.build(packed, ids, centers, **kw)
    kk, cap, d = free.buckets.codes.shape
    assert cap == 128
    reserve = constants.BUCKET_ROUND * (d + 13)
    roomy = IVFIndex.build(packed, ids, centers, hbm_budget=kk * cap * (d + 21) + reserve, **kw)
    assert roomy.cap == cap
    tight = IVFIndex.build(packed, ids, centers, hbm_budget=kk * cap * (d + 13) + reserve, **kw)
    assert tight.cap == 64
    assert_mirrors(tight)


def test_release_device_frees_the_ids():
    ivf, _ = index()
    ivf.release_device()
    assert ivf.ids_dev.untyped_storage().size() == 0
