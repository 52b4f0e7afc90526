"""The port's grouped scan (kernels/grouped_scan.py) against the JAX
package's Pallas scan run in interpret mode, on identical buckets.

On the CPU the kernel wrapper runs its plain version
(grouped_scores_ref); the CUDA kernel itself is held against that plain
version by tests/test_torch_kernel_cuda.py and by chip_smoke.py.

Tolerances: coarse scores atol 2e-3 (the bf16 query rounding of the scan
and JAX's bf16-class CPU matmuls, as tests/test_pallas.py uses); top-k id
sets must agree except at near-ties within that tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorsearch_tpu import constants
from vectorsearch_tpu.index import IVFIndex as JaxIVF
from vectorsearch_tpu.kernels import pallas_scan
from vectorsearch_tpu.quant import layout
from vectorsearch_tpu_torch import convert
from vectorsearch_tpu_torch.index import ivf as port_ivf
from vectorsearch_tpu_torch.kernels import grouped_scan

ATOL = 2e-3


@pytest.fixture(autouse=True)
def small_buckets(monkeypatch):
    monkeypatch.setattr(constants, "BUCKET_ROUND", 64)
    torch.set_num_threads(2)


def make_pair(n_per=40, k=96, d=128, seed=2):
    """A JAX IVF index and the port index holding the same buckets."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32) * 5
    pts = (centers[:, None, :] + rng.normal(size=(k, n_per, d))).astype(np.float32)
    v = pts.reshape(-1, d)
    ids = np.arange(1, len(v) + 1, dtype=np.int64)
    jx = JaxIVF.build(layout.pack_float(v), ids, centers)
    return jx, convert.ivf_from_arrays(convert.arrays_from_index(jx), "cpu"), v


def jax_scan(jx, q, nprobe, k, epilogue):
    s, g = pallas_scan.ivf_scan_pallas(
        jnp.asarray(q), jx.centroids_n, jx.buckets, jx.counts_dev,
        jx.bucket_mask, nprobe=nprobe, k=k, interpret=True, approx=False,
        epilogue=epilogue,
    )
    return np.asarray(s), np.asarray(g)


def port_scan(pt, q, nprobe, k, epilogue):
    s, g = grouped_scan.ivf_scan_grouped(
        torch.from_numpy(q), pt.centroids_n, pt.buckets, pt.counts_dev,
        pt.bucket_mask, nprobe=nprobe, k=k, epilogue=epilogue,
    )
    return s.numpy(), g.numpy()


def assert_topk_match(s_a, g_a, s_b, g_b, atol=ATOL):
    """Scores agree within atol; finite id sets agree except for entries
    within atol of the row's k-th score (near-ties at the cut)."""
    np.testing.assert_allclose(s_a, s_b, atol=atol)
    for sa, ga, sb, gb in zip(s_a, g_a, s_b, g_b):
        fa, fb = np.isfinite(sa), np.isfinite(sb)
        assert fa.sum() == fb.sum()
        if not fa.any():
            continue
        cut = sa[fa].min()
        only_a = set(ga[fa]) ^ set(gb[fb])
        for gs in only_a:
            score = np.concatenate([sa[fa][ga[fa] == gs], sb[fb][gb[fb] == gs]])
            assert (score <= cut + atol).all(), (gs, score, cut)


@pytest.mark.parametrize("b", [1, 5, 33])
@pytest.mark.parametrize("nprobe", [1, 3, 8, 16, 64])
@pytest.mark.parametrize("epilogue", ["flat", "blockexact"])
def test_grouped_scan_matches_pallas(epilogue, nprobe, b):
    """k=8 on cap=64 buckets: blockexact takes its block-max prefilter at
    nprobe 16 and 64 and its flat fallback below (k_eff*bs*2 > nprobe*cap)."""
    jx, pt, v = make_pair()
    rng = np.random.default_rng(b * 100 + nprobe)
    q = (v[rng.integers(0, len(v), size=b)] + 0.01).astype(np.float32)
    assert_topk_match(
        *port_scan(pt, q, nprobe, 8, epilogue), *jax_scan(jx, q, nprobe, 8, epilogue)
    )


@pytest.mark.parametrize("nprobe", [2, 6])
def test_blockexact_multiblock_matches_pallas(nprobe):
    """cap=192 is not a multiple of 128: bs=64 and three blocks per bucket,
    so the prefilter ranks blocks inside one bucket too."""
    jx, pt, v = make_pair(n_per=150, k=8, d=64)
    assert pt.cap == 192
    q = (v[::97][:9] + 0.01).astype(np.float32)
    assert_topk_match(
        *port_scan(pt, q, nprobe, 4, "blockexact"),
        *jax_scan(jx, q, nprobe, 4, "blockexact"),
    )


def test_blockexact_equals_flat_and_fallback():
    """blockexact is an exact reduction: identical to flat, through the
    block path (k=4 <= nprobe*nblk) and through bx_fallback (k=40)."""
    _, pt, v = make_pair(n_per=150, k=8, d=64)
    q = (v[::61][:7] + 0.01).astype(np.float32)
    for k in (4, 40):
        s_f, g_f = port_scan(pt, q, 6, k, "flat")
        s_b, g_b = port_scan(pt, q, 6, k, "blockexact")
        np.testing.assert_array_equal(s_f, s_b)
        np.testing.assert_array_equal(g_f, g_b)


def test_tombstones_masked():
    jx, pt, v = make_pair(n_per=10, k=2, d=64)
    jx, pt = jx.remove_ids(np.array([1])), pt.remove_ids(np.array([1]))
    q = (v[:1] + 0.001).astype(np.float32)
    s_p, g_p = port_scan(pt, q, 2, 3, "flat")
    s_j, g_j = jax_scan(jx, q, 2, 3, "flat")
    assert_topk_match(s_p, g_p, s_j, g_j)
    flat_ids = pt.ids.reshape(-1)
    assert 1 not in flat_ids[g_p[0]]


def test_k_larger_than_valid_rows():
    jx, pt, v = make_pair(n_per=3, k=2, d=64)
    q = v[:1].astype(np.float32)
    s_p, g_p = port_scan(pt, q, 1, 8, "flat")
    s_j, g_j = jax_scan(jx, q, 1, 8, "flat")
    assert np.isfinite(s_p[0][:3]).all() and np.isneginf(s_p[0][3:]).all()
    assert_topk_match(s_p, g_p, s_j, g_j)


def test_resolve_auto_epilogue_matches_jax():
    for nprobe in (1, 2, 6, 8, 11, 16, 64):
        for cap in (64, 1024, 3072, 3100, 5120):
            for approx in (True, False):
                assert grouped_scan.resolve_auto_epilogue(
                    nprobe, cap, approx
                ) == pallas_scan.resolve_auto_epilogue(nprobe, cap, approx)


def test_gather_formulation_matches_grouped():
    """The port's second plain formulation (_ivf_scan, the JAX package's
    XLA gather path) agrees with the grouped scan."""
    _, pt, v = make_pair()
    q = torch.from_numpy((v[::37][:11] + 0.01).astype(np.float32))
    a = port_ivf._ivf_scan(
        q, pt.centroids_n, pt.buckets, pt.counts_dev, pt.bucket_mask, 8, 10
    )
    b = grouped_scan.ivf_scan_grouped(
        q, pt.centroids_n, pt.buckets, pt.counts_dev, pt.bucket_mask, 8, 10
    )
    assert_topk_match(a[0].numpy(), a[1].numpy(), b[0].numpy(), b[1].numpy(), atol=1e-5)


def test_group_build_covers_every_pair():
    """Each (query, probe) pair lands on its own score row, in a group of
    its cluster, and the group sizes respect QT."""
    rng = np.random.default_rng(0)
    probed = torch.from_numpy(
        np.argsort(rng.random((37, 20)), axis=1)[:, :5].astype(np.int32)
    )
    qt, gcl, qidx, pair_slot = grouped_scan.build_groups(probed, 20)
    assert qt in (8, 16, grouped_scan.QT_MAX)
    rows = pair_slot.numpy()
    assert len(set(rows)) == rows.size
    g, slot = rows // qt, rows % qt
    np.testing.assert_array_equal(gcl.numpy()[g], probed.numpy().reshape(-1))
    np.testing.assert_array_equal(
        qidx.numpy()[g, slot], np.repeat(np.arange(37), 5)
    )

