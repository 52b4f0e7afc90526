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
from vectorsearch_tpu_torch import constants as port_constants
from vectorsearch_tpu_torch import convert
from vectorsearch_tpu_torch.index import ivf as port_ivf
from vectorsearch_tpu_torch.kernels import grouped_scan

ATOL = 2e-3


@pytest.fixture(autouse=True)
def small_buckets(monkeypatch):
    monkeypatch.setattr(constants, "BUCKET_ROUND", 64)
    monkeypatch.setattr(port_constants, "BUCKET_ROUND", 64)
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


@pytest.mark.parametrize("masked", [False, True], ids=["all-valid", "probe_valid"])
@pytest.mark.parametrize("kk", [3, 20, 1024])
@pytest.mark.parametrize("nprobe", [1, 5, 8])
@pytest.mark.parametrize("b", [1, 37, 512])
def test_group_build_covers_every_pair(b, nprobe, kk, masked):
    """Each (query, probe) pair lands on its own score row, in a group of
    its cluster, and the group sizes respect QT. The outputs have the
    static bound's rows, min(P, ceil(P / QT) + min(K', P)) with K' = K + 1
    where the pairs of probe_valid False are grouped under the id K; the
    count left on the device is the exact group count of the plain
    formulation (each cluster's pairs fill ceil(m / QT) groups); padding
    groups carry the id K and no pair's row lies in one; the real groups
    come in the order of their clusters."""
    rng = np.random.default_rng(b * 100 + nprobe * 10 + kk + masked)
    if nprobe <= kk:  # distinct probes a query, as the probe gives them
        probed = np.argsort(rng.random((b, kk)), axis=1)[:, :nprobe]
    else:
        probed = rng.integers(0, kk, size=(b, nprobe))
    if masked:  # grouped_scan's form of probe_valid False: the id K
        probed = np.where(rng.random((b, nprobe)) < 0.7, probed, kk)
    probed = probed.astype(np.int32)
    qt, gcl, qidx, pair_slot, gcount = grouped_scan.build_groups(
        torch.from_numpy(probed), kk, masked=masked)
    p = b * nprobe
    assert qt == grouped_scan.group_qt(p, kk) and qt in (8, 16, grouped_scan.QT_MAX)
    g_max = min(p, -(-p // qt) + min(kk + masked, p))
    assert gcl.shape == (g_max,) and qidx.shape == (g_max, qt)
    assert gcl.dtype == torch.int32 and pair_slot.shape == (p,)
    assert gcount.dtype == torch.int32 and gcount.shape == (1,)
    _, m = np.unique(probed, return_counts=True)
    n_groups = int((-(-m // qt)).sum())
    assert int(gcount) == n_groups <= g_max
    gcl, qidx = gcl.numpy(), qidx.numpy()
    assert (gcl[n_groups:] == kk).all()
    assert (np.diff(gcl[:n_groups]) >= 0).all()
    rows = pair_slot.numpy()
    assert len(set(rows)) == rows.size
    g, slot = rows // qt, rows % qt
    assert (g < n_groups).all()
    np.testing.assert_array_equal(gcl[g], probed.reshape(-1))
    np.testing.assert_array_equal(qidx[g, slot], np.repeat(np.arange(b), nprobe))



def _every_group(g):
    """A group count on the CPU under which all g groups count."""
    return torch.tensor([g], dtype=torch.int32)


def _kernel_inputs(counts, seed, g=7, qt=8, d=32, tomb=0.15):
    """Seeded numpy inputs of the scan kernel: bias -inf at tombstones and
    at every slot at or past its cluster's count."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int32)
    kk, cap = len(counts), 128
    codes = rng.integers(-128, 128, size=(kk, cap, d), dtype=np.int8)
    a = rng.random((kk, cap), dtype=np.float32) * 0.01
    bv = rng.random((kk, cap), dtype=np.float32) * 0.01
    live = (np.arange(cap)[None] < counts[:, None]) & (rng.random((kk, cap)) > tomb)
    bias = np.where(live, 0.0, -np.inf).astype(np.float32)
    q = rng.normal(size=(g, qt, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    qg = torch.from_numpy(q).bfloat16()
    gcl = rng.integers(0, kk, size=g).astype(np.int32)
    gcl[: min(g, kk)] = np.arange(min(g, kk))  # every cluster probed
    return qg, q.sum(-1), gcl, counts, codes, a, bv, bias


@pytest.mark.parametrize("counts", [
    (128, 0, 70, 1), (0, 0, 0), (128, 128), (64, 65, 127, 100, 3)],
    ids=["full-empty-ragged", "all-empty", "all-full", "ragged"])
@pytest.mark.parametrize("bs", [64, 128])
def test_plain_kernel_with_counts_is_the_same_function(counts, bs):
    """grouped_scores (on the CPU: its plain version) with `counts` gives
    what the formula gives without it, in float64 numpy, on seeded inputs
    with tombstones: scores, -inf pattern and block maxima."""
    qg, qsum, gcl, cnt, codes, a, bv, bias = _kernel_inputs(counts, seed=len(counts) + bs)
    out, bmax = grouped_scan.grouped_scores(
        qg, torch.from_numpy(qsum), torch.from_numpy(gcl), torch.from_numpy(cnt),
        torch.from_numpy(codes), torch.from_numpy(a), torch.from_numpy(bv),
        torch.from_numpy(bias), bs, True, _every_group(len(gcl)))
    dots = np.einsum("gid,grd->gir", qg.double().numpy(), codes[gcl].astype(np.float64))
    want = dots * a[gcl][:, None] + qsum[:, :, None] * bv[gcl][:, None] + bias[gcl][:, None]
    dead = np.isneginf(want)
    np.testing.assert_array_equal(np.isneginf(out.numpy()), dead)
    assert np.isfinite(out.numpy()[~dead]).all()
    np.testing.assert_allclose(out.numpy()[~dead], want[~dead], atol=1e-5, rtol=0)
    g, qt, cap = out.shape
    assert torch.equal(bmax, out.view(g, qt, cap // bs, bs).amax(-1))
    # every slot at or past its cluster's count scores -inf
    past = np.arange(cap)[None] >= cnt[gcl][:, None]
    assert dead[np.broadcast_to(past[:, None, :], dead.shape)].all()


def test_plain_kernel_refuses_a_live_slot_past_counts():
    """The kernel reads nothing at or past counts[c], so a finite bias
    there would make it another function than the plain one: the plain
    version asserts the precondition on the CPU."""
    qg, qsum, gcl, cnt, codes, a, bv, bias = _kernel_inputs((128, 70, 0), seed=9)
    bias[1, 100] = 0.0
    with pytest.raises(AssertionError, match="counts"):
        grouped_scan.grouped_scores(
            qg, torch.from_numpy(qsum), torch.from_numpy(gcl), torch.from_numpy(cnt),
            torch.from_numpy(codes), torch.from_numpy(a), torch.from_numpy(bv),
            torch.from_numpy(bias), 128, False, _every_group(len(gcl)))


def test_scan_with_folded_rows_from_the_caller_equals_folding_here():
    """grouped_scan takes the folded sidecar rows from its caller, or folds
    on its own: the same result either way."""
    _, pt, v = make_pair(n_per=30, k=24, d=64)
    q = v[::37][:12] + 0.01
    own = port_scan(pt, q, 3, 10, "flat")
    folded = grouped_scan.fold_sidecars(pt.buckets, pt.counts_dev, pt.bucket_mask)
    s, gslot = grouped_scan.ivf_scan_grouped(
        torch.from_numpy(q), pt.centroids_n, pt.buckets, pt.counts_dev,
        pt.bucket_mask, nprobe=3, k=10, epilogue="flat", folded=folded)
    np.testing.assert_array_equal(own[0], s.numpy())
    np.testing.assert_array_equal(own[1], gslot.numpy())


def _probes(b, nprobe, kk, seed):
    """Seeded probe lists (distinct clusters a query) with about 40% of
    the probes not valid, and one query whose probes are all invalid."""
    rng = np.random.default_rng(seed)
    probed = np.argsort(rng.random((b, kk)), axis=1)[:, :nprobe].astype(np.int32)
    valid = rng.random((b, nprobe)) > 0.4
    valid[0] = False
    return probed, valid


@pytest.mark.parametrize("nprobe", [1, 3, 16])
@pytest.mark.parametrize("epilogue", ["flat", "blockexact"])
def test_probe_valid_matches_pallas_probed(epilogue, nprobe):
    """grouped_scan with probe_valid (on the CPU, the kernel's plain
    version on groups whose invalid pairs carry the out-of-range cluster
    id) against pallas_scan.ivf_scan_pallas_probed in interpret mode: an
    invalid probe scores -inf on both sides."""
    jx, pt, v = make_pair()
    q = (v[::53][:9] + 0.01).astype(np.float32)
    probed, valid = _probes(len(q), nprobe, pt.k_clusters, seed=nprobe)
    s_j, g_j = pallas_scan.ivf_scan_pallas_probed(
        jnp.asarray(q), jx.buckets, jx.counts_dev, jx.bucket_mask,
        jnp.asarray(probed), jnp.asarray(valid), 8, interpret=True,
        approx=False, epilogue=epilogue,
    )
    qn = torch.nn.functional.normalize(torch.from_numpy(q), dim=-1)
    s_p, g_p = grouped_scan.grouped_scan(
        qn, qn.sum(-1), pt.buckets, pt.counts_dev, pt.bucket_mask,
        torch.from_numpy(probed), 8, epilogue=epilogue,
        probe_valid=torch.from_numpy(valid),
    )
    assert np.isneginf(s_p[0].numpy()).all()
    assert_topk_match(s_p.numpy(), g_p.numpy(), np.asarray(s_j), np.asarray(g_j))
    # a finite hit comes from a valid probe of its query
    cap = pt.cap
    for r in range(len(q)):
        fin = np.isfinite(s_p[r].numpy())
        assert set(g_p[r].numpy()[fin] // cap) <= set(probed[r][valid[r]])


def test_gather_formulation_with_probe_valid_matches_jax():
    """The port's _scan_probed (the XLA gather formulation) with
    probe_valid against the JAX package's, and against the grouped scan."""
    from vectorsearch_tpu.index import ivf as jax_ivf

    jx, pt, v = make_pair()
    q = (v[::41][:10] + 0.01).astype(np.float32)
    probed, valid = _probes(len(q), 6, pt.k_clusters, seed=7)
    s_j, g_j = jax_ivf._scan_probed(
        jnp.asarray(q), jx.buckets, jx.counts_dev, jx.bucket_mask,
        jnp.asarray(probed), jnp.asarray(valid), 10,
    )
    s_p, g_p = port_ivf._scan_probed(
        torch.from_numpy(q), pt.buckets, pt.counts_dev, pt.bucket_mask,
        torch.from_numpy(probed), 10, probe_valid=torch.from_numpy(valid),
    )
    assert_topk_match(s_p.numpy(), g_p.numpy(), np.asarray(s_j), np.asarray(g_j))
    qn = torch.nn.functional.normalize(torch.from_numpy(q), dim=-1)
    s_g, g_g = grouped_scan.grouped_scan(
        qn, qn.sum(-1), pt.buckets, pt.counts_dev, pt.bucket_mask,
        torch.from_numpy(probed), 10, probe_valid=torch.from_numpy(valid),
    )
    assert_topk_match(s_p.numpy(), g_p.numpy(), s_g.numpy(), g_g.numpy(), atol=1e-5)


def test_plain_kernel_scores_groups_without_a_cluster_as_neg_inf():
    """A group whose cluster id lies outside [0, K) scores -inf in every
    slot and block (the kernel reads nothing for it); the other groups are
    what they are without it."""
    qg, qsum, gcl, cnt, codes, a, bv, bias = _kernel_inputs((128, 70, 33), seed=4)
    args = [torch.from_numpy(x) for x in (qsum, gcl, cnt, codes, a, bv, bias)]
    base, bmax_base = grouped_scan.grouped_scores(qg, *args, 64, True, _every_group(len(gcl)))
    gcl_out = gcl.copy()
    gcl_out[[1, 4]] = (-1, 3)
    args[1] = torch.from_numpy(gcl_out)
    out, bmax = grouped_scan.grouped_scores(qg, *args, 64, True, _every_group(len(gcl)))
    assert torch.isneginf(out[[1, 4]]).all() and torch.isneginf(bmax[[1, 4]]).all()
    keep = [0, 2, 3, 5, 6]
    assert torch.equal(out[keep], base[keep]) and torch.equal(bmax[keep], bmax_base[keep])
