"""The CUDA kernels on the card: each against its plain version, on its
main path, and the wrappers' refusals. Every test here needs an NVIDIA
GPU and nvcc and skips without one. This file imports no jax (the machine
with the card has none), so it runs there as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py

Tolerances, kernel vs plain:
- grouped scan: atol 1e-4, since the products are exact in f32 and only
  the order of the f32 sums differs; block maxima are exact;
- k-means assign: the same cid except at near-ties, where the plain
  version's sims at the two ids lie within 1e-5 (exact products, f32 sums
  in another order);
- k-means accumulate: for the same cid, equal counts and sums within
  rtol 1e-5 / atol 1e-4 (f32 sums in another order); two launches give
  bit-identical sums; the same at every edge of the chunked kernel (N
  around a chunk's length, clusters cut by chunk edges, empty clusters, ids
  out of range) and through the plain-load kernel;
- flat bands: s8 bit-equal (exact integer dots, the plain version's
  roundings), also where |dot| passes 2^24; bf16 within atol 1e-4 (f32
  sums in another order) with the same -inf pattern; the same under every
  block and ring shape;
- the flat index's band route (FlatIndex.search at refine > 0) against the
  streamed route on the card (tests/flat_route_cases.py): never worse at
  any rank by f64 cosine, equal under assert_hits_match (scores atol 1e-5)
  wherever the streamed route returns the exact top k, which at refine 32
  is every query; a scan cut into many launches gives the one launch's
  scores bit for bit.
"""
import functools
import importlib

import numpy as np
import pytest
import torch

import flat_route_cases as routes
from vectorsearch_tpu_torch.index import IVFIndex
from vectorsearch_tpu_torch.kernels import _build, cosine, grouped_scan
from vectorsearch_tpu_torch.kernels import flat as tf
from vectorsearch_tpu_torch.kernels import kmeans as km
from vectorsearch_tpu_torch.quant import layout
from vectorsearch_tpu_torch.quant.layout import PackedVectors

# the package exports a `kmeans` function that shadows the module name
tk = importlib.import_module("vectorsearch_tpu_torch.build.kmeans")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _inputs(device, g, qt, kk, cap, d, seed, counts=None):
    """qg, qsum, gcl, counts, codes, a, bv, bias: seeded, a tenth of the
    slots tombstoned, bias -inf at and past each cluster's count (`counts`
    is cycled over the clusters; random in [0, cap] when None)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    codes = torch.randint(-128, 128, (kk, cap, d), generator=gen, device=device,
                          dtype=torch.int8)
    a, bv = (torch.rand((kk, cap), generator=gen, device=device) * 0.01
             for _ in range(2))
    if counts is None:
        cnt = torch.randint(0, cap + 1, (kk,), generator=gen, device=device).to(torch.int32)
    else:
        cnt = torch.tensor([counts[i % len(counts)] for i in range(kk)],
                           dtype=torch.int32, device=device)
    live = torch.rand((kk, cap), generator=gen, device=device) > 0.1
    col = torch.arange(cap, device=device)
    bias = torch.where(live & (col[None] < cnt[:, None]), 0.0, float("-inf")).float()
    q = torch.randn((g, qt, d), generator=gen, device=device)
    q = q / q.norm(dim=-1, keepdim=True)
    gcl = torch.randint(0, kk, (g,), generator=gen, device=device, dtype=torch.int32)
    gcl[: min(g, kk)] = torch.arange(min(g, kk), dtype=torch.int32, device=device)
    return [q.bfloat16(), q.sum(-1), gcl, cnt, codes, a, bv, bias]


def _every(args):
    """The group count on the card under which every group of `args`
    counts."""
    return torch.tensor([args[0].shape[0]], dtype=torch.int32, device=args[0].device)


@pytest.mark.parametrize(
    "qt,want_bmax,cap,d,counts",
    [(8, False, 256, 128, None), (16, True, 256, 128, None), (32, True, 256, 128, None),
     (16, True, 192, 80, None),  # cap % 128 != 0: 64-column blocks
     (8, True, 512, 128, (0, 512, 100, 129, 70, 448, 64)),  # empty, full, ragged
     (32, True, 384, 128, (127, 128, 129, 384, 1, 0, 383)),
     (16, True, 192, 80, (192, 100, 128, 65, 0, 1, 191)),
     (8, True, 64, 128, (64, 0, 33, 1, 63, 32, 2)),
     (32, True, 1024, 768, (1000, 300, 1024, 0, 5, 129, 640)),  # the served width
     (32, True, 256, 3072, (256, 100, 0, 129, 1, 255, 128)),  # query rows streamed
     (8, True, 256, 3072, (200, 256, 129, 0, 1, 64, 255))],
)
def test_kernel_matches_plain(cuda, qt, want_bmax, cap, d, counts):
    g, kk = 19, 7
    bs = 128 if cap % 128 == 0 else 64
    args = _inputs(cuda, g, qt, kk, cap, d, seed=qt + d, counts=counts)
    before = grouped_scan.LAUNCHES
    out, bmax = grouped_scan.grouped_scores(*args, bs, want_bmax, _every(args))
    ref, _ = grouped_scan.grouped_scores_ref(*args, bs, False, _every(args))
    torch.cuda.synchronize()
    assert grouped_scan.LAUNCHES == before + 1
    assert torch.equal(torch.isneginf(out), torch.isneginf(ref))
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    past = torch.arange(cap, device=cuda)[None] >= args[3][args[2].long()][:, None]
    assert torch.isneginf(out[past[:, None, :].expand_as(out)]).all()
    if want_bmax:
        assert torch.equal(bmax, out.view(g, qt, cap // bs, bs).amax(-1))
    else:
        assert bmax is None


@pytest.mark.parametrize("g", [1, 8, 200, 400, 1700])
def test_kernel_matches_plain_at_every_block_shape(cuda, g):
    """The launch gives a block 1, 2, 4 or 8 tiles by the number of groups:
    the same scores at each."""
    args = _inputs(cuda, g, 8, 40, 3072, 64, seed=g)
    out, bmax = grouped_scan.grouped_scores(*args, 128, True, _every(args))
    ref, _ = grouped_scan.grouped_scores_ref(*args, 128, False, _every(args))
    torch.cuda.synchronize()
    assert torch.equal(torch.isneginf(out), torch.isneginf(ref))
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    assert torch.equal(bmax, out.view(g, 8, 24, 128).amax(-1))


def test_group_without_cluster_scores_nothing(cuda):
    """A group whose cluster id lies outside [0, K) reads no codes and
    scores -inf everywhere."""
    args = _inputs(cuda, 3, 8, 4, 128, 64, seed=5, counts=(128,))
    args[2][1] = -1
    args[2][2] = 4
    out, bmax = grouped_scan.grouped_scores(*args, 128, True, _every(args))
    torch.cuda.synchronize()
    for lost in (1, 2):
        assert torch.isneginf(out[lost]).all() and torch.isneginf(bmax[lost]).all()
    assert torch.isfinite(out[0]).any()


def _launch_into(args, gcount, out, bmax, bs):
    """vs_grouped_scores on `args` into the caller's `out` and `bmax`, so
    that what the kernel leaves unwritten shows."""
    qg, qsum, gcl, counts, codes, a, bv, bias = args
    g, qt, d = qg.shape
    kk, cap, _ = codes.shape
    err = _build.load().vs_grouped_scores(
        qg.data_ptr(), qsum.data_ptr(), gcl.data_ptr(), gcount.data_ptr(), counts.data_ptr(),
        codes.data_ptr(), a.data_ptr(), bv.data_ptr(), bias.data_ptr(),
        out.data_ptr(), bmax.data_ptr(), g, qt, d, kk, cap, bs,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0


@pytest.mark.parametrize("qt,cap,d,live", [
    (8, 512, 128, 11), (16, 256, 768, 1), (32, 384, 128, 0), (8, 3072, 64, 1699)])
def test_kernel_leaves_the_groups_past_the_count(cuda, qt, cap, d, live):
    """With a group count on the card below the grid's groups, the rows
    below it are what the kernel writes without a count, bit for bit, and
    match grouped_scores_ref's with the same count; the rows at or past it
    keep the NaN written before the launch, in the scores and the maxima."""
    g = max(live + 7, 19)
    args = _inputs(cuda, g, qt, 7, cap, d, seed=live + qt)
    bs = 128
    gcount = torch.tensor([live], dtype=torch.int32, device=cuda)
    out = torch.full((g, qt, cap), float("nan"), device=cuda)
    bmax = torch.full((g, qt, cap // bs), float("nan"), device=cuda)
    _launch_into(args, gcount, out, bmax, bs)
    full, full_bmax = grouped_scan.grouped_scores(*args, bs, True, _every(args))
    ref, _ = grouped_scan.grouped_scores_ref(*args, bs, False, gcount)
    torch.cuda.synchronize()
    assert torch.isnan(out[live:]).all() and torch.isnan(bmax[live:]).all()
    assert torch.equal(out[:live], full[:live]) and torch.equal(bmax[:live], full_bmax[:live])
    assert torch.isneginf(ref[live:]).all()
    assert torch.equal(torch.isneginf(out[:live]), torch.isneginf(ref[:live]))
    torch.testing.assert_close(out[:live], ref[:live], atol=1e-4, rtol=0)


def test_read_back(cuda):
    """read_back gives what to_host gives, after one wait, in memory of its
    own."""
    from vectorsearch_tpu_torch.device import read_back, to_host

    t = torch.randn(512, 10, device=cuda)
    i = torch.arange(5120, device=cuda).view(512, 10)
    s, ids = read_back(t, i)
    np.testing.assert_array_equal(s, to_host(t))
    np.testing.assert_array_equal(ids, to_host(i))
    assert s.flags.owndata and ids.flags.owndata


def test_kernel_library_abi_version(cuda):
    assert _build.load().vs_abi_version() == 7


def test_ivf_search_on_card_matches_cpu(cuda):
    """The whole search path on the card (probe, group build, kernel,
    flat and blockexact epilogues, refine) against the same index on the
    CPU: refined scores atol 1e-5, and the same ids above the near-ties
    at each row's cut."""
    rng = np.random.default_rng(0)
    k, d = 48, 96
    centers = rng.normal(size=(k, d)).astype(np.float32) * 4
    v = (centers[:, None] + rng.normal(size=(k, 100, d))).reshape(-1, d)
    packed = layout.pack_float(v.astype(np.float32))
    ids = np.arange(1, len(v) + 1, dtype=np.int64)
    q = v[::97] + 0.01
    gpu = IVFIndex.build(packed, ids, centers, device=cuda)
    cpu = IVFIndex.build(packed, ids, centers, device="cpu")
    before = grouped_scan.LAUNCHES
    for nprobe in (1, 4, 40):  # 40 * cap 1024 > 32768 columns: blockexact
        s_g, i_g = gpu.search(q, k=10, nprobe=nprobe, refine=32)
        s_c, i_c = cpu.search(q, k=10, nprobe=nprobe, refine=32)
        np.testing.assert_allclose(s_g, s_c, atol=1e-5)
        for sg, ig, sc, ic in zip(s_g, i_g, s_c, i_c):
            cut = sg.min() + 1e-5
            assert set(ig[sg > cut]) == set(ic[sc > cut])
    assert grouped_scan.LAUNCHES >= before + 3


def test_sharded_ivf_on_two_shards_of_one_card_matches_cpu(cuda):
    """ShardedIVF on 2 shards of one card (the grouped-scan kernel on each
    shard, its invalid probes grouped under an out-of-range cluster)
    against the same replica on 2 CPU shards (the plain version): coarse
    and refined scores atol 1e-4 / 1e-5, the same ids above the near-ties
    at each row's cut, one kernel launch a shard a search."""
    from vectorsearch_tpu_torch.index import assign_clusters
    from vectorsearch_tpu_torch.parallel import Mesh, ShardedIVF

    rng = np.random.default_rng(3)
    k, d = 41, 128
    centers = rng.normal(size=(k, d)).astype(np.float32) * 4
    v = (centers[:, None] + rng.normal(size=(k, 60, d))).reshape(-1, d)
    packed = layout.pack_float(v.astype(np.float32))
    ids = np.arange(1, len(v) + 1, dtype=np.int64)
    assign = assign_clusters(packed, centers, device="cpu")
    q = v[::53] + 0.01
    gpu = ShardedIVF.build(Mesh((cuda, cuda)), packed, ids, centers, assignments=assign)
    cpu = ShardedIVF.build(Mesh(("cpu", "cpu")), packed, ids, centers, assignments=assign)
    before, searches = grouped_scan.LAUNCHES, 0
    for nprobe in (1, 4, 33, -1):  # 21 * cap 1024 > 32768 columns: blockexact
        for refine, atol in ((0, 1e-4), (32, 1e-5)):
            s_g, i_g = gpu.search(q, k=10, nprobe=nprobe, refine=refine)
            s_c, i_c = cpu.search(q, k=10, nprobe=nprobe, refine=refine)
            searches += 1
            np.testing.assert_allclose(s_g, s_c, atol=atol)
            for sg, ig, sc, ic in zip(s_g, i_g, s_c, i_c):
                cut = sg.min() + atol
                assert set(ig[sg > cut]) == set(ic[sc > cut])
    assert grouped_scan.LAUNCHES == before + 2 * searches


def test_no_library_raises(cuda, monkeypatch):
    """No kernel library -> an error, never the plain version, from every
    wrapper."""

    def no_library():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "library_path", no_library)
    before = grouped_scan.LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc"):
        args = _inputs(cuda, 2, 8, 3, 64, 16, 0)
        grouped_scan.grouped_scores(*args, 64, False, _every(args))
    assert grouped_scan.LAUNCHES == before
    rows = _rows_on(cuda, 1000, 512)
    cn_bf16, csum = _centroids_on(cuda, 5, 512, seed=0)
    before = (km.ASSIGN_LAUNCHES, km.ACCUMULATE_LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        km.assign(rows, cn_bf16, csum)
    with pytest.raises(RuntimeError, match="nvcc"):
        km.accumulate(rows, torch.zeros(1000, dtype=torch.int32, device=cuda), 5)
    assert (km.ASSIGN_LAUNCHES, km.ACCUMULATE_LAUNCHES) == before
    s8, bf16 = _flat_args(cuda, 1000, 512, 8)
    before = (tf.S8_LAUNCHES, tf.BF16_LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        tf.flat_bands_s8(*s8)
    with pytest.raises(RuntimeError, match="nvcc"):
        tf.flat_bands_bf16(*bf16)
    assert (tf.S8_LAUNCHES, tf.BF16_LAUNCHES) == before


def test_rejects_bad_input(cuda):
    args = _inputs(cuda, 2, 8, 3, 64, 16, 0)
    every = _every(args)
    bad = list(args)
    bad[4] = bad[4].float()  # codes must be int8
    with pytest.raises(ValueError, match="codes"):
        grouped_scan.grouped_scores(*bad, 64, False, every)
    for wrong in (args[3].long(), args[3][:2], args[3].float()):  # type, shape
        bad = list(args)
        bad[3] = wrong
        with pytest.raises(ValueError, match="counts"):
            grouped_scan.grouped_scores(*bad, 64, False, every)
    for wrong in (every.long(), every.repeat(2)):  # the group count: type, shape
        with pytest.raises(ValueError, match="gcount"):
            grouped_scan.grouped_scores(*args, 64, False, wrong)
    with pytest.raises(ValueError, match="CUDA device"):
        grouped_scan.grouped_scores(*args[:3], args[3].cpu(), *args[4:], 64, False, every)
    with pytest.raises(ValueError, match="CUDA device"):
        grouped_scan.grouped_scores(*args, 64, False, every.cpu())
    bad = list(args)
    bad[0] = torch.zeros((2, 12, 16), dtype=torch.bfloat16, device=cuda)
    bad[1] = torch.zeros((2, 12), device=cuda)
    with pytest.raises(ValueError, match="QT"):
        grouped_scan.grouped_scores(*bad, 64, False, every)
    with pytest.raises(ValueError, match="CUDA device"):
        grouped_scan.grouped_scores(*args[:4], args[4].cpu(), *args[5:], 64, False, every)


# ---------------------------------------------------------------- k-means


@functools.lru_cache(maxsize=None)
def _packed_blobs(n, d, seed=0):
    """Seeded clustered rows, packed by the codec (numpy, host)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((64, d), dtype=np.float32) * 2
    v = centers[rng.integers(0, 64, size=n)] + rng.standard_normal((n, d), dtype=np.float32)
    return layout.pack_float(v)


def _rows_on(device, n, d):
    return PackedVectors(*[torch.from_numpy(np.ascontiguousarray(a)).to(device)
                           for a in _packed_blobs(n, d)])


def _centroids_on(device, kk, d, seed):
    rng = np.random.default_rng(seed)
    cn, csum, cn_bf16 = km._normalize(
        torch.from_numpy(rng.standard_normal((kk, d), dtype=np.float32)).to(device))
    return cn_bf16.contiguous(), csum.contiguous()


def assert_near_ties_only(rows, cn_bf16, csum, got, want, atol=1e-5):
    """cid equal to the plain one except where the plain version's sims
    at the two ids lie within atol."""
    diff = torch.nonzero(got != want).flatten()
    if diff.numel():
        sims = km.assign_scores_ref(PackedVectors(*[a[diff] for a in rows]), cn_bf16, csum)
        s_want = sims.gather(1, want[diff].long()[:, None])
        s_got = sims.gather(1, got[diff].long()[:, None])
        gap = float((s_want - s_got).abs().max())
        assert gap <= atol, f"{diff.numel()} rows differ, widest gap {gap}"
    assert diff.numel() <= 1 + got.numel() // 1000


@pytest.mark.parametrize("d", [100, 512, 768])
@pytest.mark.parametrize("n", [1, 1000, 65537])
@pytest.mark.parametrize("kk", [1, 5, 1024, 4096, 16384])
def test_kmeans_kernels_match_plain(cuda, kk, n, d):
    rows = _rows_on(cuda, n, d)
    cn_bf16, csum = _centroids_on(cuda, kk, d, seed=kk + d)
    a0, c0 = km.ASSIGN_LAUNCHES, km.ACCUMULATE_LAUNCHES
    cid = km.assign(rows, cn_bf16, csum)
    want = km.assign_ref(rows, cn_bf16, csum, chunk=4096)
    torch.cuda.synchronize()
    assert cid.dtype == torch.int32 and cid.shape == (n,)
    assert bool(((cid >= 0) & (cid < kk)).all())
    assert_near_ties_only(rows, cn_bf16, csum, cid, want)
    sums, counts = km.accumulate(rows, cid, kk)
    ref_sums, ref_counts = km.accumulate_ref(rows, cid, kk, chunk=4096)
    torch.cuda.synchronize()
    assert (km.ASSIGN_LAUNCHES, km.ACCUMULATE_LAUNCHES) == (a0 + 1, c0 + 1)
    assert torch.equal(counts, ref_counts)
    torch.testing.assert_close(sums, ref_sums, rtol=1e-5, atol=1e-4)


def test_assign_exact_ties_take_the_lowest_k(cuda):
    """Centroid 5 copied to 6 (the same K tile, another lane), 300 (the
    next 256-centroid tile) and K - 1: equal sims, so every row whose
    nearest is 5 must get 5, and no row gets a copy."""
    n, d, kk = 20_000, 768, 1000
    rows = _rows_on(cuda, n, d)
    gen = torch.Generator(device=cuda).manual_seed(7)
    pick = torch.randperm(n, generator=gen, device=cuda)[:kk]
    cents = rows.offset[pick, None] + rows.scale[pick, None] * rows.codes[pick].float()
    for copy in (6, 300, kk - 1):
        cents[copy] = cents[5]
    _, csum, cn_bf16 = km._normalize(cents)
    cn_bf16, csum = cn_bf16.contiguous(), csum.contiguous()
    cid = km.assign(rows, cn_bf16, csum)
    want = km.assign_ref(rows, cn_bf16, csum, chunk=4096)
    torch.cuda.synchronize()
    assert int((want == 5).sum()) > 0
    assert torch.equal(cid[want == 5], want[want == 5])
    assert not bool(((cid == 6) | (cid == 300) | (cid == kk - 1)).any())
    assert_near_ties_only(rows, cn_bf16, csum, cid, want)


@pytest.mark.parametrize("d", [100, 768])
@pytest.mark.parametrize("n,kk", [(129, 257), (4095, 511), (70_001, 300)])
def test_assign_ragged_tiles(cuda, n, kk, d):
    """N not a multiple of the 128-row tile, K not a multiple of the
    256-centroid tile (and D not of 16 at d=100: the wrapper pads)."""
    rows = _rows_on(cuda, n, d)
    cn_bf16, csum = _centroids_on(cuda, kk, d, seed=n + kk)
    cid = km.assign(rows, cn_bf16, csum)
    want = km.assign_ref(rows, cn_bf16, csum, chunk=4096)
    torch.cuda.synchronize()
    assert bool(((cid >= 0) & (cid < kk)).all())
    assert_near_ties_only(rows, cn_bf16, csum, cid, want)


@pytest.mark.parametrize("d", [1024, 1280, 1296, 3072])
def test_assign_wide_rows(cuda, d):
    """Up to D = 1280 the 128-row code tile stays resident in shared
    memory (fewer cn stages as D grows); from D = 1296 the codes stream
    through the ring with each cn slice."""
    rows = _rows_on(cuda, 3000, d)
    cn_bf16, csum = _centroids_on(cuda, 600, d, seed=d)
    cid = km.assign(rows, cn_bf16, csum)
    want = km.assign_ref(rows, cn_bf16, csum, chunk=4096)
    torch.cuda.synchronize()
    assert_near_ties_only(rows, cn_bf16, csum, cid, want)


def test_assign_1m_rows_4096_centroids(cuda):
    """The main path's largest Lloyd pass at the 1M build: 1M x 768 rows
    against 4096 centroids drawn from them."""
    n, d, kk = 1_000_000, 768, 4096
    rows = _rows_on(cuda, n, d)
    gen = torch.Generator(device=cuda).manual_seed(11)
    pick = torch.randperm(n, generator=gen, device=cuda)[:kk]
    cents = rows.offset[pick, None] + rows.scale[pick, None] * rows.codes[pick].float()
    _, csum, cn_bf16 = km._normalize(cents)
    cn_bf16, csum = cn_bf16.contiguous(), csum.contiguous()
    cid = km.assign(rows, cn_bf16, csum)
    want = km.assign_ref(rows, cn_bf16, csum, chunk=65_536)
    torch.cuda.synchronize()
    assert_near_ties_only(rows, cn_bf16, csum, cid, want)


def test_accumulate_is_deterministic(cuda):
    """Two launches on the same input give bit-identical sums (no float
    atomics), and an empty cluster gets zero sums and a zero count."""
    n, d, kk = 200_000, 768, 1024
    rows = _rows_on(cuda, n, d)
    gen = torch.Generator(device=cuda).manual_seed(3)
    cid = torch.randint(0, kk - 1, (n,), generator=gen, device=cuda, dtype=torch.int32)
    s1, c1 = km.accumulate(rows, cid, kk)
    s2, c2 = km.accumulate(rows, cid, kk)
    torch.cuda.synchronize()
    assert torch.equal(s1, s2) and torch.equal(c1, c2)
    assert float(c1[-1]) == 0 and not bool(s1[-1].any())
    assert float(c1.sum()) == n


def _runs(*runs):
    return [c for c, m in runs for _ in range(m)]


def _accumulate_edges(c):
    """(label, K, D, cids or N for random ones) at `c` member rows a chunk."""
    twelves = [(k, 12) for k in range(20)]
    return [
        *[(f"N={n}", 5, 768, n) for n in (0, 1, c - 1, c, c + 1)],
        ("K=1", 1, 768, _runs((0, 10 * c + 3))),
        ("one cluster holds every row", 7, 768, _runs((3, 20 * c + 5))),
        ("every cluster empty but the last", 9, 3072, _runs((8, 3 * c + 7))),
        ("clusters end on chunk boundaries", 7, 16,
         _runs((0, c), (1, 2 * c), (3, c), (4, 3 * c), (6, 2 * c))),
        ("a cluster begins with a chunk and goes on", 4, 768,
         _runs((0, c), (2, c + 9), (3, 2))),
        ("a cluster over 4 chunks among 12-member ones", 41, 768,
         _runs(*twelves, (20, 3 * c + 40), *[(k, 12) for k in range(21, 41)])),
        ("ids out of range at both ends", 6, 768, "out of range"),
        ("D=100", 4, 100, 5 * c + 1),
        ("D=3072", 300, 3072, 5 * c + 1),
        ("D=6144", 9, 6144, 2 * c + 1),
        ("D=6160", 9, 6160, 2 * c + 1),
        ("D=16", 3, 16, 5 * c + 1),
    ]


ACCUMULATE_EDGES = [(c, *case) for c in (64, 512) for case in _accumulate_edges(c)]


@pytest.mark.parametrize("c,label,kk,d,ids", ACCUMULATE_EDGES,
                         ids=[f"{c}-{case[0]}" for c, *case in ACCUMULATE_EDGES])
def test_accumulate_edges_match_plain_twice(cuda, monkeypatch, c, label, kk, d, ids):
    """The accumulate kernels at the edges of the chunked design, `c`
    member rows a chunk forced: counts equal to the plain version's, sums
    within rtol 1e-5 / atol 1e-4, and a second launch bit for bit the
    first. D=100 and D=6160 take the plain-load kernel."""
    n = ids if isinstance(ids, int) else 6 * c + 11 if isinstance(ids, str) else len(ids)
    gen = torch.Generator(device=cuda).manual_seed(n + 31 * kk + d)
    rows = PackedVectors(
        torch.randint(-128, 128, (n, d), generator=gen, device=cuda, dtype=torch.int8),
        torch.rand((n,), generator=gen, device=cuda) * 0.05,
        torch.rand((n,), generator=gen, device=cuda) + 0.5,  # sums grow with N
        torch.ones((n,), device=cuda))
    if isinstance(ids, int):
        cid = torch.randint(0, kk, (n,), generator=gen, device=cuda, dtype=torch.int32)
    elif isinstance(ids, str):
        cid = torch.randint(-3, kk + 3, (n,), generator=gen, device=cuda, dtype=torch.int32)
        cid[:2] = torch.tensor([-(2 ** 31), 2 ** 31 - 1], dtype=torch.int32, device=cuda)
    else:
        cid = torch.tensor(ids, dtype=torch.int32, device=cuda)[
            torch.randperm(n, generator=gen, device=cuda)]
    monkeypatch.setattr(km, "ACCUMULATE_SCHEDULE", ("", c, 0))
    want_route = "chunks" if d % 16 == 0 and d <= km.CHUNKS_MAX_DIM else "loads"
    assert km.accumulate_plan(n, d)[0] == want_route
    before = km.ACCUMULATE_LAUNCHES
    s1, c1 = km.accumulate(rows, cid, kk)
    s2, c2 = km.accumulate(rows, cid, kk)
    ref_sums, ref_counts = km.accumulate_ref(rows, cid, kk, chunk=4096)
    torch.cuda.synchronize()
    assert km.ACCUMULATE_LAUNCHES == before + 2
    assert torch.equal(c1, ref_counts)
    torch.testing.assert_close(s1, ref_sums, rtol=1e-5, atol=1e-4)
    assert torch.equal(s1, s2) and torch.equal(c1, c2)


@pytest.mark.parametrize("schedule", [("loads", 0, 0), ("chunks", 1024, 1), ("chunks", 128, 8),
                                      ("chunks", 64, 2)])
def test_accumulate_under_every_route_and_ring(cuda, monkeypatch, schedule):
    """The same sums, within tolerance, from the plain-load kernel and
    from the chunked one under other chunk lengths and ring depths."""
    n, d, kk = 70_001, 768, 300
    rows = _rows_on(cuda, n, d)
    gen = torch.Generator(device=cuda).manual_seed(9)
    cid = torch.randint(-1, kk + 1, (n,), generator=gen, device=cuda, dtype=torch.int32)
    ref_sums, ref_counts = km.accumulate_ref(rows, cid, kk, chunk=4096)
    monkeypatch.setattr(km, "ACCUMULATE_SCHEDULE", schedule)
    sums, counts = km.accumulate(rows, cid, kk)
    again, _ = km.accumulate(rows, cid, kk)
    torch.cuda.synchronize()
    assert torch.equal(counts, ref_counts)
    torch.testing.assert_close(sums, ref_sums, rtol=1e-5, atol=1e-4)
    assert torch.equal(sums, again)


@pytest.mark.parametrize("schedule", [("chunks", 100, 0), ("chunks", 64, 9), ("chunks", 33, 0)])
def test_accumulate_refuses_a_bad_schedule(cuda, monkeypatch, schedule):
    rows = _rows_on(cuda, 1000, 512)
    monkeypatch.setattr(km, "ACCUMULATE_SCHEDULE", schedule)
    before = km.ACCUMULATE_LAUNCHES
    with pytest.raises(RuntimeError, match="cudaError"):
        km.accumulate(rows, torch.zeros(1000, dtype=torch.int32, device=cuda), 5)
    assert km.ACCUMULATE_LAUNCHES == before


def test_assign_accumulate_pass_matches_plain(cuda):
    """The whole pass (normalize, bf16 cast, both kernels) against
    assign_accumulate_ref on the same rows and centroids."""
    rows = _rows_on(cuda, 65537, 768)
    cents = torch.from_numpy(
        np.random.default_rng(5).standard_normal((1024, 768), dtype=np.float32)).to(cuda)
    sums, counts, cid = km.assign_accumulate(rows, cents, 8192)
    ref_sums, ref_counts, ref_cid = km.assign_accumulate_ref(rows, cents, 4096)
    torch.cuda.synchronize()
    _, csum, cn_bf16 = km._normalize(cents)
    assert_near_ties_only(rows, cn_bf16, csum, cid, ref_cid)
    # clusters that a near-tie row moved between are left out
    keep = torch.ones(1024, dtype=torch.bool, device=cuda)
    moved = cid != ref_cid
    keep[cid[moved].long()] = False
    keep[ref_cid[moved].long()] = False
    assert torch.equal(counts[keep], ref_counts[keep])
    torch.testing.assert_close(sums[keep], ref_sums[keep], rtol=1e-5, atol=1e-4)


def test_kmeans_wrappers_refuse_bad_input(cuda):
    rows = _rows_on(cuda, 1000, 512)
    cn_bf16, csum = _centroids_on(cuda, 5, 512, seed=0)
    with pytest.raises(ValueError, match="CUDA device"):
        km.assign(PackedVectors(rows.codes.cpu(), *rows[1:]), cn_bf16, csum)
    with pytest.raises(ValueError, match="cn"):
        km.assign(rows, cn_bf16.float(), csum)
    with pytest.raises(ValueError, match="codes"):
        km.assign(PackedVectors(rows.codes.float(), *rows[1:]), cn_bf16, csum)
    cid = torch.zeros(1000, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="cid"):
        km.accumulate(rows, cid.long(), 5)
    with pytest.raises(ValueError, match="CUDA device"):
        km.accumulate(rows, cid.cpu(), 5)


def test_lloyd_on_card_matches_cpu(cuda):
    """lloyd on the card (both kernels) against lloyd on the CPU (their
    plain versions) from the same seeded blobs and initial centroids:
    assignment agreement >= 0.99 and equal iterations."""
    rng = np.random.default_rng(0)
    k, d = 6, 128  # test_torch_kmeans.py's blobs: stable under any f32 sum order
    centers = rng.normal(size=(k, d)).astype(np.float32) * 8
    v = np.concatenate(
        [c + rng.normal(size=(200, d)).astype(np.float32) for c in centers])
    packed = layout.pack_float(v)
    init = tk.sample_init(packed, k, seed=1)
    a0, c0 = km.ASSIGN_LAUNCHES, km.ACCUMULATE_LAUNCHES
    gpu = tk.lloyd(packed, init, max_iters=50, chunk=1024, device=cuda)
    cpu = tk.lloyd(packed, init, max_iters=50, chunk=1024, device="cpu")
    assert (gpu.assignments == cpu.assignments).mean() >= 0.99
    assert gpu.iterations == cpu.iterations
    assert km.ASSIGN_LAUNCHES - a0 == gpu.iterations
    assert km.ACCUMULATE_LAUNCHES - c0 == gpu.iterations


# ------------------------------------------------------------- flat bands


def _flat_args(device, n, d, b):
    """Arguments of the two band kernels on seeded clustered rows, a tenth
    of them dead, and queries near corpus rows: (s8 args, bf16 args)."""
    packed = _packed_blobs(n, d)
    rng = np.random.default_rng(n + d + b)
    v = layout.unpack(packed)
    qn = v[rng.integers(0, n, size=b)] + 0.1 * rng.standard_normal((b, d), dtype=np.float32)
    qn = cosine.l2_normalize(torch.from_numpy(qn).to(device))
    rows = PackedVectors(*[torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in packed])
    live = torch.from_numpy(rng.random(n) > 0.1).to(device)
    corpus = (rows.codes, rows.scale * rows.inv_norm, rows.offset * rows.inv_norm,
              torch.where(live, 0.0, float("-inf")))
    qc, sq, qsum = cosine.quantize_queries(qn)
    return (qc, sq, qsum, *corpus), (qn.bfloat16(), qsum, *corpus)


def assert_bands_match(use_s8, out, ref):
    """s8 bit-equal; bf16 within 1e-4 with the same -inf pattern."""
    assert out.shape == ref.shape and not torch.isnan(out).any()
    if use_s8:
        assert torch.equal(out, ref)
    else:
        assert torch.equal(torch.isneginf(out), torch.isneginf(ref))
        fin = torch.isfinite(ref)
        torch.testing.assert_close(out[fin], ref[fin], atol=1e-4, rtol=0)


def _bands(use_s8, s8, bf16):
    """(kernel bands, plain bands) of one variant."""
    if use_s8:
        return tf.flat_bands_s8(*s8), tf.flat_bands_s8_ref(*s8, chunk=8192)
    return tf.flat_bands_bf16(*bf16), tf.flat_bands_bf16_ref(*bf16, chunk=8192)


@pytest.mark.parametrize("b", [1, 63, 64, 65, 129, 512])
@pytest.mark.parametrize("n", [1, 127, 1023, 1024, 1025, 65537])
@pytest.mark.parametrize("d", [16, 100, 768])
@pytest.mark.parametrize("use_s8", [True, False], ids=["s8", "bf16"])
def test_flat_bands_match_plain(cuda, use_s8, d, n, b):
    """Corpus sizes off the 1024- and 128-row grids, batches around the
    64- and 128-query blocks, a width that the wrapper pads (100)."""
    s8, bf16 = _flat_args(cuda, n, d, b)
    before = (tf.S8_LAUNCHES, tf.BF16_LAUNCHES)
    out, ref = _bands(use_s8, s8, bf16)
    torch.cuda.synchronize()
    assert (tf.S8_LAUNCHES, tf.BF16_LAUNCHES) == (before[0] + use_s8,
                                                  before[1] + (not use_s8))
    assert out.shape == (b, -(-n // 1024) * 128)
    assert_bands_match(use_s8, out, ref)


@pytest.mark.parametrize("use_s8", [True, False], ids=["s8", "bf16"])
def test_flat_bands_131073_rows_twice(cuda, use_s8):
    """128 tiles and one row at the served width and batch; two launches
    bit-equal."""
    s8, bf16 = _flat_args(cuda, 131_073, 768, 512)
    out, ref = _bands(use_s8, s8, bf16)
    again, _ = _bands(use_s8, s8, bf16)
    torch.cuda.synchronize()
    assert_bands_match(use_s8, out, ref)
    assert torch.equal(out, again)


# (D, B): the shapes the launch rule picks from. 128 resident queries (8
# stages s8, 2 bf16 at D=768; 7 and 5 at D=128), 64 resident queries for a
# small batch, 64 because 128 do not fit (bf16 D=1024, s8 D=3072), and query
# rows streamed through the ring (bf16 D=3072 at both block sizes, s8 D=4096)
BLOCK_SHAPES = [(128, 200), (768, 130), (768, 40), (1024, 200), (3072, 200), (3072, 40),
                (4096, 130)]
# (tile lanes, stages, queries a block): the rule, one block walking every
# tile, one tile a block, forced block sizes and ring depths
SCHEDULES = [(0, 0, 0), (1, 0, 0), (1000, 0, 0), (3, 2, 0), (0, 2, 64), (0, 0, 128),
             (2, 3, 64)]


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("d,b", BLOCK_SHAPES)
@pytest.mark.parametrize("use_s8", [True, False], ids=["s8", "bf16"])
def test_flat_bands_at_every_block_and_ring_shape(cuda, monkeypatch, use_s8, d, b, schedule):
    """The same bands under every query-block size, residency and ring
    depth the launch rule can pick, and under forced schedules (a ring
    deeper than a shape has room for is refused, not shortened)."""
    s8, bf16 = _flat_args(cuda, 5000, d, b)
    monkeypatch.setattr(tf, "SCHEDULE", schedule)
    try:
        out, ref = _bands(use_s8, s8, bf16)
    except RuntimeError as e:
        assert schedule[1] > 2 and "cudaError 1" in str(e), e
        return
    torch.cuda.synchronize()
    assert_bands_match(use_s8, out, ref)


def test_flat_s8_worst_case_magnitude(cuda):
    """Codes of -128 against query codes of +-127 at D=3072: |dot| reaches
    127 * 128 * 3072 ~ 5e7, past 2^24, where int32 -> f32 rounds. Still
    bit-equal to the plain version's exact integer dots."""
    n, d, b = 2500, 3072, 70
    gen = torch.Generator(device=cuda).manual_seed(0)
    codes = torch.full((n, d), -128, dtype=torch.int8, device=cuda)
    codes[torch.rand((n,), generator=gen, device=cuda) < 0.5] = 127
    codes[::7, ::5] = 3
    qc = torch.full((b, d), 127, dtype=torch.int8, device=cuda)
    qc[1::2] = -127
    qc[2::3, ::11] = 126
    sq = torch.rand((b,), generator=gen, device=cuda) * 1e-4
    qsum = torch.randn((b,), generator=gen, device=cuda)
    a, bv = (torch.rand((n,), generator=gen, device=cuda) * 0.01 for _ in range(2))
    bias = torch.zeros((n,), device=cuda)
    args = (qc, sq, qsum, codes, a, bv, bias)
    dots = cosine._int_dots(qc, codes)
    assert float(dots.abs().max()) > 2**24
    out, ref = tf.flat_bands_s8(*args), tf.flat_bands_s8_ref(*args, chunk=8192)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("use_s8", [True, False], ids=["s8", "bf16"])
def test_flat_search_on_card_matches_cpu(cuda, use_s8):
    """flat_search on the card (band kernel, exact band top-k, rescore)
    against the same call on the CPU (the plain band version), with
    tombstones and a partial last tile: refined scores atol 1e-5, the same
    ids above the near-ties at each row's cut, no id twice."""
    n, d = 20_000, 128
    packed = _packed_blobs(n, d)
    rng = np.random.default_rng(9)
    q = layout.unpack(packed)[rng.integers(0, n, size=64)] + 0.05
    mask = rng.random(n) > 0.1
    out = []
    for dev in (cuda, torch.device("cpu")):
        rows = PackedVectors(*[torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in packed])
        s, i = tf.flat_search(torch.from_numpy(q).to(dev), rows, n - 100, k=10,
                              valid_mask=torch.from_numpy(mask).to(dev), use_s8=use_s8)
        out.append((s.cpu().numpy(), i.cpu().numpy()))
    (s_g, i_g), (s_c, i_c) = out
    np.testing.assert_allclose(s_g, s_c, atol=1e-5)
    assert np.isfinite(s_g).all() and mask[i_g].all() and (i_g < n - 100).all()
    for sg, ig, sc, ic in zip(s_g, i_g, s_c, i_c):
        assert len(set(ig)) == len(ig)
        cut = sg.min() + 1e-5
        assert set(ig[sg > cut]) == set(ic[sc > cut])


def test_flat_wrappers_refuse_bad_input(cuda):
    s8, bf16 = _flat_args(cuda, 1000, 128, 8)
    with pytest.raises(ValueError, match="qc"):
        tf.flat_bands_s8(s8[0].float(), *s8[1:])
    with pytest.raises(ValueError, match="codes"):
        tf.flat_bands_s8(*s8[:3], s8[3][:, :64].contiguous(), *s8[4:])
    with pytest.raises(ValueError, match="bias"):
        tf.flat_bands_s8(*s8[:6], s8[6][:-1])
    with pytest.raises(ValueError, match="CUDA device"):
        tf.flat_bands_s8(*s8[:3], s8[3].cpu(), *s8[4:])
    with pytest.raises(ValueError, match="q must"):
        tf.flat_bands_bf16(bf16[0].float(), *bf16[1:])
    with pytest.raises(ValueError, match="contiguous"):
        tf.flat_bands_bf16(bf16[0], bf16[1], bf16[2].t().contiguous().t(), *bf16[3:])


@pytest.mark.parametrize("schedule", [(0, 9, 0), (0, 1, 0), (-1, 0, 0), (0, 0, 96)])
def test_flat_kernels_refuse_a_bad_schedule(cuda, monkeypatch, schedule):
    """More stages than the ring may have, a ring of one, negative tile
    lanes, a block size no kernel has: the launch fails, nothing runs."""
    s8, bf16 = _flat_args(cuda, 1000, 128, 8)
    monkeypatch.setattr(tf, "SCHEDULE", schedule)
    before = (tf.S8_LAUNCHES, tf.BF16_LAUNCHES)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        tf.flat_bands_s8(*s8)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        tf.flat_bands_bf16(*bf16)
    assert (tf.S8_LAUNCHES, tf.BF16_LAUNCHES) == before


@functools.lru_cache(maxsize=None)
def _route_case(n, b):
    """Rows and queries of the flat configuration's law at D=768; the ids
    to tombstone: every 13th row from the sixth, and the first query's best
    row where a row would be left."""
    v, q = routes.law(n, b, seed=n * 1000 + b)
    dead = np.arange(n, dtype=np.int64)[5::13] + 100
    if n > 1:
        best = routes.index(v, [], "cpu").search(q[:1], k=1)[1][0, 0]
        dead = np.union1d(dead, [best])
    return v, q, dead


@pytest.mark.parametrize("refine", [10, 32])
@pytest.mark.parametrize("n", [1, 1023, 1025, 65537])
@pytest.mark.parametrize("b", [1, 7, 512])
def test_flat_index_band_route_matches_streamed(cuda, b, n, refine):
    """FlatIndex.search(k=10, refine) on the card, capacity past n, with
    tombstones: one s8 band launch, and the streamed route's answers, or
    better ones where the streamed route's coarse top m missed a row."""
    v, q, dead = _route_case(n, b)
    f = routes.index(v, dead, cuda)
    assert f.capacity > f.n == n
    before = tf.S8_LAUNCHES
    band = f.search(q, k=10, refine=refine)
    assert tf.S8_LAUNCHES - before == 1
    assert not np.isin(band[1], dead).any()
    routes.compare_routes(f, q, band, routes.streamed(f, q, 10, refine), 10, refine)


@pytest.mark.parametrize("refine", [10, 32])
def test_flat_index_band_route_in_chunks(cuda, monkeypatch, refine):
    """The launch budget cut to 8 tiles at B=512: 9 launches over 65,537
    rows, each chunk's top bands merged, against the one launch."""
    v, q, dead = _route_case(65537, 512)
    f = routes.index(v, dead, cuda)
    one = f.search(q, k=10, refine=refine)
    monkeypatch.setattr(tf, "BAND_BYTES", 8 * tf.BAND_LANES * 4 * 512)
    before = tf.S8_LAUNCHES
    many = f.search(q, k=10, refine=refine)
    assert tf.S8_LAUNCHES - before == 9
    routes.assert_hits_match(many, one)
    np.testing.assert_array_equal(many[0], one[0])
