"""The port's k-means pass (kernels/kmeans.py) against the JAX package's:
the Pallas kernels in interpret mode (assign_accumulate_pallas) and the
XLA Lloyd's body (_assign_and_accumulate, use_pallas=False), on the cases
of tests/test_pallas_kmeans.py plus one with D not a multiple of 16.

The host side of the chunked accumulate kernel runs here too: the launch
plan (route, chunk length, scratch rows), the segment table by the kernel's
rule against numpy's searchsorted, and the two passes' bookkeeping (which
run goes to its cluster's row, which to which partial row, which partials a
cluster adds) in plain PyTorch against accumulate_ref at the edges of the
design.

The JAX side gets its K padded to _k_pad_class with a -inf kmask and 5
invalid tail rows; the port gets the real K and only the valid rows.

Tolerances:
- cid equal except at near-ties, where the port's f32 sims at the two ids
  lie within 1e-5 (exact products, f32 sums in another order);
- counts equal, on the clusters no near-tie row moved between;
- sums within atol 1e-3 of the XLA path, which sums the same f32 values;
  against the Pallas kernel within 1e-3 plus 2^-16 times the sum of |v|
  over the cluster's members: the TPU kernel splits each value v into hi
  + lo bf16, about 16 mantissa bits.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorsearch_tpu.build.kmeans import _assign_and_accumulate, _k_pad_class
from vectorsearch_tpu.kernels.pallas_kmeans import assign_accumulate_pallas
from vectorsearch_tpu.quant import layout
from vectorsearch_tpu.quant.layout import PackedVectors
from vectorsearch_tpu_torch.kernels import kmeans as km

tk = importlib.import_module("vectorsearch_tpu_torch.build.kmeans")

N_INVALID = 5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def make_data(n, k, d, seed=3):
    """tests/test_pallas_kmeans.py's blobs."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32) * 4
    v = centers[rng.integers(0, k, size=n)] + rng.normal(size=(n, d)).astype(np.float32)
    return layout.pack_float(v.astype(np.float32))


def jax_pass(oracle, packed, init, k_real):
    """The JAX pass over all n rows (the last N_INVALID invalid) with K
    padded to its size class."""
    n, d = packed.codes.shape
    k_pad = _k_pad_class(k_real)
    cents = jnp.asarray(np.pad(init, ((0, k_pad - k_real), (0, 0))))
    kmask = np.where(np.arange(k_pad) < k_real, 0.0, -np.inf).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-N_INVALID:] = False
    if oracle == "pallas":
        flat = PackedVectors(*[jnp.asarray(a) for a in packed])
        out = assign_accumulate_pallas(
            flat, jnp.asarray(valid), cents, jnp.asarray(kmask), interpret=True
        )
    else:
        tiles = PackedVectors(*[jnp.asarray(a).reshape((1,) + np.shape(a)) for a in packed])
        out = _assign_and_accumulate(
            tiles, jnp.asarray(valid).reshape(1, n), cents, jnp.int32(k_real), None,
            use_pallas=False,
        )
    sums, counts, cid = (np.asarray(a) for a in out)
    assert not counts[k_real:].any()
    return sums[:k_real], counts[:k_real], cid.reshape(-1)[: n - N_INVALID]


@pytest.mark.parametrize("oracle", ["pallas", "xla"])
@pytest.mark.parametrize(
    "k_real,n,d", [(12, 2048, 128), (5, 1024, 128), (200, 4096, 128), (12, 2048, 100)]
)
def test_pass_matches_jax(oracle, k_real, n, d):
    packed = make_data(n, max(k_real, 12), d)
    init = np.random.default_rng(0).normal(size=(k_real, d)).astype(np.float32) * 4
    sums_j, counts_j, cid_j = jax_pass(oracle, packed, init, k_real)

    live = PackedVectors(*[np.asarray(a)[: n - N_INVALID] for a in packed])
    rows, _ = tk.prepare_tiles(live, 1024, "cpu")
    cents = torch.from_numpy(init)
    sums_t, counts_t, cid_t = (a.numpy() for a in km.assign_accumulate_ref(rows, cents, 1024))

    moved = np.nonzero(cid_t != cid_j)[0]
    if moved.size:
        _, csum, cn_bf16 = km._normalize(cents)
        sims = km.assign_scores_ref(
            PackedVectors(*[a[torch.from_numpy(moved)] for a in rows]), cn_bf16, csum
        ).numpy()
        r = np.arange(moved.size)
        gap = np.abs(sims[r, cid_t[moved]] - sims[r, cid_j[moved]]).max()
        assert gap <= 1e-5, f"{moved.size} rows differ, widest gap {gap}"
    assert moved.size <= n // 200
    keep = np.ones(k_real, bool)
    keep[cid_t[moved]] = keep[cid_j[moved]] = False
    np.testing.assert_array_equal(counts_t[keep], counts_j[keep])
    if oracle == "xla":
        np.testing.assert_allclose(sums_t[keep], sums_j[keep], rtol=0, atol=1e-3)
    else:
        v = layout.unpack(live)
        abs_sum = np.zeros((k_real, d), np.float64)
        np.add.at(abs_sum, cid_t, np.abs(v))
        bound = 1e-3 + abs_sum * 2.0**-16
        assert (np.abs(sums_t - sums_j) <= bound)[keep].all()


def _cpu_case(n=700, d=40, kk=9):
    packed = make_data(n, 12, d)
    rows, _ = tk.prepare_tiles(packed, 256, "cpu")
    cents = torch.from_numpy(np.random.default_rng(1).normal(size=(kk, d)).astype(np.float32))
    return rows, cents


def test_wrappers_on_cpu_run_the_plain_versions():
    """CPU tensors take the plain versions, bit for bit, and launch
    nothing; the whole pass is the composition of the two."""
    rows, cents = _cpu_case()
    _, csum, cn_bf16 = km._normalize(cents)
    before = (km.ASSIGN_LAUNCHES, km.ACCUMULATE_LAUNCHES)
    cid = km.assign(rows, cn_bf16, csum, chunk=256)
    assert cid.dtype == torch.int32
    assert torch.equal(cid, km.assign_ref(rows, cn_bf16, csum, chunk=256))
    sums, counts = km.accumulate(rows, cid, 9, chunk=256)
    ref_sums, ref_counts = km.accumulate_ref(rows, cid, 9, chunk=256)
    assert torch.equal(sums, ref_sums) and torch.equal(counts, ref_counts)
    whole = km.assign_accumulate(rows, cents, 256)
    for got, want in zip(whole, (sums, counts, cid)):
        assert torch.equal(got, want)
    assert (km.ASSIGN_LAUNCHES, km.ACCUMULATE_LAUNCHES) == before


def test_accumulate_drops_out_of_range_ids():
    """A row whose cid lies outside [0, K) counts nowhere."""
    rows, _ = _cpu_case()
    cid = torch.zeros(rows.n, dtype=torch.int32)
    cid[:10] = -1
    cid[10:20] = 9
    sums, counts = km.accumulate(rows, cid, 9)
    assert counts.tolist() == [rows.n - 20] + [0.0] * 8
    v = rows.offset[20:, None] + rows.scale[20:, None] * rows.codes[20:].float()
    torch.testing.assert_close(sums[0], v.sum(0), rtol=1e-5, atol=1e-3)


def _runs(*runs):
    return [c for c, m in runs for _ in range(m)]


C = 8  # the chunk length of the edge cases below
EDGE_CIDS = {
    "N=0": (5, []),
    "N=1": (5, [2]),
    "N=chunk-1": (5, _runs((0, 3), (4, 4))),
    "N=chunk": (5, _runs((1, 8))),
    "N=chunk+1": (5, _runs((1, 4), (3, 5))),
    "K=1": (1, _runs((0, 29))),
    "one cluster holds every row": (7, _runs((3, 45))),
    "every cluster empty but the last": (9, _runs((8, 21))),
    "clusters end on chunk boundaries": (7, _runs((0, 8), (1, 16), (3, 8), (4, 24), (6, 16))),
    "a cluster over 4 chunks among 3-member ones": (
        13, _runs(*[(k, 3) for k in range(6)], (6, 30), *[(k, 3) for k in range(7, 13)])),
    "a cluster that begins with a chunk and goes on": (4, _runs((0, 8), (2, 11), (3, 2))),
    "ids out of range at both ends": (
        4, [-(2 ** 31), -1, -1, 0, 0, 0, 1, 3, 3, 3, 3, 3, 3, 3, 4, 5, 2 ** 31 - 1]),
    "out of range ids only": (3, [-2, -1, 3, 9]),
}


@pytest.mark.parametrize("label", list(EDGE_CIDS))
def test_segment_table_matches_searchsorted(label):
    """seg[k] by the kernel's rule = numpy's searchsorted of k in the
    sorted ids, empty clusters and out-of-range ids included."""
    kk, ids = EDGE_CIDS[label]
    sorted_cid = torch.tensor(sorted(ids), dtype=torch.int32)
    seg = km.segments_ref(sorted_cid, kk)
    want = np.searchsorted(np.sort(np.asarray(ids, np.int64)), np.arange(kk + 1), "left")
    assert seg.shape == (kk + 1,)
    np.testing.assert_array_equal(seg.numpy(), want)


@pytest.mark.parametrize("d", [16, 100])
@pytest.mark.parametrize("label", list(EDGE_CIDS))
def test_chunked_passes_match_plain(label, d):
    """The chunked kernels' bookkeeping in plain PyTorch (shuffled rows, 8
    members a chunk) against accumulate_ref: every cluster's row written
    once, counts equal, sums within rtol 1e-5 / atol 1e-4 (f32 sums of the
    same values in another order), and only runs cut by a chunk's edge go
    through the scratch."""
    kk, ids = EDGE_CIDS[label]
    n = len(ids)
    rng = np.random.default_rng(n + kk)
    rows = PackedVectors(
        torch.from_numpy(rng.integers(-128, 128, (n, d), dtype=np.int8)),
        torch.from_numpy(rng.random(n, dtype=np.float32) * 0.05),
        torch.from_numpy(rng.standard_normal(n, dtype=np.float32)),
        torch.ones(n))
    cid = torch.tensor(ids, dtype=torch.int32)[torch.from_numpy(rng.permutation(n))]
    sums, counts, written = km.accumulate_chunks_ref(rows, cid, kk, C)
    ref_sums, ref_counts = km.accumulate_ref(rows, cid, kk)
    assert not torch.isnan(sums).any()
    assert torch.equal(counts, ref_counts)
    torch.testing.assert_close(sums, ref_sums, rtol=1e-5, atol=1e-4)
    # the scratch rows written: the clusters that span chunks, one a chunk
    live = sorted(i for i in ids if 0 <= i < kk)
    spans = [(live.index(k) // C, (len(live) - 1 - live[::-1].index(k)) // C)
             for k in sorted(set(live))]
    assert len(written) == sum(c1 - c0 + 1 for c0, c1 in spans if c1 > c0)
    assert len(set(written)) == len(written)


@pytest.mark.parametrize("n,d,want", [
    (1_000_000, 768, ("chunks", 512, 3908)),
    (10_000_000, 768, ("chunks", 512, 39064)),
    (196_608, 768, ("chunks", 256, 1536)),
    (60_000, 768, ("chunks", 128, 938)),
    (0, 768, ("chunks", 64, 0)),
    (1, 16, ("chunks", 64, 2)),
    (5000, 100, ("loads", 0, 0)),
    (5000, 6144, ("chunks", 64, 158)),
    (5000, 6160, ("loads", 0, 0)),
])
def test_accumulate_plan(n, d, want, monkeypatch):
    """Rows of D % 16 == 0 up to 6144 dims go to the chunked kernel, in
    chunks of 64 to 512 members with two scratch rows a chunk; any other D
    to the plain-load kernel. A forced schedule overrides the rule."""
    assert km.accumulate_plan(n, d) == want
    monkeypatch.setattr(km, "ACCUMULATE_SCHEDULE", ("loads", 0, 0))
    assert km.accumulate_plan(n, d) == ("loads", 0, 0)
    monkeypatch.setattr(km, "ACCUMULATE_SCHEDULE", ("", 128, 0))
    if want[0] == "chunks":
        assert km.accumulate_plan(n, d) == ("chunks", 128, 2 * -(-n // 128))


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """Only CPU tensors take the plain versions; anything else must be a
    CUDA launch or an error (a meta tensor stands in for a device the
    kernels do not run on)."""
    rows, cents = _cpu_case()
    meta = PackedVectors(*[a.to("meta") for a in rows])
    _, csum, cn_bf16 = km._normalize(cents)
    with pytest.raises(ValueError, match="CUDA device"):
        km.assign(meta, cn_bf16.to("meta"), csum.to("meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        km.accumulate(meta, torch.zeros(rows.n, dtype=torch.int32, device="meta"), 9)


def test_lloyd_runs_every_pass_through_the_kernel_module(monkeypatch):
    """build/kmeans.py reaches the kernels' wrapper for every Lloyd's
    pass (on the card that is both kernels, at any K)."""
    calls = []
    real = km.assign_accumulate

    def spy(rows, centroids, chunk):
        calls.append(tuple(centroids.shape))
        return real(rows, centroids, chunk)

    monkeypatch.setattr(km, "assign_accumulate", spy)
    packed = make_data(600, 6, 32)
    res = tk.lloyd(packed, tk.sample_init(packed, 6, seed=1), max_iters=7, chunk=128,
                   device="cpu")
    assert len(calls) == res.iterations and calls[0] == (6, 32)
