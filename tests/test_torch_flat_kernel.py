"""The port's band-max flat search (kernels/flat.py) against the JAX
package's flat_search_pallas in interpret mode, on the data of
tests/test_pallas_flat.py (5000 x 128 gaussian corpus, seed 0, B=8), for
both band variants; and each plain band version against a numpy band
maximum of the affine scores.

Tolerances:
- returned scores within 1e-5 of JAX's: both are exact f32 rescores of
  the same rows;
- id sets equal per query, except entries within 1e-5 of the k-th score
  (near-ties at the cut); sets and scores are compared, never positions;
- s8 bands bit-equal to a numpy f32 evaluation in the same order (exact
  integer dots); bf16 bands within 1e-5 of a float64 evaluation of the
  same bf16-rounded operands (f32 sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorsearch_tpu.index import FlatIndex as JaxFlat
from vectorsearch_tpu.kernels.pallas_flat import flat_search_pallas
from vectorsearch_tpu.quant import layout
from vectorsearch_tpu.quant.layout import PackedVectors
from vectorsearch_tpu_torch import convert
from vectorsearch_tpu_torch.kernels import cosine
from vectorsearch_tpu_torch.kernels import flat as tf

ATOL = 1e-5
VARIANTS = pytest.mark.parametrize("use_s8", [True, False], ids=["s8", "bf16"])


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(5000, 128)).astype(np.float32)
    packed = layout.pack_float(corpus)
    queries = rng.normal(size=(8, 128)).astype(np.float32)
    return corpus, packed, queries


def _jax(queries, packed, n_valid, k, k_bands, use_s8, mask=None):
    s, i = flat_search_pallas(
        jnp.asarray(queries), PackedVectors(*[jnp.asarray(a) for a in packed]),
        jnp.int32(n_valid), k=k, k_bands=k_bands,
        valid_mask=None if mask is None else jnp.asarray(mask),
        interpret=True, use_s8=use_s8,
    )
    return np.asarray(s), np.asarray(i)


def _port(queries, packed, n_valid, k, k_bands, use_s8, mask=None):
    s, i = tf.flat_search(
        torch.from_numpy(queries), PackedVectors(*[torch.as_tensor(a) for a in packed]),
        n_valid, k=k, k_bands=k_bands,
        valid_mask=None if mask is None else torch.as_tensor(mask), use_s8=use_s8,
    )
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    return s.numpy(), i.numpy()


def assert_hits_match(port, jax, atol=ATOL):
    """Scores within atol rank by rank; the finite id sets equal except
    entries within atol of the row's last finite score; no id twice."""
    (s_p, i_p), (s_j, i_j) = port, jax
    np.testing.assert_allclose(s_p, s_j, atol=atol)
    for sp, ip, sj, ij in zip(s_p, i_p, s_j, i_j):
        fin = np.isfinite(sp)
        assert len(set(ip)) == len(ip), ip
        if not fin.any():
            continue
        cut = sp[fin].min()
        for x in set(ip[fin]) ^ set(ij[np.isfinite(sj)]):
            near = np.concatenate([sp[ip == x], sj[ij == x]])
            assert (near <= cut + atol).all(), (x, near, cut)


@VARIANTS
def test_matches_jax_and_exact_scan(data, use_s8):
    corpus, packed, queries = data
    got = _port(queries, packed, 5000, 10, 64, use_s8)
    assert_hits_match(got, _jax(queries, packed, 5000, 10, 64, use_s8))
    # the exact-scan overlap, and exact f32 cosines of the returned rows
    _, i_ref = cosine.scan_topk_streamed(
        torch.from_numpy(queries), PackedVectors(*[torch.as_tensor(a) for a in packed]),
        5000, k=10)
    overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(i_ref.numpy(), got[1])])
    assert overlap >= 0.9, overlap
    deq = layout.unpack(packed)
    exact = (queries / np.linalg.norm(queries, axis=-1, keepdims=True)) @ (
        deq / np.linalg.norm(deq, axis=-1, keepdims=True)).T
    np.testing.assert_allclose(got[0], np.take_along_axis(exact, got[1], axis=-1), atol=1e-4)


@VARIANTS
def test_respects_n_valid(data, use_s8):
    _, packed, queries = data
    got = _port(queries, packed, 100, 5, 32, use_s8)
    assert (got[1] < 100).all()
    assert_hits_match(got, _jax(queries, packed, 100, 5, 32, use_s8))


@VARIANTS
def test_tombstoned_best_row(data, use_s8):
    _, packed, queries = data
    _, i0 = _port(queries[:1], packed, 5000, 1, 32, use_s8)
    dead = int(i0[0, 0])
    mask = np.ones(5000, bool)
    mask[dead] = False
    got = _port(queries[:1], packed, 5000, 5, 32, use_s8, mask)
    assert dead not in got[1][0]
    assert_hits_match(got, _jax(queries[:1], packed, 5000, 5, 32, use_s8, mask))


@VARIANTS
def test_small_corpus_fewer_than_k(use_s8):
    """N=5, k=10: the bands of the one partial tile expand to rows past
    N, which must enter dead, not as copies of row N - 1."""
    rng = np.random.default_rng(1)
    corpus = rng.normal(size=(5, 64)).astype(np.float32)
    packed = layout.pack_float(corpus)
    s, i = got = _port(corpus[:1], packed, 5, 10, 16, use_s8)
    assert np.isfinite(s[0, :5]).all() and np.isneginf(s[0, 5:]).all()
    assert sorted(i[0, :5]) == [0, 1, 2, 3, 4]
    assert len(set(i[0])) == 10
    assert_hits_match(got, _jax(corpus[:1], packed, 5, 10, 16, use_s8))


@VARIANTS
def test_flat_index_with_deletes_carried_over(data, use_s8):
    """A JAX FlatIndex (capacity past n, tombstones) carried across by
    convert.flat_from_arrays: the same search on both sides."""
    _, packed, queries = data
    ids = np.arange(10, 5010, dtype=np.int64)
    jf = JaxFlat.create(128)
    for lo in range(0, 5000, 1700):
        jf = jf.append(PackedVectors(*[a[lo : lo + 1700] for a in packed]), ids[lo : lo + 1700])
    _, best = _jax(queries, jf.packed, jf.n, 3, 64, use_s8, jf.mask)
    jf = jf.remove_ids(ids[best[:, 0]])
    pf = convert.flat_from_arrays(convert._flat_arrays(jf), "cpu")
    assert pf.capacity > pf.n == 5000 and pf.live == jf.live < 5000
    got = tf.flat_search(torch.from_numpy(queries), pf.packed, pf.n, k=10,
                         valid_mask=pf.mask, use_s8=use_s8)
    got = tuple(t.numpy() for t in got)
    assert not np.isin(got[1], best[:, 0]).any()
    assert_hits_match(got, _jax(queries, jf.packed, jf.n, 10, 64, use_s8, jf.mask))


# ------------------------------------------------------- plain band versions


def _band_case(b=5, n=2500, d=100, seed=4):
    """Packed rows with D % 16 != 0 and N % 1024 != 0, some dead."""
    rng = np.random.default_rng(seed)
    packed = layout.pack_float(rng.normal(size=(n, d)).astype(np.float32))
    qn = rng.normal(size=(b, d)).astype(np.float32)
    qn /= np.linalg.norm(qn, axis=-1, keepdims=True)
    a = packed.scale * packed.inv_norm
    bv = packed.offset * packed.inv_norm
    bias = np.where(rng.random(n) < 0.1, -np.inf, 0.0).astype(np.float32)
    return packed, qn, a, bv, bias


def _numpy_bands(scores):
    """Band maxima [b, tiles * 128] of [b, n] scores, rows past n -inf."""
    b, n = scores.shape
    t = -(-n // 1024)
    padded = np.full((b, t * 1024), -np.inf, scores.dtype)
    padded[:, :n] = scores
    return padded.reshape(b, t, 8, 128).max(axis=2).reshape(b, t * 128)


@pytest.mark.parametrize("chunk", [1024, tf.DEFAULT_CHUNK])
def test_plain_s8_bands_match_numpy(chunk):
    packed, qn, a, bv, bias = _band_case()
    qc, sq, qsum = (t.numpy() for t in cosine.quantize_queries(torch.from_numpy(qn)))
    dots = (qc.astype(np.int64) @ packed.codes.astype(np.int64).T).astype(np.float32)
    want = _numpy_bands((sq[:, None] * a[None]) * dots + qsum[:, None] * bv[None] + bias[None])
    got = tf.flat_bands_s8_ref(*map(torch.from_numpy, (qc, sq, qsum, packed.codes, a, bv, bias)),
                               chunk=chunk)
    assert got.shape == (5, 3 * 128)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("chunk", [1024, tf.DEFAULT_CHUNK])
def test_plain_bf16_bands_match_numpy(chunk):
    packed, qn, a, bv, bias = _band_case()
    q = torch.from_numpy(qn).bfloat16()
    qsum = qn.sum(-1)
    dots = q.double().numpy() @ packed.codes.astype(np.float64).T
    want = _numpy_bands(a[None] * dots + qsum[:, None].astype(np.float64) * bv[None] + bias[None])
    got = tf.flat_bands_bf16_ref(q, *map(torch.from_numpy, (qsum, packed.codes, a, bv, bias)),
                                 chunk=chunk).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=ATOL)


def test_wrappers_on_cpu_run_the_plain_versions():
    """CPU tensors take the plain versions, bit for bit, and launch
    nothing."""
    packed, qn, a, bv, bias = _band_case()
    corpus = [torch.from_numpy(x) for x in (packed.codes, a, bv, bias)]
    qc, sq, qsum = cosine.quantize_queries(torch.from_numpy(qn))
    q = torch.from_numpy(qn).bfloat16()
    before = (tf.S8_LAUNCHES, tf.BF16_LAUNCHES)
    assert torch.equal(tf.flat_bands_s8(qc, sq, qsum, *corpus),
                       tf.flat_bands_s8_ref(qc, sq, qsum, *corpus))
    assert torch.equal(tf.flat_bands_bf16(q, qsum, *corpus),
                       tf.flat_bands_bf16_ref(q, qsum, *corpus))
    assert (tf.S8_LAUNCHES, tf.BF16_LAUNCHES) == before


# ------------------------------------------- plain band versions, edge shapes

# (label, N, B, D, dead): dead is a fraction of random rows, or a (lo, hi)
# range of dead rows
EDGE_CASES = [
    ("one row", 1, 1, 16, 0.0),
    ("below one group", 127, 1, 128, 0.1),
    ("one short of a tile", 1023, 3, 100, 0.1),
    ("a whole tile", 1024, 2, 64, 0.1),
    ("a tile and a row", 1025, 4, 16, 0.1),
    ("off both grids", 2500, 5, 100, 0.1),
    ("wide rows", 1300, 2, 3072, 0.1),
    ("a dead tile", 3100, 3, 48, (1024, 2048)),
    ("an all-dead corpus", 1500, 2, 32, (0, 1500)),
]
EDGES = pytest.mark.parametrize("case", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])


def _edge_case(case):
    _, n, b, d, dead = case
    packed, qn, a, bv, bias = _band_case(b=b, n=n, d=d, seed=n + d)
    if not isinstance(dead, float):
        bias = np.zeros(n, np.float32)
        bias[dead[0] : dead[1]] = -np.inf
    elif dead == 0.0:
        bias = np.zeros(n, np.float32)
    return packed, qn, a, bv, bias


@EDGES
def test_plain_s8_bands_at_edge_shapes(case):
    """Exact integer dots (int64), then the sidecars in f32 in the kernel's
    order of roundings: bit-equal."""
    packed, qn, a, bv, bias = _edge_case(case)
    qc, sq, qsum = (t.numpy() for t in cosine.quantize_queries(torch.from_numpy(qn)))
    dots = (qc.astype(np.int64) @ packed.codes.astype(np.int64).T).astype(np.float32)
    want = _numpy_bands((sq[:, None] * a[None]) * dots + qsum[:, None] * bv[None] + bias[None])
    got = tf.flat_bands_s8_ref(*map(torch.from_numpy, (qc, sq, qsum, packed.codes, a, bv, bias)))
    assert got.shape == (case[2], -(-case[1] // 1024) * 128)
    np.testing.assert_array_equal(got.numpy(), want)
    if not isinstance(case[4], float):
        lo, hi = case[4][0] // 1024 * 128, case[4][1] // 1024 * 128
        assert np.isneginf(got.numpy()[:, lo:hi]).all()


@EDGES
def test_plain_bf16_bands_at_edge_shapes(case):
    """The formula in float64 on the same bf16-rounded queries: within 1e-4
    (f32 sums in another order), the same -inf pattern."""
    packed, qn, a, bv, bias = _edge_case(case)
    q = torch.from_numpy(qn).bfloat16()
    qsum = qn.sum(-1)
    dots = q.double().numpy() @ packed.codes.astype(np.float64).T
    want = _numpy_bands(a[None] * dots + qsum[:, None].astype(np.float64) * bv[None] + bias[None])
    got = tf.flat_bands_bf16_ref(q, *map(torch.from_numpy, (qsum, packed.codes, a, bv, bias))).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-4)


@pytest.mark.parametrize("d", [16, 100, 104, 250])
def test_zero_padded_dims_give_equal_bands(d):
    """The wrappers pad D to a multiple of 16 with zero columns before a
    launch: the s8 bands stay bit-equal, the bf16 bands within 1e-5 (the
    f32 sums may be taken in another order)."""
    packed, qn, a, bv, bias = _band_case(b=4, n=1100, d=d, seed=d)
    corpus = [torch.from_numpy(x) for x in (a, bv, bias)]
    codes = torch.from_numpy(packed.codes)
    qc, sq, qsum = cosine.quantize_queries(torch.from_numpy(qn))
    q = torch.from_numpy(qn).bfloat16()
    codes_p, qc_p, q_p = (tf._pad_dims(t) for t in (codes, qc, q))
    assert codes_p.shape[1] % 16 == 0 and codes_p.shape[1] - d < 16
    assert (codes_p is codes) == (d % 16 == 0)
    assert not codes_p[:, d:].any() and not q_p[:, d:].any()
    assert torch.equal(tf.flat_bands_s8_ref(qc_p, sq, qsum, codes_p, *corpus),
                       tf.flat_bands_s8_ref(qc, sq, qsum, codes, *corpus))
    got = tf.flat_bands_bf16_ref(q_p, qsum, codes_p, *corpus)
    want = tf.flat_bands_bf16_ref(q, qsum, codes, *corpus)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], atol=ATOL, rtol=0)


@VARIANTS
def test_partial_last_tile_matches_jax(use_s8):
    """N = 2300 (two tiles and a quarter, the last group 124 rows short) at
    D = 64 with tombstones, rows past n_valid dead: the ids as sets, the
    refined scores within 1e-5."""
    rng = np.random.default_rng(7)
    packed = layout.pack_float(rng.normal(size=(2300, 64)).astype(np.float32))
    queries = rng.normal(size=(5, 64)).astype(np.float32)
    mask = rng.random(2300) > 0.1
    got = _port(queries, packed, 2250, 10, 64, use_s8, mask)
    assert mask[got[1]].all() and (got[1] < 2250).all()
    assert_hits_match(got, _jax(queries, packed, 2250, 10, 64, use_s8, mask))

