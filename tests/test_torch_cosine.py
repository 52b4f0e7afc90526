"""Each function of the port's kernels/cosine.py against the JAX package's
kernels/cosine.py on the same seeded inputs.

Tolerances: element-wise ops and exact-f32 products (l2_normalize,
quantize_queries, scores_f32, rescore_topk) agree within 1e-5; scores
from the int8 products (scores_int8, scores_packed, the scans) within
1e-5 as well, since the int8 contraction is exact on both sides;
nearest_centroid's bf16 centroid dot within 2e-3 (JAX's CPU dot may
differ in its bf16 handling), with argmax agreement away from near-ties.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorsearch_tpu.kernels import cosine as jc
from vectorsearch_tpu.quant import layout
from vectorsearch_tpu.quant.layout import PackedVectors
from vectorsearch_tpu_torch.kernels import cosine as tc


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def t(a):
    return torch.from_numpy(np.array(a))


def corpus(n=300, d=64, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, d)).astype(np.float32)
    v[3] = 0.0  # a zero vector stays zero and scores 0
    packed = layout.pack_float(v)
    return v, packed, PackedVectors(*[t(a) for a in packed])


def queries(b=7, d=64, seed=1, zero_row=False):
    """Seeded query rows; zero_row makes row 0 the zero vector (every
    score 0, so only tests that compare scores, not ids, use it)."""
    q = np.random.default_rng(seed).normal(size=(b, d)).astype(np.float32)
    if zero_row:
        q[0] = 0.0
    return q


def test_l2_normalize():
    q = queries(zero_row=True)
    np.testing.assert_allclose(
        tc.l2_normalize(t(q)).numpy(), np.asarray(jc.l2_normalize(jnp.asarray(q))),
        atol=1e-6,
    )


def test_quantize_queries():
    qn = np.asarray(jc.l2_normalize(jnp.asarray(queries(zero_row=True))))
    for got, want in zip(tc.quantize_queries(t(qn)), jc.quantize_queries(jnp.asarray(qn))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_scores_int8_and_packed():
    _, packed, tpacked = corpus()
    q = queries(zero_row=True)
    qn = np.asarray(jc.l2_normalize(jnp.asarray(q)))
    codes, scale, qsum = jc.quantize_queries(jnp.asarray(qn))
    want = np.asarray(jc.scores_int8(codes, scale, qsum, packed))
    got = tc.scores_int8(t(codes), t(scale), t(qsum), tpacked).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(
        tc.scores_packed(t(q), tpacked).numpy(),
        np.asarray(jc.scores_packed(jnp.asarray(q), packed)), atol=1e-5,
    )


def test_int_dots_wide_rows_exact():
    """Rows wider than EXACT_F32_DIM are contracted in exact int32 slices."""
    rng = np.random.default_rng(3)
    x = rng.integers(-127, 128, size=(3, 2100), dtype=np.int8)
    y = rng.integers(-127, 128, size=(5, 2100), dtype=np.int8)
    want = x.astype(np.int64) @ y.astype(np.int64).T
    np.testing.assert_array_equal(tc._int_dots(t(x), t(y)).numpy(), want)


def test_scores_f32():
    v, _, _ = corpus()
    q = queries()
    np.testing.assert_allclose(
        tc.scores_f32(t(q), t(v)).numpy(),
        np.asarray(jc.scores_f32(jnp.asarray(q), jnp.asarray(v))), atol=1e-5,
    )


def test_mask_topk_merge():
    rng = np.random.default_rng(4)
    s = rng.normal(size=(4, 50)).astype(np.float32)
    np.testing.assert_array_equal(
        tc.mask_invalid(t(s), 17).numpy(), np.asarray(jc.mask_invalid(jnp.asarray(s), 17))
    )
    ts, ti = tc.topk(t(s), 6)
    js, ji = jc.topk(jnp.asarray(s), 6)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    a_s, b_s = s[:, :20], s[:, 20:]
    a_i = np.arange(20, dtype=np.int32)[None].repeat(4, 0)
    b_i = (np.arange(30, dtype=np.int32) + 20)[None].repeat(4, 0)
    ms, mi = tc.merge_topk(t(a_s), t(a_i), t(b_s), t(b_i), 9)
    js, ji = jc.merge_topk(*map(jnp.asarray, (a_s, a_i, b_s, b_i)), 9)
    np.testing.assert_array_equal(ms.numpy(), np.asarray(js))
    np.testing.assert_array_equal(mi.numpy(), np.asarray(ji))


@pytest.mark.parametrize("scan", ["scan_topk", "scan_topk_streamed"])
@pytest.mark.parametrize("n_valid,chunk", [(300, 64), (250, 128), (300, 1024)])
def test_scans_match(scan, n_valid, chunk):
    """The port's one chunked walk (scan_topk_streamed) against each of
    JAX's two scans: carried top-k with a tombstone mask, several
    chunkings."""
    _, packed, tpacked = corpus()
    q = queries()
    mask = np.random.default_rng(5).random(300) > 0.2
    js, ji = getattr(jc, scan)(
        jnp.asarray(q), packed, jnp.int32(n_valid), k=10, chunk=chunk,
        valid_mask=jnp.asarray(mask),
    )
    ts, ti = tc.scan_topk_streamed(
        t(q), tpacked, n_valid, k=10, chunk=chunk, valid_mask=t(mask)
    )
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    for a, b in zip(ti.numpy(), np.asarray(ji)):
        assert set(a) == set(b)
    assert mask[ti.numpy()].all() and (ti.numpy() < n_valid).all()


def test_rescore_topk():
    """Exact f32 re-rank: atol 1e-5 against JAX's Precision.HIGHEST; -inf
    candidates stay -inf, out-of-range candidates are clipped."""
    _, packed, tpacked = corpus()
    q = queries()
    rng = np.random.default_rng(6)
    idx = rng.integers(0, 300, size=(7, 20)).astype(np.int32)
    idx[1, 3] = 10_000  # out of range: clipped for the gather
    cand = rng.normal(size=(7, 20)).astype(np.float32)
    cand[2, :5] = -np.inf
    valid = rng.random(300) > 0.1
    js, ji = jc.rescore_topk(
        jnp.asarray(q), packed, jnp.asarray(cand), jnp.asarray(idx), 8,
        valid=jnp.asarray(valid),
    )
    ts, ti = tc.rescore_topk(t(q), tpacked, t(cand), t(idx), 8, valid=t(valid))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    for a, b, s in zip(ti.numpy(), np.asarray(ji), ts.numpy()):
        fin = np.isfinite(s)
        assert set(a[fin]) == set(b[fin])


def test_nearest_centroid():
    v, packed, tpacked = corpus(n=400)
    cents = np.random.default_rng(7).normal(size=(12, 64)).astype(np.float32)
    js, ji = jc.nearest_centroid(packed, jnp.asarray(cents))
    ts, ti = tc.nearest_centroid(tpacked, t(cents))
    js, ji = np.asarray(js), np.asarray(ji)
    np.testing.assert_allclose(ts.numpy(), js, atol=2e-3)
    assert (ti.numpy() == ji).mean() >= 0.98
