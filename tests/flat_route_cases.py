"""Shared inputs and checks for the flat index's two routes
(tests/test_torch_flat_route.py on the CPU, tests/test_torch_kernel_cuda.py
on the card). Imports no jax: the machine with the card has none.

Rows follow the flat configuration's law (vsbench/configs/vdbb-768d1m-flat.json):
directions c_j ~ N(0, I), cluster weights exp(0.2 z), row = 3.33 c_m + N(0, I),
query = a row + 0.33 N(0, I).

The streamed route is the one `FlatIndex.topk` took at every refine before
the band route: the coarse top m of `scan_topk_streamed`, then
`rescore_topk`. The band route's candidates hold that coarse top m, so at
each rank its answer is the streamed route's or a better one, and where the
streamed route already returns the exact top k the two agree.
"""
import numpy as np
import torch

from vectorsearch_tpu_torch.index import FlatIndex
from vectorsearch_tpu_torch.kernels import cosine
from vectorsearch_tpu_torch.quant import layout

D = 768
ATOL = 1e-5  # two exact f32 rescores of the same rows
RANK_TOL = 1e-6  # f64 cosines of two answers, rank by rank


def law(n: int, b: int, seed: int, d: int = D):
    """(rows f32 [n, d], queries f32 [b, d]) of the configuration's law."""
    rng = np.random.default_rng(seed)
    k = max(4, n // 1000)
    c = rng.normal(size=(k, d))
    w = np.exp(0.2 * rng.normal(size=k))
    m = rng.choice(k, size=n, p=w / w.sum())
    v = (3.3333333 * c[m] + rng.normal(size=(n, d))).astype(np.float32)
    q = v[rng.integers(0, n, size=b)] + 0.3333333 * rng.normal(size=(b, d))
    return v, q.astype(np.float32)


def index(v, tombstones, device, capacity=None):
    """A FlatIndex of the rows (ids 100 + row) on `device`, with capacity
    past n, and the ids `tombstones` removed."""
    n = len(v)
    ids = np.arange(n, dtype=np.int64) + 100
    f = FlatIndex.create(v.shape[1], capacity=capacity or 2 * n + 1, device=device)
    return f.append(layout.pack_float(v), ids).remove_ids(np.asarray(tombstones, np.int64))


def streamed(f: FlatIndex, q, k: int, m: int):
    """The streamed route at refine m: (scores, ids) as numpy."""
    qt = torch.from_numpy(q).to(f.device)
    s, slots = cosine.scan_topk_streamed(qt, f.packed, f.n, k=m, valid_mask=f.mask)
    s, slots = cosine.rescore_topk(qt, f.packed, s, slots, k)
    s = s.cpu().numpy()
    return s, f.map_ids(s, slots.cpu().numpy())


def f64_ranks(f: FlatIndex, q, ids):
    """f64 cosines of the rows `ids` [B, k] (-inf where an id is -1), each
    row sorted best first; and the f64 brute-force top k over every live
    row."""
    codes, scale, offset, _ = (t.cpu().numpy()[: f.n] for t in f.packed)
    rows = codes.astype(np.float64) * scale[:, None].astype(np.float64) + offset[:, None]
    rows /= np.linalg.norm(rows, axis=-1, keepdims=True)
    qn = q.astype(np.float64)
    qn /= np.linalg.norm(qn, axis=-1, keepdims=True)
    sims = qn @ rows.T
    sims[:, ~f.mask_host[: f.n]] = -np.inf
    k = ids.shape[1]
    top = min(k, sims.shape[1])
    brute = -np.sort(np.partition(-sims, top - 1, axis=-1)[:, :top], axis=-1)
    if top < k:
        brute = np.pad(brute, ((0, 0), (0, k - brute.shape[1])), constant_values=-np.inf)
    slot = np.clip(ids - 100, 0, f.n - 1)
    got = np.where(ids < 0, -np.inf, np.take_along_axis(sims, slot, axis=-1))
    return -np.sort(-got, axis=-1), brute


def assert_hits_match(a, b, atol=ATOL):
    """Scores within atol rank by rank; the finite id sets equal except
    entries within atol of the row's last finite score; no id twice."""
    (s_a, i_a), (s_b, i_b) = a, b
    np.testing.assert_allclose(s_a, s_b, atol=atol)
    for sa, ia, sb, ib in zip(s_a, i_a, s_b, i_b):
        fin = np.isfinite(sa)
        assert len(set(ia[fin])) == fin.sum(), ia
        if not fin.any():
            continue
        cut = sa[fin].min()
        for x in set(ia[fin]) ^ set(ib[np.isfinite(sb)]):
            near = np.concatenate([sa[ia == x], sb[ib == x]])
            assert (near <= cut + atol).all(), (x, near, cut)


def compare_routes(f: FlatIndex, q, band, other, k: int, m: int):
    """The band route's answer `band` against `other`, an answer of the
    streamed route at refine m: never worse at any rank by f64 cosine; on
    every query where `other` is the exact top k, equal under
    assert_hits_match. At m = 32 every query must be such a query (the
    configuration's claim that a refine of 32 is exact); at m = k the band
    route may find rows the streamed route missed. Returns the number of
    queries where `other` was not exact."""
    got, brute = f64_ranks(f, q, band[1])
    ref, _ = f64_ranks(f, q, other[1])
    fin = np.isfinite(ref)
    assert (np.isfinite(got) == fin).all()
    assert (got[fin] >= ref[fin] - RANK_TOL).all(), (got - ref).min()
    assert (got[fin] <= brute[fin] + RANK_TOL).all()
    exact = np.array([(np.isfinite(r) == np.isfinite(x)).all()
                      and np.allclose(r[np.isfinite(r)], x[np.isfinite(x)], rtol=0, atol=RANK_TOL)
                      for r, x in zip(ref, brute)])
    if m >= 32:
        assert exact.all(), np.flatnonzero(~exact)
    assert_hits_match(tuple(a[exact] for a in band), tuple(a[exact] for a in other))
    return int((~exact).sum())
