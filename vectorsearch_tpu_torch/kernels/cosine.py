"""Cosine-similarity scoring as torch ops.

Counterpart of vectorsearch_tpu/kernels/cosine.py (same functions, same
arguments, the JAX package's layouts at every public function). Scoring
identity (vectorsearch_tpu/quant/layout.py): for a corpus vector
v = offset + scale * c with centered int8 codes c and an L2-normalized
query x,

    cos(x, v) = (scale * <x, c> + offset * sum(x)) * inv_norm

Numerics on the card:
  * Where JAX asks for `Precision.HIGHEST` (scores_f32, rescore_topk) the
    products run in full f32 with TF32 off (device.pin_exact_f32, checked
    by device.check_exact_f32 on CUDA tensors).
  * JAX's bf16 x bf16 -> f32 dots (`preferred_element_type=f32`) become
    f32 products of the bf16-rounded operands: a bf16 x bf16 or
    bf16 x int8 product is exact in f32, and torch's bf16 matmul would
    round its output to bf16.
  * scores_int8 is s8 x s8 -> s32 in XLA, outside any Pallas kernel. Here
    it is an f32 product of the int8 values, exact while every partial sum
    stays below 2**24: 127**2 * D < 2**24 holds for D <= 1040
    (EXACT_F32_DIM). Wider rows are contracted in slices of at most 1040
    dims whose exact integer partials are summed in int32 (`_int_dots`).
    `torch._int_mm` is not used: on CUDA it refuses rows <= 16 and widths
    that are not multiples of 8, and engine searches arrive with B=1.
  * Every top-k is exact, so the port's functions take no `approx`
    argument: `jax.lax.approx_max_k` has no counterpart on the card.
    grouped_scan.resolve_auto_epilogue and ivf._oom_fallback keep it in
    their arguments and returns only to match the JAX functions they are
    tested against.
  * One chunked walk, scan_topk_streamed, serves both of JAX's scans
    (scan_topk and scan_topk_streamed): a chunk here is a view of the
    corpus, where JAX's padded tiling needed a second formulation.
  * Ties: torch.topk and jax.lax.top_k may order equal scores
    differently; callers compare scores and id sets.
"""
from __future__ import annotations

import torch

from vectorsearch_tpu.quant.layout import PackedVectors

from ..device import check_exact_f32

NEG_INF = float("-inf")
# widest contraction whose int8 x int8 partial sums stay exact in f32
EXACT_F32_DIM = 1040


def l2_normalize(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """L2-normalize; zero vectors are left unchanged (reference semantics)."""
    norm = torch.linalg.vector_norm(x, dim=axis, keepdim=True)
    return torch.where(norm == 0, x, x / torch.where(norm == 0, 1, norm))


def quantize_queries(q: torch.Tensor):
    """Symmetric int8 quantization of (already normalized) query rows.

    Returns (codes int8[B,D], scale f32[B], qsum f32[B]) with
    q ~= scale * codes and qsum = exact sum of q (f32)."""
    q = q.float()
    absmax = q.abs().amax(dim=-1)
    scale = torch.where(absmax == 0, 1, absmax / 127.0)
    codes = torch.clamp(torch.round(q / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale.float(), q.sum(dim=-1)


def _int_dots(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 contraction [B, D] x [N, D] -> f32 [B, N]."""
    d = x.shape[-1]
    check_exact_f32(x)
    if d <= EXACT_F32_DIM:
        return x.float() @ y.float().T
    acc = None
    for d0 in range(0, d, EXACT_F32_DIM):
        part = (
            x[:, d0 : d0 + EXACT_F32_DIM].float()
            @ y[:, d0 : d0 + EXACT_F32_DIM].float().T
        ).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc.float()


def scores_int8(q_codes, q_scale, q_sum, corpus: PackedVectors) -> torch.Tensor:
    """Cosine scores [B, N] from int8 query codes against a packed corpus."""
    dots = _int_dots(q_codes, corpus.codes)
    inner = (q_scale[:, None] * corpus.scale[None, :]) * dots
    inner = inner + q_sum[:, None] * corpus.offset[None, :]
    return inner * corpus.inv_norm[None, :]


def scores_packed(queries: torch.Tensor, corpus: PackedVectors) -> torch.Tensor:
    """Cosine scores [B, N] for f32 queries against a packed corpus."""
    qn = l2_normalize(queries.float())
    return scores_int8(*quantize_queries(qn), corpus)


def scores_f32(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """Exact f32 oracle: normalize both sides, dense matmul [B, N] in full
    f32 (TF32 off) — the recall oracle, not the serving path."""
    qn = l2_normalize(queries.float())
    cn = l2_normalize(corpus.float())
    check_exact_f32(qn)
    return qn @ cn.T


def mask_invalid(scores: torch.Tensor, n_valid) -> torch.Tensor:
    """Mask scores at column index >= n_valid to -inf (padding)."""
    col = torch.arange(scores.shape[-1], device=scores.device)
    return torch.where(col < n_valid, scores, NEG_INF)


def topk(scores: torch.Tensor, k: int):
    s, i = torch.topk(scores, k, dim=-1)
    return s, i.to(torch.int32)


def merge_topk(scores_a, idx_a, scores_b, idx_b, k: int):
    """Merge two candidate sets [B, ka], [B, kb] into top-k of the union."""
    s = torch.cat([scores_a, scores_b], dim=-1)
    i = torch.cat([idx_a, idx_b], dim=-1)
    best, pos = torch.topk(s, k, dim=-1)
    return best, torch.gather(i, 1, pos)


def scan_topk_streamed(
    queries, corpus: PackedVectors, n_valid, k: int, chunk: int = 65_536,
    valid_mask=None,
):
    """Memory-bounded exact top-k over a packed corpus: chunk-row views
    with a carried [B, k] best set, so the [B, N] score matrix never
    exists. Rows at or past n_valid and rows whose valid_mask is False
    score -inf. This is the route of the reference's centroids=-1 "scan
    everything" fallback (server/search.go:116-122). Returns (scores
    f32[B,k], idx i32[B,k])."""
    n = corpus.n
    b = queries.shape[0]
    dev = corpus.codes.device
    qn = l2_normalize(queries.float())
    q_codes, q_scale, q_sum = quantize_queries(qn)
    best_s = torch.full((b, k), NEG_INF, device=dev)
    best_i = torch.zeros((b, k), dtype=torch.int32, device=dev)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        tile = PackedVectors(*[a[lo:hi] for a in corpus])
        s = scores_int8(q_codes, q_scale, q_sum, tile)
        row = torch.arange(lo, hi, device=dev)
        ok = row < n_valid
        if valid_mask is not None:
            ok = ok & valid_mask[lo:hi]
        s = torch.where(ok[None, :], s, NEG_INF)
        cand_s, pos = torch.topk(s, min(k, hi - lo), dim=-1)
        cand_i = (pos + lo).to(torch.int32)
        best_s, best_i = merge_topk(best_s, best_i, cand_s, cand_i, k)
    return best_s, best_i


def rescore_topk(
    queries, corpus: PackedVectors, cand_scores, cand_idx, k: int, valid=None,
):
    """Exact re-rank of candidate rows: gather the m candidates per query,
    score them against the UNQUANTIZED f32 query (full f32, TF32 off), and
    take top-k. -inf candidates stay -inf. Candidate indices are clipped
    before the gather: torch does not clamp out-of-range gathers."""
    qn = l2_normalize(queries.float())  # [B, D]
    safe = torch.clamp(cand_idx.long(), 0, corpus.codes.shape[0] - 1)
    codes_g = corpus.codes[safe]  # [B, m, D]
    check_exact_f32(qn)
    dots = torch.bmm(codes_g.float(), qn[:, :, None])[..., 0]
    qsum = qn.sum(dim=-1, keepdim=True)
    exact = (corpus.offset[safe] * qsum + corpus.scale[safe] * dots) * (
        corpus.inv_norm[safe]
    )
    if cand_scores is not None:
        exact = torch.where(torch.isneginf(cand_scores), NEG_INF, exact)
    if valid is not None:
        exact = torch.where(valid[safe], exact, NEG_INF)
    best, pos = torch.topk(exact, min(k, exact.shape[-1]), dim=-1)
    return best, torch.gather(cand_idx, 1, pos)


def nearest_centroid(vectors: PackedVectors, centroids_f32: torch.Tensor):
    """Per-vector (best_similarity, argmax) over centroid rows. The data
    side uses the packed affine identity with bf16 centroids and f32
    accumulation, as the JAX package's int8 x bf16 dot does."""
    cn = l2_normalize(centroids_f32.float())  # [K, D]
    c_sums = cn.sum(dim=-1)  # [K]
    check_exact_f32(cn)
    dots = vectors.codes.float() @ cn.bfloat16().float().T  # [N, K]
    inner = vectors.offset[:, None] * c_sums[None, :] + vectors.scale[:, None] * dots
    sims = inner * vectors.inv_norm[:, None]
    best_s, best = torch.max(sims, dim=-1)
    return best_s, best.to(torch.int32)
