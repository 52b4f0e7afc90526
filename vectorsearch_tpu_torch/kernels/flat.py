"""Band-max flat search: the s8 and bf16 band kernels, their plain
PyTorch versions, and the band route around them.

Counterpart of vectorsearch_tpu/kernels/pallas_flat.py. The corpus is cut
into tiles of TILE_N = 1024 rows; band `lane` of a tile is its 8 rows
congruent to lane mod 128, and its score is the maximum of their affine
scores

    s8:    (sq[b] * a[r]) * <qc[b], codes[r]> + qsum[b] * bv[r] + bias[r]
    bf16:  a[r] * <q[b], codes[r]> + qsum[b] * bv[r] + bias[r]

with a = scale * inv_norm, bv = offset * inv_norm and bias 0 for a live
row or -inf for a dead one. The band route (band_candidates) takes the top
bands, in chunks of whole tiles whose band maxima fit BAND_BYTES, expands
each to its 8 rows, and leaves them to the exact rescore
(cosine.rescore_topk). Its callers:

  * FlatIndex.topk at refine = m > 0 (index/flat.py), on the s8 kernel,
    with m bands. A row of the coarse top m lies in a band whose maximum
    is at least its score, and if that band were not among the top m, m
    other bands, so m other rows, would score at least as high. So the
    rescored rows hold the coarse top m of the streamed scan (the same
    int8 scores, up to the rounding of the affine terms), and the exact
    answer at each rank is the streamed route's or a better one.
  * flat_search (the JAX package's flat_search_pallas), with k_bands
    bands and either kernel.

The kernels live in csrc/flat.cu. On CPU tensors each wrapper runs its
plain version; on CUDA tensors it launches its kernel or raises. The
kernels load through TMA, which needs 16-byte row strides: for a D that is
no multiple of 16 the wrappers pad the codes and the query rows with zero
columns (a copy of the rows scanned, a call), which add exactly 0 to every dot.

Not carried over from the TPU module: the padding of the corpus to whole
tiles (the kernels score rows past N as -inf without reading them), the
query padding to TILE_Q, the [tiles, B, 128] output and its moveaxis (the
bands are written query-major, [B, tiles * 128]), and approx_max_k: the
band top-k is exact.
"""
from __future__ import annotations

import torch

from ..device import check_exact_f32
from ..quant.layout import PackedVectors
from . import _build, cosine

TILE_N = 1024  # corpus rows per tile
BAND_LANES = 128  # bands per tile
GROUPS = TILE_N // BAND_LANES  # rows per band

# kernel launches since import (or since a caller reset them to 0): let a
# run show that its search went through the CUDA kernels
S8_LAUNCHES = 0
BF16_LAUNCHES = 0

DEFAULT_CHUNK = 64 * TILE_N  # corpus rows per step of the plain versions

# (tile lanes, ring stages, queries a block) handed to the kernels: 0 leaves
# each to the launch rule of csrc/flat.cu. Measurements and tests set it to
# time or check another schedule; the search path never does.
SCHEDULE = (0, 0, 0)


def n_tiles(n: int) -> int:
    return -(-n // TILE_N)


# ---------------------------------------------------------- plain versions


def _bands_ref(scores_fn, b: int, n: int, dev, chunk: int):
    """Band maxima f32 [b, tiles * 128] of scores_fn(lo, hi) -> f32 [b,
    hi - lo], walked in row chunks of `chunk` (a multiple of TILE_N); rows
    past n score -inf."""
    if chunk % TILE_N:
        raise ValueError(f"chunk must be a multiple of {TILE_N}, got {chunk}")
    out = torch.empty((b, n_tiles(n) * BAND_LANES), dtype=torch.float32, device=dev)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        t = n_tiles(hi - lo)
        s = torch.nn.functional.pad(scores_fn(lo, hi), (0, t * TILE_N - (hi - lo)),
                                    value=cosine.NEG_INF)
        t0 = lo // TILE_N
        out[:, t0 * BAND_LANES : (t0 + t) * BAND_LANES] = (
            s.reshape(b, t, GROUPS, BAND_LANES).amax(2).reshape(b, t * BAND_LANES)
        )
    return out


def flat_bands_s8_ref(qc, sq, qsum, codes, a, bv, bias, chunk: int = DEFAULT_CHUNK):
    """Plain version of flat_bands_s8: exact int8 dots (cosine._int_dots),
    then the sidecars in the kernel's order of roundings."""

    def scores(lo, hi):
        dots = cosine._int_dots(qc, codes[lo:hi])
        return ((sq[:, None] * a[None, lo:hi]) * dots
                + qsum[:, None] * bv[None, lo:hi] + bias[None, lo:hi])

    return _bands_ref(scores, qc.shape[0], codes.shape[0], codes.device, chunk)


def flat_bands_bf16_ref(q, qsum, codes, a, bv, bias, chunk: int = DEFAULT_CHUNK):
    """Plain version of flat_bands_bf16: the bf16 queries and the codes
    widened to f32 (exact products, f32 sums, TF32 off)."""
    check_exact_f32(q)

    def scores(lo, hi):
        dots = q.float() @ codes[lo:hi].float().T
        return a[None, lo:hi] * dots + qsum[:, None] * bv[None, lo:hi] + bias[None, lo:hi]

    return _bands_ref(scores, q.shape[0], codes.shape[0], codes.device, chunk)


# ---------------------------------------------------------------- wrappers


def _corpus_spec(codes, a, bv, bias, d: int) -> dict:
    n = codes.shape[0]
    return {
        "codes": (codes, torch.int8, (n, d)),
        "a": (a, torch.float32, (n,)),
        "bv": (bv, torch.float32, (n,)),
        "bias": (bias, torch.float32, (n,)),
    }


def _pad_dims(t):
    """`t` [rows, D] with zero columns up to the next multiple of 16 (the
    kernels' TMA loads need 16-byte row strides); a zero column adds
    exactly 0 to a dot product."""
    d = t.shape[1]
    return torch.nn.functional.pad(t, (0, -d % 16)) if d % 16 else t


def _launch(name: str, q, side, codes, corpus, out) -> None:
    """Launch kernel vs_<name> on checked tensors (queries `q` [B, D'] with
    D' = D rounded up to 16, their sidecars `side`, `codes` [N, D], the
    corpus sidecars `corpus`) into `out`, f32 [B, tiles * 128], on the
    current stream; raise on a build or launch error."""
    n, d = codes.shape
    if d == 0:
        raise ValueError(f"{name}: needs D >= 1")
    codes = _pad_dims(codes)
    dev = out.device
    fn = getattr(_build.load(), f"vs_{name}")
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), *[t.data_ptr() for t in side], codes.data_ptr(),
                 *[t.data_ptr() for t in corpus], out.data_ptr(), out.shape[0], n,
                 codes.shape[1], *SCHEDULE, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {err}")


def _empty_bands(b: int, n: int, dev):
    return torch.empty((b, n_tiles(n) * BAND_LANES), dtype=torch.float32, device=dev)


def flat_bands_s8(qc, sq, qsum, codes, a, bv, bias):
    """Band maxima f32 [B, tiles * 128] of the s8 scores.

    qc i8 [B, D] symmetric query codes, sq f32 [B] their scales, qsum f32
    [B] the sums of the normalized queries; codes i8 [N, D]; a, bv, bias
    f32 [N]. On CPU tensors this is flat_bands_s8_ref; on CUDA tensors it
    launches the kernel or raises."""
    global S8_LAUNCHES
    args = (qc, sq, qsum, codes, a, bv, bias)
    dev = _build.launch_device("flat_bands_s8", args)
    if dev is None:
        return flat_bands_s8_ref(*args)
    b, d = qc.shape
    _build.check_args("flat_bands_s8", {
        "qc": (qc, torch.int8, (b, d)),
        "sq": (sq, torch.float32, (b,)),
        "qsum": (qsum, torch.float32, (b,)),
        **_corpus_spec(codes, a, bv, bias, d),
    })
    n = codes.shape[0]
    out = _empty_bands(b, n, dev)
    if out.numel():
        _launch("flat_bands_s8", _pad_dims(qc), (sq, qsum), codes, (a, bv, bias), out)
        S8_LAUNCHES += 1
    return out


def flat_bands_bf16(q, qsum, codes, a, bv, bias):
    """Band maxima f32 [B, tiles * 128] of the bf16 scores.

    q bf16 [B, D] the normalized queries, qsum f32 [B] their f32 sums;
    codes i8 [N, D]; a, bv, bias f32 [N]. On CPU tensors this is
    flat_bands_bf16_ref; on CUDA tensors it launches the kernel or
    raises."""
    global BF16_LAUNCHES
    args = (q, qsum, codes, a, bv, bias)
    dev = _build.launch_device("flat_bands_bf16", args)
    if dev is None:
        return flat_bands_bf16_ref(*args)
    b, d = q.shape
    _build.check_args("flat_bands_bf16", {
        "q": (q, torch.bfloat16, (b, d)),
        "qsum": (qsum, torch.float32, (b,)),
        **_corpus_spec(codes, a, bv, bias, d),
    })
    n = codes.shape[0]
    out = _empty_bands(b, n, dev)
    if out.numel():
        _launch("flat_bands_bf16", _pad_dims(q), (qsum,), codes, (a, bv, bias), out)
        BF16_LAUNCHES += 1
    return out


# ------------------------------------------------------------ flat search

# The most bytes of f32 band maxima one launch writes: the band route walks
# the rows in whole-tile chunks of at most BAND_BYTES / (4 * B) bands, so its
# memory stays bounded at any N, as the streamed scan's does. At B=512 one
# launch covers 2**21 rows.
BAND_BYTES = 1 << 29


def band_candidates(queries, corpus: PackedVectors, n_valid: int, k_bands: int, k: int,
                    live, use_s8: bool = True):
    """The rows of the top k_bands bands over rows [0, n_valid), as
    rescore_topk's candidates: (cand f32 [B, w], rows i32 [B, w]) with cand
    0 for a row to rescore and -inf for a row past n_valid, and w at least k
    (dead entries fill a corpus too small for k).

    `live` is bool [N], False for a dead row (rows at and past n_valid are
    never scanned, whatever it holds there). The bands come from one launch
    a chunk of whole tiles (BAND_BYTES), each chunk's top bands merged into
    the carried set: a band of the global top k_bands is also in its own
    chunk's top k_bands."""
    dev = corpus.codes.device
    qn = cosine.l2_normalize(queries.float())
    b = qn.shape[0]
    qsum = qn.sum(dim=-1)
    if use_s8:
        qc, sq, _ = cosine.quantize_queries(qn)
    else:
        qb = qn.bfloat16()
    step = max(1, BAND_BYTES // (4 * BAND_LANES * b)) * TILE_N
    best_s = band = None
    for lo in range(0, n_valid, step):
        hi = min(lo + step, n_valid)
        codes = corpus.codes[lo:hi]
        a = corpus.scale[lo:hi] * corpus.inv_norm[lo:hi]
        bv = corpus.offset[lo:hi] * corpus.inv_norm[lo:hi]
        bias = torch.where(live[lo:hi], 0.0, cosine.NEG_INF)
        if use_s8:
            bands = flat_bands_s8(qc, sq, qsum, codes, a, bv, bias)
        else:
            bands = flat_bands_bf16(qb, qsum, codes, a, bv, bias)
        # exact: approx_max_k is not carried
        s, top = torch.topk(bands, min(k_bands, bands.shape[1]), dim=-1)
        if lo == 0:
            best_s, band = s, top
        else:
            best_s, band = cosine.merge_topk(best_s, band, s, top + lo // GROUPS,
                                             min(k_bands, band.shape[1] + top.shape[1]))
    if band is None:  # no rows
        band = torch.zeros((b, 0), dtype=torch.int64, device=dev)
    j = torch.arange(GROUPS, device=dev) * BAND_LANES
    rows = ((band // BAND_LANES) * TILE_N + band % BAND_LANES)[:, :, None] + j
    rows = rows.reshape(b, -1).to(torch.int32)
    if rows.shape[1] < k:
        rows = torch.nn.functional.pad(rows, (0, k - rows.shape[1]), value=n_valid)
    # the corpus is not padded: a band of the last tile expands to rows
    # past n_valid, which rescore_topk would clamp to the last row and
    # score as a copy of it; they enter dead
    cand = torch.where(rows < n_valid, 0.0, cosine.NEG_INF)
    return cand, rows


def flat_search(queries, corpus: PackedVectors, n_valid, k: int, k_bands: int = 64,
                valid_mask=None, use_s8: bool = True):
    """Large-batch flat search: band sketch -> top bands -> their rows ->
    exact f32 rescore (pallas_flat.flat_search_pallas).

    queries f32 [B, D] on the corpus's device; corpus PackedVectors of
    tensors [N, D]; rows at or past n_valid, and rows whose valid_mask
    (bool [N]) is False, are dead. Returns (scores f32 [B, k], idx i32
    [B, k]): exact f32 cosines of the returned rows, best first, -inf
    where fewer than k live rows were found."""
    n_valid = min(int(n_valid), corpus.codes.shape[0])
    live = torch.arange(corpus.codes.shape[0], device=corpus.codes.device) < n_valid
    if valid_mask is not None:
        live = live & valid_mask
    cand, rows = band_candidates(queries, corpus, n_valid, k_bands, k, live, use_s8)
    return cosine.rescore_topk(queries, corpus, cand, rows, k, valid=live)
