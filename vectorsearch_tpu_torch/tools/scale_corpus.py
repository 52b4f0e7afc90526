"""The scale checks' corpus, queries, exact truth and k-means build.

Rows follow bench_build.py's recipe (2 * center + unit noise around k
generating centers) but are made on a device from a torch seed, slab by
slab, so the original f32 rows can be made again for the truth without
ever holding all of them (10M x 768 f32 is 31 GB). Queries and truth
follow tools/bench_10m_serving.py: 512 rows drawn with numpy seed 123,
dequantized, plus 0.1 gaussian noise; the truth is exact-f32 cosine top-10
over the ORIGINAL rows, so recall is charged for the corpus quantization.
The build is build_centroids with bench_build.py's arguments (BASELINE
config 4: 10M x 768 -> 4096 centroids).
"""
from __future__ import annotations

import numpy as np
import torch

from ..build import build_centroids
from ..device import check_exact_f32, pin_exact_f32
from ..kernels import cosine
from ..quant.layout import PackedVectors

DIM = 768
N_QUERIES, TOPK = 512, 10
STEP = 500_000  # rows a slab


def regen_slabs(dev, n: int, dim: int, k: int, seed: int, step: int = STEP):
    """The original f32 rows, slab by slab: yields (start, f32 [m, dim]
    on `dev`). The same (dev, n, dim, k, seed, step) make the same rows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    centers = torch.randn((k, dim), generator=gen, device=dev)
    for start in range(0, n, step):
        m = min(step, n - start)
        v = centers[torch.randint(0, k, (m,), generator=gen, device=dev)] * 2.0
        v += torch.randn((m, dim), generator=gen, device=dev)
        yield start, v


def pack_rows(v: torch.Tensor) -> PackedVectors:
    """f32 rows packed the codec's way (layout.pack_float: the range folded
    from 0, truncation to u8, codes q - 128, f32 sidecars), on v's device."""
    vmin = v.amin(dim=-1).clamp(max=0)
    vmax = v.amax(dim=-1).clamp(min=0)
    span = vmax - vmin
    safe = torch.where(span == 0, 1.0, span)
    q = torch.trunc((v - vmin[:, None]) / safe[:, None] * 255.0).clamp(0, 255)
    codes = (q - 128).to(torch.int8)
    scale = span / 255.0
    offset = vmin + 128.0 * scale
    norm = (offset[:, None] + scale[:, None] * codes.float()).norm(dim=-1)
    inv_norm = torch.where(norm == 0, 0.0, 1.0 / torch.where(norm == 0, 1.0, norm))
    return PackedVectors(codes, scale, offset, inv_norm)


def packed_on_card(dev, n: int, dim: int, k: int, seed: int, step: int = STEP):
    """regen_slabs' rows packed on `dev`: yields (start, PackedVectors of
    tensors) a slab."""
    for start, v in regen_slabs(dev, n, dim, k, seed, step):
        yield start, pack_rows(v)


def packed_host(dev, n: int, dim: int, k: int, seed: int) -> PackedVectors:
    """packed_on_card's rows moved to host numpy, one slab at a time."""
    host = PackedVectors(np.empty((n, dim), np.int8), np.empty(n, np.float32),
                         np.empty(n, np.float32), np.empty(n, np.float32))
    for start, part in packed_on_card(dev, n, dim, k, seed):
        for dst, src in zip(host, part):
            dst[start : start + src.shape[0]] = src.cpu().numpy()
    return host


def build(packed, device, k: int):
    """bench_build.py's build_centroids of `packed` into about k clusters."""
    n = packed.codes.shape[0]
    return build_centroids(
        packed,
        k=k,
        min_cluster_size=max(1, (n // k) // 10),
        max_iters=8,
        superset_iters=3,
        chunk=65_536,
        balance_rounds=1,
        device=device,
    )


def make_queries(packed: PackedVectors, n_queries: int = N_QUERIES, seed: int = 123,
                 noise: float = 0.1) -> np.ndarray:
    """tools/bench_10m_serving.py's queries: `n_queries` distinct rows
    (sorted) drawn with numpy `seed`, dequantized, plus `noise` gaussian
    noise; f32 [n_queries, D]."""
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(packed.codes.shape[0], size=n_queries, replace=False))
    base = (np.asarray(packed.offset)[idx, None]
            + np.asarray(packed.scale)[idx, None] * np.asarray(packed.codes)[idx].astype(np.float32))
    return (base + rng.normal(size=base.shape).astype(np.float32) * np.float32(noise)).astype(
        np.float32)


def exact_truth(queries: np.ndarray, dev, n: int, dim: int, k: int, seed: int,
                topk: int = TOPK) -> np.ndarray:
    """Row numbers [B, topk] of each query's exact-f32 cosine top-k over
    the original rows (regen_slabs with the same arguments), on `dev` slab
    by slab with TF32 off, keeping a running top-k."""
    pin_exact_f32()
    qn = cosine.l2_normalize(torch.from_numpy(np.ascontiguousarray(queries)).to(dev).float())
    check_exact_f32(qn)
    best_s = torch.full((qn.shape[0], topk), float("-inf"), device=dev)
    best_i = torch.zeros((qn.shape[0], topk), dtype=torch.int64, device=dev)
    for start, v in regen_slabs(dev, n, dim, k, seed):
        s, i = torch.topk(qn @ cosine.l2_normalize(v).T, min(topk, v.shape[0]), dim=-1)
        best_s, pos = torch.topk(torch.cat([best_s, s], dim=1), topk, dim=-1)
        best_i = torch.gather(torch.cat([best_i, i + start], dim=1), 1, pos)
    return best_i.cpu().numpy()


def recall(got_ids: np.ndarray, want_ids: np.ndarray) -> float:
    """Mean share of each row's wanted ids among its returned ids."""
    k = want_ids.shape[1]
    return float(np.mean([len(set(g.tolist()) & set(w.tolist())) / k
                          for g, w in zip(got_ids, want_ids)]))


def sets_differ(got_s, got_i, want_s, want_i, tie) -> int:
    """Rows whose top-k set differs other than at a tie: each id in one set
    only scores within `tie` of the row's k-th score in `want_s`."""
    odd = 0
    for r in range(got_i.shape[0]):
        cut = want_s[r, -1]
        only = [(got_s[r], got_i[r], x) for x in set(got_i[r]) - set(want_i[r])]
        only += [(want_s[r], want_i[r], x) for x in set(want_i[r]) - set(got_i[r])]
        odd += any(abs(float(s[i == x][0]) - cut) > tie for s, i, x in only)
    return odd
