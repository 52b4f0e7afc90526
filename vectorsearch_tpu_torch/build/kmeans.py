"""Lloyd's k-means centroid builder as plain torch.

Counterpart of vectorsearch_tpu/build/kmeans.py (single device):

  assign     cosine argmax: [chunk, K] products of the int8 codes with the
             bf16-rounded normalized centroids, accumulated in f32
  accumulate per-cluster sums as an f32 one-hot product H^T @ V (exact
             products, a fixed summation order, so runs repeat)
  recenter   mean of member vectors (reference: dnc/dnc.go:402-456)

Initialization keeps the reference's oversample-then-truncate idea: seed
k*SUPERSET_MUL random rows (numpy seeding as in the JAX package), run
Lloyd's on a sample, keep the k largest clusters. Clusters below
min_size are dropped and their members reassigned; oversized clusters
are split by a local k-means (balance).

Differences from the JAX module: the fused device `while_loop` is a
Python loop that reads the change count every iteration (one small sync
per iteration on a local card). The centroid padding to a size class
(`_k_pad_class`) and its `k_valid` mask existed only to bound XLA
compiles and are dropped; the superset's size rule keeps its pow2
rounding, which sets how many seeds the build draws. The two Pallas
k-means kernels are not on this path (the JAX package enables them only
with VSTPU_KMEANS_PALLAS=1 on a TPU).
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from vectorsearch_tpu import constants
from vectorsearch_tpu.logger import sugar
from vectorsearch_tpu.quant.layout import PackedVectors

from ..device import check_exact_f32, resolve, to_device, to_host
from ..kernels import cosine
from .progress import tracker as _progress


@dataclass(frozen=True)
class KMeansResult:
    centroids: np.ndarray  # f32 [K, D]
    assignments: np.ndarray  # int32 [N]
    counts: np.ndarray  # int64 [K]
    iterations: int
    # assignment churn of the FINAL Lloyd iteration: a build that stopped
    # on max_iters with high churn is under-converged. -1 when unknown.
    final_changes: int = -1


def _pow2_class(k: int) -> int:
    c = 256
    while c < k:
        c *= 2
    return c


def prepare_tiles(packed: PackedVectors, chunk: int, device=None):
    """Stage the corpus on the device once. Passing the result to several
    lloyd() calls avoids re-uploading the corpus per phase. Chunks are
    views of the staged rows, so nothing is padded."""
    device = resolve(device)
    rows = PackedVectors(
        *[
            to_device(to_host(a), device, dt)
            for a, dt in zip(
                packed, (torch.int8, torch.float32, torch.float32, torch.float32)
            )
        ]
    )
    return rows, chunk


def _assign_and_accumulate(rows: PackedVectors, chunk: int, centroids):
    """One full Lloyd's pass: returns (sums f32[K,D], counts f32[K],
    assignments int32[N])."""
    kk, d = centroids.shape
    cn = cosine.l2_normalize(centroids)
    c_sums = cn.sum(dim=-1)
    cn_b = cn.bfloat16().float()
    sums = torch.zeros((kk, d), dtype=torch.float32, device=centroids.device)
    counts = torch.zeros((kk,), dtype=torch.float32, device=centroids.device)
    cids = []
    kcol = torch.arange(kk, device=centroids.device)
    check_exact_f32(cn_b)
    for lo in range(0, rows.n, chunk):
        codes = rows.codes[lo : lo + chunk].float()
        scale = rows.scale[lo : lo + chunk, None]
        offset = rows.offset[lo : lo + chunk, None]
        dots = codes @ cn_b.T  # [chunk, K]
        sims = (offset * c_sums[None, :] + scale * dots) * (
            rows.inv_norm[lo : lo + chunk, None]
        )
        cid = torch.argmax(sims, dim=-1)
        onehot = (cid[:, None] == kcol[None, :]).float()  # [chunk, K]
        # the one-hot lhs makes every product exact (0 or v)
        sums += onehot.T @ (offset + scale * codes)
        counts += onehot.sum(dim=0)
        cids.append(cid.to(torch.int32))
    return sums, counts, torch.cat(cids)


def lloyd(
    packed: PackedVectors,
    init_centroids: np.ndarray,
    max_iters: int = constants.KMEANS_ITERATION_LIMIT,
    chunk: int = 16_384,
    tol_changes: int = 0,
    prepared=None,
    device=None,
) -> KMeansResult:
    """Run Lloyd's iterations from the given centroids until the number of
    assignment changes is <= tol_changes (reference converges on unchanged
    quantized bytes — dnc/k_means.go:67-117 — we converge on assignments)."""
    if prepared is None:
        prepared = prepare_tiles(packed, chunk, device)
    rows, chunk = prepared
    dev = rows.codes.device
    cents = to_device(np.asarray(init_centroids, np.float32), dev)
    counts = torch.zeros((cents.shape[0],), dtype=torch.float32, device=dev)
    prev = torch.full((rows.n,), -1, dtype=torch.int32, device=dev)
    it, changes = 0, 2**31 - 1
    while it < max_iters and changes > tol_changes:
        sums, counts, cids = _assign_and_accumulate(rows, chunk, cents)
        cents = torch.where(
            counts[:, None] > 0, sums / counts.clamp(min=1)[:, None], cents
        )
        changes = int((cids != prev).sum())
        prev = cids
        it += 1
    return KMeansResult(
        centroids=to_host(cents),
        assignments=to_host(prev),
        counts=to_host(counts).astype(np.int64),
        iterations=it,
        final_changes=changes if it else -1,
    )


def sample_init(packed: PackedVectors, k: int, seed: int = 0) -> np.ndarray:
    """Initial centroids = dequantized random distinct data rows."""
    n = np.shape(packed.codes)[0]
    rng = np.random.default_rng(seed)
    pick = rng.choice(n, size=min(k, n), replace=False)
    codes = to_host(packed.codes)[pick].astype(np.float32)
    scale = to_host(packed.scale)[pick]
    offset = to_host(packed.offset)[pick]
    return offset[:, None] + scale[:, None] * codes


def _take(packed: PackedVectors, rows: np.ndarray) -> PackedVectors:
    return PackedVectors(*[to_host(a)[rows] for a in packed])


def kmeans(
    packed: PackedVectors,
    k: int,
    max_iters: int = constants.KMEANS_ITERATION_LIMIT,
    superset_mul: int = constants.SUPERSET_MUL,
    superset_iters: int = 25,
    chunk: int = 16_384,
    seed: int = 0,
    prepared=None,
    device=None,
) -> KMeansResult:
    """Superset-initialized k-means (reference: dnc/k_means.go:19-207).

    Phase 1: Lloyd's over k*superset_mul seeded centroids (bounded iters)
             on a sample.
    Phase 2: keep the k clusters with the most members (final-iteration
             counts), then run Lloyd's to convergence.
    """
    n = np.shape(packed.codes)[0]
    if n == 0:
        raise ValueError("kmeans on empty dataset")
    k = max(1, min(k, n))
    if prepared is None:
        prepared = prepare_tiles(packed, chunk, device)
    device = prepared[0].codes.device
    k_super = min(k * max(1, superset_mul), n)
    # the superset only seeds the init, so its size rounds DOWN to a
    # power-of-two class (as in the JAX package): 4x seeds cost half of
    # 5x and seed k just as well
    half = _pow2_class(k_super) // 2
    if k < half < k_super:  # shrink only — never inflate a small superset
        k_super = half
    t0 = time.perf_counter()
    init = sample_init(packed, k_super, seed=seed)
    if k_super > k:
        # the superset phase runs on a SAMPLE (the reference k-means's
        # 50k sample, dnc/dnc.go:320-324)
        sample_n = min(n, max(constants.SAMPLE_SIZE, 12 * k_super))
        if sample_n < n:
            rng = np.random.default_rng(seed + 1)
            pick = np.sort(rng.choice(n, size=sample_n, replace=False))
            with _progress.phase(
                "superset", f"{k_super} seeds / {sample_n}-row sample"
            ):
                phase1 = lloyd(
                    _take(packed, pick), init, max_iters=superset_iters,
                    chunk=min(chunk, 8_192), device=device,
                )
        else:
            with _progress.phase("superset", f"{k_super} seeds / full corpus"):
                phase1 = lloyd(
                    packed, init, max_iters=superset_iters, prepared=prepared,
                )
        top = np.argsort(-phase1.counts, kind="stable")[:k]
        init = phase1.centroids[top]
        sugar().info(
            "build: superset %d seeds / %d-row sample: %.1fs",
            k_super, min(sample_n, n), time.perf_counter() - t0,
        )
    with _progress.phase("lloyd", f"k={k}, n={n}"):
        return lloyd(packed, init, max_iters=max_iters, prepared=prepared)


def build_centroids(
    packed: PackedVectors,
    target_cluster_size: int = constants.CENTROID_SIZE,
    min_cluster_size: int | None = None,
    max_iters: int = 100,
    chunk: int = 16_384,
    seed: int = 0,
    k: int | None = None,
    superset_iters: int = 25,
    balance_rounds: int = 1,
    device=None,
) -> KMeansResult:
    """Full index build: k = ceil(n / target), k-means, drop small clusters,
    reassign and recenter, then split oversized clusters (balance).
    Replaces dnc.KMeansDivideAndConquer (dnc/dnc.go:35-263 +
    dropSmallCentroids + recenterDbCentroid + the recursive size bound)."""
    n = np.shape(packed.codes)[0]
    if k is None:
        k = max(1, -(-n // target_cluster_size))
    if min_cluster_size is None:
        min_cluster_size = max(1, target_cluster_size // 10)

    t0 = time.perf_counter()
    with _progress.phase("upload", f"{n} rows -> device"):
        prepared = prepare_tiles(packed, chunk, device)
    t_prep = time.perf_counter()
    result = kmeans(
        packed, k, max_iters=max_iters, chunk=chunk, seed=seed,
        superset_iters=superset_iters, prepared=prepared,
    )
    t_kmeans = time.perf_counter()
    sugar().info(
        "build: prepare(upload) %.1fs, kmeans(superset+%d iters) %.1fs",
        t_prep - t0, result.iterations, t_kmeans - t_prep,
    )
    # the MAIN Lloyd's convergence stats: later passes run 1-2 bounded
    # iterations from prev=-1, so theirs are no convergence diagnostic
    main_iters, main_churn = result.iterations, result.final_changes
    if result.centroids.shape[0] <= 1:
        return result

    small = result.counts < min_cluster_size
    if small.any() and (~small).any():
        with _progress.phase(
            "drop-small", f"{int(small.sum())} clusters below minimum"
        ):
            # one Lloyd's iteration against survivors = reassign+recenter,
            # then recenter once more for the new assignment
            result = lloyd(
                packed, result.centroids[~small], max_iters=1,
                tol_changes=-1, prepared=prepared,
            )
            result = lloyd(
                packed, result.centroids, max_iters=1, tol_changes=-1,
                prepared=prepared,
            )
        sugar().info(
            "build: drop-small (%d dropped) %.1fs",
            int(small.sum()), time.perf_counter() - t_kmeans,
        )

    # balance: split clusters larger than 2x the mean by a local k-means
    # on their members — one level of the reference's divide step
    # (dnc/dnc.go:320-335). Skew sets the uniform bucket capacity.
    for round_i in range(balance_rounds):
        t_round = time.perf_counter()
        mean_count = max(1, int(result.counts.sum() // max(1, len(result.counts))))
        oversized = np.nonzero(result.counts > 2 * mean_count)[0]
        if oversized.size == 0:
            break
        with _progress.phase(
            "balance", f"round {round_i + 1}: {oversized.size} splits"
        ):
            split = set(oversized.tolist())
            new_centroids = [
                result.centroids[i] for i in range(len(result.counts))
                if i not in split
            ]
            for ci in oversized:
                members = np.nonzero(result.assignments == ci)[0]
                if members.size > constants.SAMPLE_SIZE:
                    members = np.random.default_rng(seed + int(ci)).choice(
                        members, size=constants.SAMPLE_SIZE, replace=False
                    )
                k_sub = max(2, -(-int(result.counts[ci]) // mean_count))
                sub_res = kmeans(
                    _take(packed, members), k_sub, max_iters=10,
                    superset_mul=1, chunk=chunk, seed=seed + int(ci),
                    device=prepared[0].codes.device,
                )
                new_centroids.extend(list(sub_res.centroids))
            t_subs = time.perf_counter()
            result = lloyd(
                packed, np.stack(new_centroids), max_iters=2,
                tol_changes=-1, prepared=prepared,
            )
            sugar().info(
                "build: balance round (%d split, subs %.1fs, reassign %.1fs)",
                oversized.size, t_subs - t_round, time.perf_counter() - t_subs,
            )
    return dataclasses.replace(
        result, iterations=main_iters, final_changes=main_churn
    )
