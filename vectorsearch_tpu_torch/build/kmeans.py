"""Lloyd's k-means centroid builder on the port's kernels.

Counterpart of vectorsearch_tpu/build/kmeans.py (single device):

  assign     cosine argmax of the int8 codes against the bf16-rounded
             normalized centroids, accumulated in f32
  accumulate per-cluster sums of the dequantized rows in f32 (the same
             sums on every run)
  recenter   mean of member vectors (reference: dnc/dnc.go:402-456)

Initialization keeps the reference's oversample-then-truncate idea: seed
k*SUPERSET_MUL random rows (numpy seeding as in the JAX package), run
Lloyd's on a sample, keep the k largest clusters. Clusters below
min_size are dropped and their members reassigned; oversized clusters
are split by a local k-means (balance).

On a mesh (`mesh=`, parallel/mesh.py) the staged rows are split over
the shards; in each Lloyd's pass every shard runs assign and accumulate on
its own device, and the sums, counts and changes are added in shard order
(all_reduced across ranks), as the JAX module psums them under shard_map.

Differences from the JAX module: the fused device `while_loop` is a
Python loop that reads the change count every iteration (one small sync
per iteration on a local card). The centroid padding to a size class
(`_k_pad_class`) and its `k_valid` mask existed only to bound XLA
compiles and are dropped; the superset's size rule keeps its pow2
rounding, which sets how many seeds the build draws. Every pass runs
through kernels/kmeans.assign_accumulate: on the card that is the CUDA
assign and accumulate kernels (csrc/kmeans.cu) at any K, with no switch
like VSTPU_KMEANS_PALLAS and no K bound like ASSIGN_K_MAX; on the CPU
their plain versions.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .. import constants
from ..device import resolve, to_device, to_host, upload_packed
from ..kernels import kmeans as kmeans_kernels
from ..logger import sugar
from ..parallel.distributed import gather_shards, put_sharded_rows, sum_shards
from ..parallel.mesh import Mesh
from ..quant.layout import PackedVectors
from ..utils.profiling import append, count, span, traced
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


def prepare_tiles(packed: PackedVectors, chunk: int, device=None, mesh: Mesh | None = None):
    """Stage the corpus on the device once. Passing the result to several
    lloyd() calls avoids re-uploading the corpus per phase. Chunks are
    views of the staged rows, so nothing is padded.

    Returns (rows, chunk): rows is a PackedVectors of tensors on `device`,
    or with `mesh` a list of one PackedVectors a local shard, each on its
    shard's device (mesh.local_blocks: the last shards may hold fewer rows
    or none); `device` is then not used."""
    host = PackedVectors(*[to_host(a) for a in packed])
    if mesh is not None:
        return put_sharded_rows(host, mesh), chunk
    return upload_packed(host, resolve(device)), chunk


def _assign_and_accumulate(shards: list, chunk: int, centroids, mesh: Mesh | None):
    """One full Lloyd's pass over every shard's rows: returns (sums
    f32[K,D] and counts f32[K] on the first shard's device, summed over
    the shards, and each shard's assignments int32[rows])."""
    parts = []
    for rows in shards:
        if rows.n:
            append("kmeans.pass_shapes", (int(rows.codes.shape[0]), int(centroids.shape[0]),
                                          int(rows.codes.shape[1])))
            parts.append(kmeans_kernels.assign_accumulate(
                rows, centroids.to(rows.codes.device), chunk
            ))
        else:  # a shard past the end of the rows
            dev = rows.codes.device
            parts.append((
                torch.zeros(centroids.shape, dtype=torch.float32, device=dev),
                torch.zeros(centroids.shape[0], dtype=torch.float32, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev),
            ))
    if mesh is None:
        return parts[0][0], parts[0][1], [parts[0][2]]
    return (sum_shards(mesh, [p[0] for p in parts]),
            sum_shards(mesh, [p[1] for p in parts]), [p[2] for p in parts])


def _gather_assignments(mesh: Mesh | None, cids: list, n: int) -> np.ndarray:
    """Every row's assignment, in row order, from each shard's block."""
    if mesh is None:
        return to_host(cids[0])
    per = -(-n // mesh.size)
    padded = [torch.nn.functional.pad(c, (0, per - c.shape[0]), value=-1) for c in cids]
    return to_host(gather_shards(mesh, padded)).reshape(-1)[:n]


def _staged_device(prepared) -> torch.device:
    """The device of prepare_tiles' rows (a mesh's first shard's)."""
    rows = prepared[0]
    return (rows[0] if isinstance(rows, list) else rows).codes.device


def lloyd(
    packed: PackedVectors,
    init_centroids: np.ndarray,
    max_iters: int = constants.KMEANS_ITERATION_LIMIT,
    chunk: int = 16_384,
    tol_changes: int = 0,
    prepared=None,
    device=None,
    mesh: Mesh | None = None,
) -> KMeansResult:
    """Run Lloyd's iterations from the given centroids until the number of
    assignment changes is <= tol_changes (reference converges on unchanged
    quantized bytes — dnc/k_means.go:67-117 — we converge on assignments).
    With `mesh`, `prepared` must come from prepare_tiles on the same mesh."""
    if prepared is None:
        prepared = prepare_tiles(packed, chunk, device, mesh)
    rows, chunk = prepared
    shards = rows if mesh is not None else [rows]
    n = np.shape(packed.codes)[0]
    dev = shards[0].codes.device
    cents = to_device(np.asarray(init_centroids, np.float32), dev)
    counts = torch.zeros((cents.shape[0],), dtype=torch.float32, device=dev)
    prev = [torch.full((r.n,), -1, dtype=torch.int32, device=r.codes.device) for r in shards]
    it, changes = 0, 2**31 - 1
    while it < max_iters and changes > tol_changes:
        with span("kmeans.pass"):
            count("kmeans.passes")
            sums, counts, cids = _assign_and_accumulate(shards, chunk, cents, mesh)
            cents = torch.where(
                counts[:, None] > 0, sums / counts.clamp(min=1)[:, None], cents
            )
            moved = [(c != p).sum() for c, p in zip(cids, prev)]
            with span("kmeans.sync"):
                changes = int(moved[0] if mesh is None else sum_shards(mesh, moved))
        prev = cids
        it += 1
    with span("kmeans.sync"):
        centroids = to_host(cents)
    with span("kmeans.sync"):
        assignments = _gather_assignments(mesh, prev, n)
    with span("kmeans.sync"):
        counts = to_host(counts).astype(np.int64)
    return KMeansResult(
        centroids=centroids,
        assignments=assignments,
        counts=counts,
        iterations=it,
        final_changes=changes if it else -1,
    )


def sample_init(packed: PackedVectors, k: int, seed: int = 0) -> np.ndarray:
    """Initial centroids = dequantized random distinct data rows."""
    with span("build.gather"):
        n = np.shape(packed.codes)[0]
        rng = np.random.default_rng(seed)
        pick = rng.choice(n, size=min(k, n), replace=False)
        codes = to_host(packed.codes)[pick].astype(np.float32)
        scale = to_host(packed.scale)[pick]
        offset = to_host(packed.offset)[pick]
        return offset[:, None] + scale[:, None] * codes


def _take(packed: PackedVectors, rows: np.ndarray) -> PackedVectors:
    with span("build.gather"):
        return PackedVectors(*[to_host(a)[rows] for a in packed])


def _members_by_cluster(assignments: np.ndarray, clusters: np.ndarray) -> list[np.ndarray]:
    """Each cluster's rows, as `np.nonzero(assignments == c)[0]` gives them
    (ascending int64), for every id in `clusters`, from one read of the
    assignments (ids >= 0): a lookup of the clusters' ids selects their
    rows, and a stable sort of the selected ids alone groups them by id,
    keeping each group's rows ascending."""
    lut = np.zeros(int(clusters.max()) + 2, dtype=bool)
    lut[clusters] = True  # ids past the largest cluster clip to the last, False entry
    rows = np.flatnonzero(np.take(lut, assignments, mode="clip"))
    ids = assignments[rows]
    rows = rows[np.argsort(ids, kind="stable")]
    start = np.concatenate(([0], np.cumsum(np.bincount(ids, minlength=lut.size))))
    return [rows[start[c]:start[c + 1]] for c in clusters]


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
    mesh: Mesh | None = None,
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
        prepared = prepare_tiles(packed, chunk, device, mesh)
    device = _staged_device(prepared)
    k_super = min(k * max(1, superset_mul), n)
    # the superset only seeds the init, so its size rounds DOWN to a
    # power-of-two class (as in the JAX package): 4x seeds cost half of
    # 5x and seed k just as well
    half = _pow2_class(k_super) // 2
    if k < half < k_super:  # shrink only — never inflate a small superset
        k_super = half
    init = sample_init(packed, k_super, seed=seed)
    if k_super > k:
        # the superset phase runs on a SAMPLE (the reference k-means's
        # 50k sample, dnc/dnc.go:320-324)
        sample_n = min(n, max(constants.SAMPLE_SIZE, 12 * k_super))
        if sample_n < n:
            with span("build.gather"):
                rng = np.random.default_rng(seed + 1)
                pick = np.sort(rng.choice(n, size=sample_n, replace=False))
            with _progress.phase(
                "superset", f"{k_super} seeds / {sample_n}-row sample"
            ) as ph:
                phase1 = lloyd(
                    _take(packed, pick), init, max_iters=superset_iters,
                    chunk=min(chunk, 8_192), device=device, mesh=mesh,
                )
        else:
            with _progress.phase("superset", f"{k_super} seeds / full corpus") as ph:
                phase1 = lloyd(
                    packed, init, max_iters=superset_iters, prepared=prepared,
                    mesh=mesh,
                )
        top = np.argsort(-phase1.counts, kind="stable")[:k]
        init = phase1.centroids[top]
        sugar().info(
            "build: superset %d seeds / %d-row sample: %.1fs",
            k_super, min(sample_n, n), ph.seconds,
        )
    with _progress.phase("lloyd", f"k={k}, n={n}") as ph:
        result = lloyd(packed, init, max_iters=max_iters, prepared=prepared, mesh=mesh)
    if k_super > k:  # a top-level build (a balance round's sub-builds log nothing)
        sugar().info("build: lloyd %d iters: %.1fs", result.iterations, ph.seconds)
    return result


@traced("build")
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
    mesh: Mesh | None = None,
) -> KMeansResult:
    """Full index build: k = ceil(n / target), k-means, drop small clusters,
    reassign and recenter, then split oversized clusters (balance).
    Replaces dnc.KMeansDivideAndConquer (dnc/dnc.go:35-263 +
    dropSmallCentroids + recenterDbCentroid + the recursive size bound).
    With `mesh` the superset, main, drop-small and balance passes run on
    its shards; a balance round's sub-splits (a sample of one cluster's
    members) run on its first device, as the JAX module runs them off the
    mesh. The whole build is the span `build`."""
    n = np.shape(packed.codes)[0]
    if k is None:
        k = max(1, -(-n // target_cluster_size))
    if min_cluster_size is None:
        min_cluster_size = max(1, target_cluster_size // 10)

    with _progress.phase("upload", f"{n} rows -> device") as ph:
        prepared = prepare_tiles(packed, chunk, device, mesh)
    sugar().info("build: prepare(upload) %.1fs", ph.seconds)
    result = kmeans(
        packed, k, max_iters=max_iters, chunk=chunk, seed=seed,
        superset_iters=superset_iters, prepared=prepared, mesh=mesh,
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
        ) as ph:
            # one Lloyd's iteration against survivors = reassign+recenter,
            # then recenter once more for the new assignment
            result = lloyd(
                packed, result.centroids[~small], max_iters=1,
                tol_changes=-1, prepared=prepared, mesh=mesh,
            )
            result = lloyd(
                packed, result.centroids, max_iters=1, tol_changes=-1,
                prepared=prepared, mesh=mesh,
            )
        sugar().info(
            "build: drop-small (%d dropped) %.1fs", int(small.sum()), ph.seconds
        )

    # balance: split clusters larger than 2x the mean by a local k-means
    # on their members — one level of the reference's divide step
    # (dnc/dnc.go:320-335). Skew sets the uniform bucket capacity.
    for round_i in range(balance_rounds):
        mean_count = max(1, int(result.counts.sum() // max(1, len(result.counts))))
        oversized = np.nonzero(result.counts > 2 * mean_count)[0]
        if oversized.size == 0:
            break
        with _progress.phase(
            "balance", f"round {round_i + 1}: {oversized.size} splits"
        ) as ph:
            split = set(oversized.tolist())
            new_centroids = [
                result.centroids[i] for i in range(len(result.counts))
                if i not in split
            ]
            with span("balance.members"):
                count("balance.splits", int(oversized.size))
                members_of = _members_by_cluster(result.assignments, oversized)
            for ci, members in zip(oversized, members_of):
                if members.size > constants.SAMPLE_SIZE:
                    members = np.random.default_rng(seed + int(ci)).choice(
                        members, size=constants.SAMPLE_SIZE, replace=False
                    )
                k_sub = max(2, -(-int(result.counts[ci]) // mean_count))
                sub_res = kmeans(
                    _take(packed, members), k_sub, max_iters=10,
                    superset_mul=1, chunk=chunk, seed=seed + int(ci),
                    device=_staged_device(prepared),
                )
                new_centroids.extend(list(sub_res.centroids))
            result = lloyd(
                packed, np.stack(new_centroids), max_iters=2,
                tol_changes=-1, prepared=prepared, mesh=mesh,
            )
        sugar().info(
            "build: balance round (%d split) %.1fs", oversized.size, ph.seconds
        )
    return dataclasses.replace(
        result, iterations=main_iters, final_changes=main_churn
    )
