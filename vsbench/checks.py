"""The comparisons that decide `correct`: what the timed path produced,
held against the plain reference (vsbench/reference), each number beside
the limit that the cell's traffic file sets for it.

Search answers (served and library cells), a sample drawn from the seed:
- sim_err: the widest gap between a similarity the program returned and
  the reference's cosine of the query with the row it named (float64);
- topk_gap: the widest gap, rank by rank, by which the reference's cosines
  of the rows returned lie below the reference's own top k among the
  probed clusters (a row missing from an answer reads infinite);
- bad_answers: answers with a row twice or a row number outside the
  corpus (exact: limit 0).
A build (the k-means cell), its last full Lloyd's pass:
- assign_regret: the widest gap between a row's best cosine to the pass's
  input centroids and its cosine to the one it was assigned;
- mean_err: the widest relative distance between a centroid returned and
  the float64 mean of the rows assigned to it;
- count_err: rows by which the counts returned differ from the
  assignment's (exact: limit 0).
Every cell also holds `failed` (requests or calls that failed) to 0.
"""
from __future__ import annotations

import math

import numpy as np

from .reference import ivf as ref_ivf
from .reference import kmeans as ref_kmeans

BIG = 1e300  # how an infinite reading is printed (JSON has no infinity)


def judge_search(served_rows: np.ndarray, served_sims: np.ndarray, queries: np.ndarray,
                 rows_f64, ref_sims: np.ndarray, n_rows: int) -> dict:
    """served_rows int64 [Q, k] (-1 where an answer holds fewer rows),
    served_sims [Q, k], queries f32 [Q, D] as the program received them,
    rows_f64(idx int64 [m]) -> f64 [m, D], ref_sims f64 [Q, k] the
    reference's top k. Returns {sim_err, topk_gap, bad_answers}."""
    served_rows = np.asarray(served_rows, np.int64)
    q, k = served_rows.shape
    present = served_rows >= 0
    outside = present & (served_rows >= n_rows)
    bad = int(outside.any(axis=1).sum())
    for r in range(q):
        got = served_rows[r][present[r]]
        bad += int(len(np.unique(got)) < len(got))
    safe = np.where(present & ~outside, served_rows, 0)
    vecs = rows_f64(safe.reshape(-1)).reshape(q, k, -1)
    true = ref_ivf.cosines(queries, vecs)
    true = np.where(present & ~outside, true, -np.inf)
    ok = present & ~outside
    err = np.abs(np.asarray(served_sims, np.float64)[ok] - true[ok])
    sim_err = float(err.max()) if ok.any() else math.inf
    true_sorted = -np.sort(-true, axis=1)
    want = np.asarray(ref_sims, np.float64)
    gap = np.where(np.isneginf(want), 0.0, want - true_sorted)
    return {"sim_err": sim_err, "topk_gap": float(np.nan_to_num(gap, nan=math.inf).max()),
            "bad_answers": bad}


def judge_pass(slabs, prev_centroids: np.ndarray, centroids: np.ndarray,
               assignments: np.ndarray, counts: np.ndarray, n_rows: int, dev) -> dict:
    """A Lloyd's pass from prev_centroids [k, D] that returned (centroids,
    assignments [n], counts [k]); slabs() iterates the rows in float64.
    Returns {assign_regret, mean_err, count_err}."""
    k, dim = np.shape(prev_centroids)
    assignments = np.asarray(assignments)
    if np.shape(centroids) != (k, dim) or assignments.shape != (n_rows,) or len(counts) != k:
        return {"assign_regret": math.inf, "mean_err": math.inf, "count_err": n_rows}
    regret = ref_kmeans.assignment_regret(slabs(), prev_centroids, assignments, dev)
    if not math.isfinite(regret):
        return {"assign_regret": math.inf, "mean_err": math.inf, "count_err": n_rows}
    sums, ref_counts = ref_kmeans.member_sums(slabs(), assignments, k, dim, dev)
    ref_counts = ref_counts.cpu().numpy()
    count_err = int(np.abs(np.asarray(counts, np.int64) - ref_counts).sum())
    has = ref_counts > 0
    mean = sums.cpu().numpy()[has] / ref_counts[has, None]
    dist = np.linalg.norm(np.asarray(centroids, np.float64)[has] - mean, axis=1)
    mean_err = float((dist / np.maximum(np.linalg.norm(mean, axis=1), 1e-30)).max()) if has.any() else math.inf
    return {"assign_regret": regret, "mean_err": mean_err, "count_err": count_err}


def with_limits(readings: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every reading that has a limit (a
    reading without one is a fault of the traffic file)."""
    out = {}
    for name, value in readings.items():
        if name not in limits:
            raise KeyError(f"no limit for check {name!r} in the traffic file")
        out[name] = {"value": value, "limit": limits[name]}
    return out


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def printable(x):
    """A reading as a JSON number: infinities as BIG."""
    if isinstance(x, float) and not math.isfinite(x):
        return BIG
    return x
