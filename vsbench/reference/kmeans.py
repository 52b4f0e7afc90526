"""Plain Lloyd's k-means pass: what one pass of a centroid build owes.

A pass from centroids C assigns every row to the centroid of highest
cosine similarity, counts each cluster's rows, and moves each centroid
with members to the mean of its rows (a centroid without members stays
where it was). Here: rows as float64 vectors, slab by slab, the
similarities in float32 with every product exact (no TF32), the sums in
float64.

`lloyd_pass(..., control=True)` computes the same pass one precision
below the build's own (int8 codes against bfloat16 centroids, float32
sums): the centroids rounded to float8 (e4m3) for the assignment and the
sums kept in bfloat16. That is the control that has to fail the
comparison.

Imports nothing of the program under test.
"""
from __future__ import annotations

import numpy as np
import torch


def _unit(x: torch.Tensor) -> torch.Tensor:
    n = x.norm(dim=-1, keepdim=True)
    return x / torch.where(n == 0, torch.ones_like(n), n)


def _exact_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b.T in float32 with TF32 off for this product."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a.float() @ b.float().T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def assignment_regret(slabs, centroids: np.ndarray, assignments: np.ndarray, dev) -> float:
    """The widest gap, over all rows, between a row's best cosine to the
    centroids and its cosine to the centroid it was assigned: 0 for an
    exact assignment, rounding where the assigning side ran at a lower
    precision, and large for a row put in the wrong cluster."""
    c = _unit(torch.from_numpy(np.asarray(centroids, np.float64)).to(dev)).float()
    a = torch.from_numpy(np.asarray(assignments, np.int64))
    worst = 0.0
    for start, rows in slabs:
        v = _unit(torch.as_tensor(rows).to(dev, torch.float64)).float()
        s = _exact_f32(v, c)
        mine = a[start : start + v.shape[0]].to(dev)
        if int(mine.min()) < 0 or int(mine.max()) >= c.shape[0]:
            return float("inf")
        got = torch.gather(s, 1, mine[:, None])[:, 0]
        worst = max(worst, float((s.max(dim=1).values - got).max()))
    return worst


def member_sums(slabs, assignments: np.ndarray, k: int, dim: int, dev):
    """(sums f64 [k, D], counts int64 [k]) of the rows of each cluster."""
    a = torch.from_numpy(np.asarray(assignments, np.int64))
    sums = torch.zeros((k, dim), dtype=torch.float64, device=dev)
    counts = torch.zeros(k, dtype=torch.int64, device=dev)
    for start, rows in slabs:
        v = torch.as_tensor(rows).to(dev, torch.float64)
        mine = a[start : start + v.shape[0]].to(dev)
        sums.index_add_(0, mine, v)
        counts += torch.bincount(mine, minlength=k)
    return sums, counts


def lloyd_pass(slabs, centroids: np.ndarray, dev, control: bool = False):
    """One pass from `centroids` f32 [k, D]: (new centroids f32 [k, D],
    assignments int32 [n], counts int64 [k])."""
    c = _unit(torch.from_numpy(np.asarray(centroids, np.float32)).to(dev))
    if control:
        c = c.to(torch.float8_e4m3fn).float()
    k, dim = c.shape
    sum_dtype = torch.bfloat16 if control else torch.float64
    sums = torch.zeros((k, dim), dtype=sum_dtype, device=dev)
    counts = torch.zeros(k, dtype=torch.int64, device=dev)
    parts = []
    for start, rows in slabs:
        v = torch.as_tensor(rows).to(dev, torch.float64)
        mine = _exact_f32(_unit(v), c).argmax(dim=1)
        sums.index_add_(0, mine, v.to(sum_dtype))
        counts += torch.bincount(mine, minlength=k)
        parts.append(mine.to(torch.int32).cpu())
    prev = torch.from_numpy(np.asarray(centroids, np.float32)).to(dev)
    new = torch.where(counts[:, None] > 0, (sums.double() / counts.clamp(min=1)[:, None]).float(), prev)
    return new.cpu().numpy(), torch.cat(parts).numpy(), counts.cpu().numpy()
