"""Plain IVF search: the answers an IVF index owes its callers.

An IVF index over rows with given cluster assignments and centroids,
searched at (k, nprobe), owes each query the k rows of highest cosine
similarity among the rows of the nprobe clusters whose centroids have the
highest cosine similarity to the query, with those similarities. Here
that is computed directly: every row against every query in float64, the
rows outside a query's probed clusters masked, a running top-k over
slabs of rows. No candidate list, no quantized scan, no kernel.

`precision="tf32"` computes the same in the nearest precision below the
served float32 one: every matrix product's inputs rounded to TF32 (10
mantissa bits) and accumulated in float32. That is the control that has
to fail the comparison.

Imports nothing of the program under test.
"""
from __future__ import annotations

import numpy as np
import torch

PRECISIONS = ("f64", "tf32")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to the nearest TF32 value (10 mantissa bits),
    ties away from zero, as the tensor cores round their inputs."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _cast(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f64":
        return x.double()
    if precision == "tf32":
        return round_tf32(x.float())
    raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def _unit(x: torch.Tensor) -> torch.Tensor:
    n = x.norm(dim=-1, keepdim=True)
    return x / torch.where(n == 0, torch.ones_like(n), n)


def probe(queries: np.ndarray, centroids: np.ndarray, nprobe: int, dev,
          precision: str = "f64") -> np.ndarray:
    """The nprobe clusters of highest cosine similarity to each query,
    int64 [Q, nprobe]."""
    q = _cast(_unit(torch.from_numpy(np.asarray(queries, np.float64)).to(dev)), precision)
    c = _cast(_unit(torch.from_numpy(np.asarray(centroids, np.float64)).to(dev)), precision)
    return torch.topk(q @ c.T, nprobe, dim=-1).indices.cpu().numpy()


def search(queries: np.ndarray, centroids: np.ndarray, assignments: np.ndarray,
           slabs, nprobe: int, k: int, dev, precision: str = "f64"):
    """(similarities f64 [Q, k] in descending order, row numbers int64
    [Q, k]) of each query's top k among its probed clusters' rows.

    slabs: an iterable of (start, rows [m, D] as a float64 numpy array or
    tensor) covering every row once, in any order; assignments int [n]:
    each row's cluster. Rows are compared as unit vectors; a query with
    fewer than k rows in its clusters gets -inf and -1 after them."""
    probed = probe(queries, centroids, nprobe, dev, precision)
    n_q = probed.shape[0]
    member = torch.zeros((n_q, len(centroids)), dtype=torch.bool, device=dev)
    member[torch.arange(n_q, device=dev)[:, None], torch.from_numpy(probed).to(dev)] = True
    assign = torch.from_numpy(np.asarray(assignments, np.int64))
    q = _cast(_unit(torch.from_numpy(np.asarray(queries, np.float64)).to(dev)), precision)
    best_s = torch.full((n_q, k), float("-inf"), dtype=torch.float64, device=dev)
    best_i = torch.full((n_q, k), -1, dtype=torch.int64, device=dev)
    for start, rows in slabs:
        v = torch.as_tensor(rows).to(dev, torch.float64)
        s = (q @ _cast(_unit(v), precision).T).double()
        inside = member[:, assign[start : start + v.shape[0]].to(dev)]
        s = torch.where(inside, s, float("-inf"))
        idx = torch.arange(start, start + v.shape[0], device=dev).expand(n_q, -1)
        s, pos = torch.topk(torch.cat([best_s, s], dim=1), k, dim=-1)
        best_i = torch.gather(torch.cat([best_i, idx], dim=1), 1, pos)
        best_s = s
    best_i = torch.where(torch.isneginf(best_s), -1, best_i)
    return best_s.cpu().numpy(), best_i.cpu().numpy()


def cosines(queries: np.ndarray, rows: np.ndarray, precision: str = "f64") -> np.ndarray:
    """Cosine similarity of query i with rows[i, j], f64 [Q, m]: rows f64
    [Q, m, D] (the vectors a search returned for each query)."""
    q = _cast(_unit(torch.from_numpy(np.asarray(queries, np.float64))), precision)
    v = _cast(_unit(torch.from_numpy(np.asarray(rows, np.float64))), precision)
    return torch.einsum("qd,qmd->qm", q, v).double().numpy()
