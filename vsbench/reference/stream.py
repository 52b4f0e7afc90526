"""The live rows of an index that takes writes: what its searches are owed
after w writes.

A stream cell starts from the configuration's base rows (ids 0 .. n-1,
each in the cluster of its generating direction) and writes the stream's
rows in their order, `rows_per_write` at a time, with the ids that follow
(n, n + 1, ...). After w writes the live rows are the base rows and the
first w * rows_per_write stream rows; a row's id is its number in that
sequence, and its cluster is its member (its generating direction).

Where the program puts a written row, a bucket or the spill tail of a
cluster whose bucket is full, is the program's business: the reference
owes each query its probed clusters' live rows (reference/ivf.py, given
the slabs and members below). A row that the program finds in its spill
tail although the query did not probe its cluster may come back too; it
is then judged better than the reference's row it displaced, never worse
(vsbench/checks.py: `topk_gap` is the reference's top k less the true
cosines of the rows returned).

Packed rows are host arrays (codes int8 [m, D], scale, offset, inv_norm
f32 [m]); a row's vector is offset + scale * code, in float64 here.

Imports nothing of the program under test.
"""
from __future__ import annotations

import numpy as np
import torch

SLAB = 250_000  # rows a slab of the reference's float64 search


def n_live(n_base: int, rows_per_write: int, writes: int) -> int:
    """Rows live after `writes` writes."""
    return n_base + rows_per_write * writes


def members(base_members: np.ndarray, stream_members: np.ndarray, live: int) -> np.ndarray:
    """Each live row's cluster, int64 [live], in id order."""
    n_base = len(base_members)
    return np.concatenate([np.asarray(base_members[: min(live, n_base)], np.int64),
                           np.asarray(stream_members[: max(0, live - n_base)], np.int64)])


def _dequantize(packed, idx: np.ndarray) -> np.ndarray:
    codes, scale, offset = packed[0], packed[1], packed[2]
    return offset[idx, None].astype(np.float64) + scale[idx, None].astype(np.float64) * codes[idx]


def rows_f64(base, stream, ids: np.ndarray) -> np.ndarray:
    """The live rows of `ids` (int [m], each below the live count) as
    float64 vectors [m, D]."""
    ids = np.asarray(ids, np.int64)
    n_base = base[0].shape[0]
    out = np.empty((len(ids), base[0].shape[1]), np.float64)
    old = ids < n_base
    out[old] = _dequantize(base, ids[old])
    out[~old] = _dequantize(stream, ids[~old] - n_base)
    return out


def slabs(base, stream, live: int, dev, step: int = SLAB):
    """(first id, float64 rows on dev) over every live row once, in id
    order: the base rows, then the stream's rows written so far."""
    n_base = base[0].shape[0]
    for part, first, n in ((base, 0, min(live, n_base)), (stream, n_base, max(0, live - n_base))):
        codes, scale, offset = part[0], part[1], part[2]
        for lo in range(0, n, step):
            hi = min(lo + step, n)
            c = torch.from_numpy(codes[lo:hi]).to(dev).double()
            s = torch.from_numpy(scale[lo:hi]).to(dev).double()
            o = torch.from_numpy(offset[lo:hi]).to(dev).double()
            yield first + lo, o[:, None] + s[:, None] * c
