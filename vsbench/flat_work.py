"""The work an exact flat search needs, counted from its inputs (never
from the kernels that do it, which a redesign changes), and the peak it
is held to.

The coarse scan's product is int8 codes against int8 query codes, so the
int8 peak is the fastest rate this work admits, whatever implements it:
an f32 product of the int8 values (the streamed scan) and the s8 band
kernel read the same work and neither can pass 100% of it.
"""
from __future__ import annotations

from . import roofline

PEAK_INT8_PER_S = 1979e12  # one NVIDIA H100 SXM, dense, NVIDIA's data sheet
MASK_BYTES = 1  # a row's bool in the index's live mask


def flat_work(n: int, dim: int, batch: int, k: int, calls: int) -> tuple[float, float]:
    """(bytes, operations) of `calls` flat searches of `batch` f32 queries
    over n live rows of dim codes: each call reads the rows' codes,
    sidecars and mask byte once and the f32 queries once, and writes each
    query's k (score, id) pairs once; 2 * D operations a (query, row)."""
    per_call = (n * (dim + roofline.SIDE_BYTES + MASK_BYTES) + batch * dim * 4
                + batch * k * 12)
    return float(calls) * per_call, float(calls) * 2.0 * batch * n * dim
