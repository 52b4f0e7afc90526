"""Peaks of the card and the work the algorithms need, counted from their
inputs (never from a kernel's tiles, which a redesign changes).

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the 700 W
power limit. The run prints the card's own power limit beside them.
"""
from __future__ import annotations

import numpy as np

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_BF16_PER_S = 989e12  # both scan and assign multiply bf16 operands
SIDE_BYTES = 12  # a row's f32 scale, offset and reciprocal norm


def least_s(bytes_moved: float, ops: float, peak_ops: float) -> float:
    """The least time the card could take: bytes over the memory rate or
    operations over their peak rate, whichever is larger."""
    return max(bytes_moved / PEAK_BYTES_PER_S, ops / peak_ops)


def scan_work(probed: np.ndarray, cluster_rows: np.ndarray, dim: int, k: int) -> tuple[float, float]:
    """(bytes, operations) of one batched IVF scan: probed int [B, nprobe]
    the clusters each query probes, cluster_rows int [K] the live rows a
    cluster holds. Bytes: each distinct probed cluster's rows (codes and
    sidecars) read once, the bf16 queries read once, and each query's k
    (score, slot) pairs written once. Operations: 2 * D for every (query,
    probed row)."""
    b = probed.shape[0]
    distinct = np.unique(probed)
    rows_read = float(cluster_rows[distinct].sum())
    pairs = float(cluster_rows[probed].sum())
    bytes_moved = rows_read * (dim + SIDE_BYTES) + b * dim * 2 + b * k * 12
    return bytes_moved, 2.0 * dim * pairs


def assign_ops(n: int, k: int, dim: int) -> float:
    """Operations of one nearest-centroid pass: 2 * D for every (row, centroid)."""
    return 2.0 * n * k * dim
