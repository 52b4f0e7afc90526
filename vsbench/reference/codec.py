"""The 1-byte affine wire format, written out plainly: the format that the
served engine stores and that its embedding provider returns.

    [4 B little-endian f32 min][4 B little-endian f32 max][D x uint8 q]
    min and max are folded from 0, so the range always holds 0;
    q = trunc((v - min) / (max - min) * 255); v' = min + q / 255 * (max - min)

The benchmark quantizes its generated rows with `quantize_rows` (on the
card, a slab at a time) and the reference reads them back with
`dequantize` in float64. Nothing here comes from the program under test.
"""
from __future__ import annotations

import numpy as np
import torch

HEADER = 8


def quantize_rows(v: torch.Tensor) -> torch.Tensor:
    """f32 rows [m, D] (any device) as wire rows uint8 [m, 8 + D] there."""
    v = v.float()
    vmin = v.amin(dim=-1).clamp(max=0)
    vmax = v.amax(dim=-1).clamp(min=0)
    span = vmax - vmin
    safe = torch.where(span == 0, torch.ones_like(span), span)
    q = torch.trunc((v - vmin[:, None]) / safe[:, None] * 255.0).clamp(0, 255)
    q = torch.where(span[:, None] == 0, torch.zeros_like(q), q).to(torch.uint8)
    header = torch.stack([vmin, vmax], dim=-1).contiguous().view(torch.uint8)
    return torch.cat([header.view(v.shape[0], HEADER), q], dim=1)


def quantize(v: np.ndarray) -> np.ndarray:
    """Host f32 rows [m, D] as wire rows (the same arithmetic on the CPU)."""
    return quantize_rows(torch.from_numpy(np.ascontiguousarray(v, np.float32))).numpy()


def header(wire: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(min, max) f32 [m] of wire rows."""
    h = np.ascontiguousarray(np.asarray(wire, np.uint8)[:, :HEADER]).view("<f4")
    return h[:, 0], h[:, 1]


def dequantize(wire: np.ndarray) -> np.ndarray:
    """Wire rows as float64 vectors [m, D]."""
    vmin, vmax = (x.astype(np.float64) for x in header(wire))
    q = np.asarray(wire, np.uint8)[:, HEADER:].astype(np.float64)
    return vmin[:, None] + q / 255.0 * (vmax - vmin)[:, None]

