"""1-byte affine quantization codec — byte-compatible with the reference.

Wire format (reference: compute/quantization.go:71-80):

    [4B little-endian float32 min][4B little-endian float32 max][D x uint8]

Semantics mirrored exactly:
  * min/max are folded starting from 0, so the quantization range ALWAYS
    includes 0 (reference: compute/quantization.go:182-216).
  * quantize: clip to [min,max], normalize to [0,1], scale by 255 and
    TRUNCATE toward zero (Go's float->uint8 conversion;
    reference: compute/quantization.go:8-19).
  * dequantize: v = min + (q/255)*(max-min)
    (reference: compute/quantization.go:47-53).
  * the float64 variant quantizes against float64 min/max but stores the
    header as float32 (reference: compute/quantization.go:93-102).

This is the host-side codec (numpy, vectorised over batches). The device
layout derived from it lives in `vectorsearch_tpu_torch.quant.layout`.
"""
from __future__ import annotations

import numpy as np

HEADER_BYTES = 8


def _range_including_zero(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row (min, max) folded from an initial value of 0."""
    vmin = np.minimum(v.min(axis=-1), 0)
    vmax = np.maximum(v.max(axis=-1), 0)
    return vmin, vmax


def quantize(v: np.ndarray) -> np.ndarray:
    """Quantize float vectors to the wire format.

    Args:
      v: float32 or float64 array of shape (..., D).
    Returns:
      uint8 array of shape (..., 8 + D).
    """
    v = np.asarray(v)
    if v.dtype not in (np.float32, np.float64):
        v = v.astype(np.float32)
    if v.dtype == np.float32 and v.ndim == 2:
        from .. import native

        fast = native.quantize_f32(v)
        if fast is not None:
            return fast
    vmin, vmax = _range_including_zero(v)

    # Quantization arithmetic happens in the input dtype (f32 or f64),
    # matching QuantizeVectorFloat32/Float64.
    span = vmax - vmin
    safe_span = np.where(span == 0, 1, span)
    clipped = np.clip(v, vmin[..., None], vmax[..., None])
    normalized = (clipped - vmin[..., None]) / safe_span[..., None]
    scaled = normalized * np.asarray(255, dtype=v.dtype)
    q = np.trunc(scaled).astype(np.uint8)
    q = np.where(span[..., None] == 0, np.uint8(0), q)

    out = np.empty(v.shape[:-1] + (HEADER_BYTES + v.shape[-1],), dtype=np.uint8)
    # Header always stores float32 min/max, little-endian.
    header = np.stack(
        [vmin.astype(np.float32), vmax.astype(np.float32)], axis=-1
    )
    out[..., :HEADER_BYTES] = (
        header.astype("<f4").view(np.uint8).reshape(v.shape[:-1] + (8,))
    )
    out[..., HEADER_BYTES:] = q
    return out


def parse_header(wire: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split wire rows into (min, max) float32 per row."""
    wire = np.ascontiguousarray(np.asarray(wire, dtype=np.uint8))
    header = wire[..., :HEADER_BYTES].view("<f4")
    return header[..., 0], header[..., 1]


def payload(wire: np.ndarray) -> np.ndarray:
    """The raw uint8 code payload (view, shape (..., D))."""
    return np.asarray(wire, dtype=np.uint8)[..., HEADER_BYTES:]


def dequantize(wire: np.ndarray, dtype=np.float32) -> np.ndarray:
    """Dequantize wire rows back to float vectors of the given dtype."""
    wire_arr = np.asarray(wire, dtype=np.uint8)
    if dtype == np.float32 and wire_arr.ndim == 2:
        from .. import native

        fast = native.dequantize_f32(wire_arr)
        if fast is not None:
            return fast
    vmin, vmax = parse_header(wire)
    q = payload(wire)
    vmin = vmin.astype(dtype)
    vmax = vmax.astype(dtype)
    norm = q.astype(dtype) / np.asarray(255, dtype=dtype)
    return vmin[..., None] + norm * (vmax - vmin)[..., None]


def quantize_scalar(value: float, vmin: float, vmax: float, dtype=np.float32) -> int:
    """Scalar quantize against an explicit range (reference: quantization.go:8-19)."""
    value = dtype(min(max(value, vmin), vmax))
    span = dtype(vmax) - dtype(vmin)
    if span == 0:
        return 0
    normalized = (value - dtype(vmin)) / span
    return int(np.trunc(normalized * dtype(255)))


def dequantize_scalar(q: int, vmin: float, vmax: float, dtype=np.float32) -> float:
    """Scalar dequantize (reference: quantization.go:47-53)."""
    normalized = dtype(q) / dtype(255)
    return float(dtype(vmin) + normalized * (dtype(vmax) - dtype(vmin)))


def wire_dim(wire_row_len: int) -> int:
    """Vector dimensionality for a wire row length."""
    return wire_row_len - HEADER_BYTES
