"""Device-friendly struct-of-arrays layout for quantized corpora.

The reference dequantizes every SQL batch to float64 before scoring
(reference: compute/compute.go:32-44) — the single biggest inefficiency in
its hot loop. Here the corpus stays quantized in HBM and is scored directly
on the MXU:

  wire code  q  in [0,255]      (uint8, v = min + (q/255)(max-min))
  stored     c  = q - 128       (int8 — fits the MXU's s8 operand range)
  affine     v  = offset + scale * c
             scale  = (max - min) / 255
             offset = min + 128 * scale

Per-vector f32 sidecar: `scale`, `offset`, `inv_norm` (1/||v||2 of the
dequantized vector, 0 for zero vectors). Cosine similarity against an
L2-normalized query x then needs only the affine identity

  cos(x, v) = (scale * <x, c> + offset * sum(x)) * inv_norm

i.e. one int8-operand matmul plus a rank-1 correction — no dequantization,
no per-batch normalization pass (reference does both per batch:
compute/cosine.go:25-33).

PackedVectors is a NamedTuple, hence a JAX pytree: it can cross jit /
shard_map boundaries and be donated.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import codec


class PackedVectors(NamedTuple):
    """Quantized corpus shard resident in device memory.

    Attributes:
      codes: int8[N, D] centered codes (q - 128).
      scale: f32[N] per-vector affine scale.
      offset: f32[N] per-vector affine offset (of the centered code).
      inv_norm: f32[N] reciprocal L2 norm of the dequantized vector.
    """

    codes: np.ndarray
    scale: np.ndarray
    offset: np.ndarray
    inv_norm: np.ndarray

    @property
    def n(self) -> int:
        return self.codes.shape[0]

    @property
    def dim(self) -> int:
        return self.codes.shape[-1]


def pack_wire(wire: np.ndarray) -> PackedVectors:
    """Build the device layout from wire-format rows (host-side; native C++
    fast path when available, numpy otherwise)."""
    wire = np.atleast_2d(np.asarray(wire, dtype=np.uint8))
    from .. import native

    fast = native.pack_wire(wire)
    if fast is not None:
        codes, scale, offset, inv_norm = fast
        return PackedVectors(
            codes=codes, scale=scale, offset=offset, inv_norm=inv_norm
        )
    vmin, vmax = codec.parse_header(wire)
    q = codec.payload(wire)
    scale = (vmax - vmin) / np.float32(255)
    offset = vmin + np.float32(128) * scale
    centered = (q.astype(np.int16) - 128).astype(np.int8)
    # Norm of the dequantized vector, computed in f32 like the reference's
    # Gorgonia backend (compute/compute_gorgonia.go:43-51).
    v = offset[:, None] + scale[:, None] * centered.astype(np.float32)
    norm = np.linalg.norm(v, axis=-1)
    inv_norm = np.where(norm == 0, 0, 1.0 / np.where(norm == 0, 1, norm))
    return PackedVectors(
        codes=centered,
        scale=scale.astype(np.float32),
        offset=offset.astype(np.float32),
        inv_norm=inv_norm.astype(np.float32),
    )


def pack_float(v: np.ndarray) -> PackedVectors:
    """Quantize float vectors and build the device layout in one step."""
    return pack_wire(codec.quantize(np.atleast_2d(v)))


def unpack(p: PackedVectors) -> np.ndarray:
    """Dequantize back to f32 (test/debug path)."""
    codes = np.asarray(p.codes, dtype=np.float32)
    return np.asarray(p.offset)[:, None] + np.asarray(p.scale)[:, None] * codes


def to_wire(p: PackedVectors) -> np.ndarray:
    """Re-encode the packed layout into wire rows (for persistence)."""
    codes = np.asarray(p.codes)
    scale = np.asarray(p.scale, dtype=np.float32)
    offset = np.asarray(p.offset, dtype=np.float32)
    q = (codes.astype(np.int16) + 128).astype(np.uint8)
    vmin = offset - np.float32(128) * scale
    vmax = vmin + scale * np.float32(255)
    out = np.empty((codes.shape[0], codec.HEADER_BYTES + codes.shape[1]), np.uint8)
    header = np.stack([vmin, vmax], axis=-1)
    out[:, : codec.HEADER_BYTES] = header.astype("<f4").view(np.uint8)
    out[:, codec.HEADER_BYTES :] = q
    return out


def concat(a: PackedVectors, b: PackedVectors) -> PackedVectors:
    return PackedVectors(
        codes=np.concatenate([np.asarray(a.codes), np.asarray(b.codes)], axis=0),
        scale=np.concatenate([np.asarray(a.scale), np.asarray(b.scale)], axis=0),
        offset=np.concatenate([np.asarray(a.offset), np.asarray(b.offset)], axis=0),
        inv_norm=np.concatenate(
            [np.asarray(a.inv_norm), np.asarray(b.inv_norm)], axis=0
        ),
    )


def empty(dim: int) -> PackedVectors:
    return PackedVectors(
        codes=np.zeros((0, dim), np.int8),
        scale=np.zeros((0,), np.float32),
        offset=np.zeros((0,), np.float32),
        inv_norm=np.zeros((0,), np.float32),
    )


def take(p: PackedVectors, idx: np.ndarray) -> PackedVectors:
    return PackedVectors(
        codes=np.asarray(p.codes)[idx],
        scale=np.asarray(p.scale)[idx],
        offset=np.asarray(p.offset)[idx],
        inv_norm=np.asarray(p.inv_norm)[idx],
    )
