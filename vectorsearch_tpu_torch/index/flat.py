"""Device-resident flat (exhaustive) index with append and tombstones.

Counterpart of vectorsearch_tpu/index/flat.py. The corpus lives on the
device as a capacity-padded PackedVectors of tensors; searches are one
chunked scan plus an optional exact-f32 re-rank.

Copy on write: mutating operations return a new FlatIndex and never write
into a tensor an older index still holds, so lock-free readers keep their
snapshot (the JAX package gets this from immutable arrays). Out-of-range
scatter indices are never formed: torch raises on them, and on CUDA a
device-side assert would poison the context, so only live coordinates are
scattered (JAX padded them with dropped out-of-bounds entries).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from vectorsearch_tpu import constants
from vectorsearch_tpu.quant.layout import PackedVectors

from ..device import resolve, to_device, to_host
from ..kernels import cosine


def round_capacity(n: int) -> int:
    cap = constants.BUCKET_ROUND
    while cap < n:
        cap *= 2
    return cap


def _zeros(cap: int, dim: int, device) -> PackedVectors:
    return PackedVectors(
        codes=torch.zeros((cap, dim), dtype=torch.int8, device=device),
        scale=torch.zeros((cap,), dtype=torch.float32, device=device),
        offset=torch.zeros((cap,), dtype=torch.float32, device=device),
        inv_norm=torch.zeros((cap,), dtype=torch.float32, device=device),
    )


@dataclass(frozen=True)
class FlatIndex:
    """Append-able exhaustive index.

    Attributes:
      packed: device PackedVectors of shape [capacity, D].
      mask: device bool[capacity]; False = tombstoned (deleted) slot.
      mask_host: host mirror of mask: mutations never read the device.
      ids: host int64[capacity] external id per slot (0 beyond n).
      n: number of occupied slots (appends are contiguous).
      live: number of non-tombstoned rows.
    """

    packed: PackedVectors
    mask: torch.Tensor
    mask_host: np.ndarray
    ids: np.ndarray
    n: int
    live: int

    @property
    def dim(self) -> int:
        return self.packed.codes.shape[-1]

    @property
    def capacity(self) -> int:
        return self.packed.codes.shape[0]

    @property
    def device(self) -> torch.device:
        return self.packed.codes.device

    @property
    def hbm_bytes(self) -> int:
        """Device footprint: codes + f32 scale/offset/inv_norm + bool mask."""
        return self.capacity * (self.dim + 13)

    # ---- construction ----

    @staticmethod
    def create(dim: int, capacity: int | None = None, device=None) -> "FlatIndex":
        # default resolved at call time so a monkeypatched BUCKET_ROUND
        # (tests) keeps hbm_bytes consistent with IVFIndex.build's reserve
        cap = round_capacity(
            constants.BUCKET_ROUND if capacity is None else capacity
        )
        device = resolve(device)
        return FlatIndex(
            packed=_zeros(cap, dim, device),
            mask=torch.zeros((cap,), dtype=torch.bool, device=device),
            mask_host=np.zeros((cap,), np.bool_),
            ids=np.zeros((cap,), np.int64),
            n=0,
            live=0,
        )

    @staticmethod
    def from_packed(
        host_packed: PackedVectors, ids: np.ndarray, device=None
    ) -> "FlatIndex":
        """Bulk-load from host-side packed arrays (boot path)."""
        n, dim = host_packed.codes.shape
        idx = FlatIndex.create(dim, capacity=max(n, 1), device=device)
        if n == 0:
            return idx
        return idx.append(host_packed, ids)

    # ---- mutation (returns new index) ----

    def append(self, new: PackedVectors, ids: np.ndarray) -> "FlatIndex":
        """Append rows (host arrays or tensors) contiguously into fresh
        device buffers (grown to the next capacity class when full)."""
        m = int(np.shape(new.codes)[0])
        if m == 0:
            return self
        ids = np.asarray(ids, np.int64)
        if ids.shape != (m,):
            raise ValueError(f"append: {m} rows but ids of shape {ids.shape}")
        dev = self.device
        cap = self.capacity
        if self.n + m > cap:
            cap = round_capacity(self.n + m)
        packed = _zeros(cap, self.dim, dev)
        mask = torch.zeros((cap,), dtype=torch.bool, device=dev)
        lo, hi = self.n, self.n + m
        dtypes = (torch.int8, torch.float32, torch.float32, torch.float32)
        for dst, src, upd, dt in zip(packed, self.packed, new, dtypes):
            dst[:lo] = src[:lo]
            dst[lo:hi] = to_device(upd, dev, dt)
        mask[:lo] = self.mask[:lo]
        mask[lo:hi] = True
        new_ids = np.zeros((cap,), np.int64)
        new_ids[:lo] = self.ids[:lo]
        new_ids[lo:hi] = ids
        mask_host = np.zeros((cap,), np.bool_)
        mask_host[:lo] = self.mask_host[:lo]
        mask_host[lo:hi] = True
        return FlatIndex(
            packed=packed, mask=mask, mask_host=mask_host, ids=new_ids,
            n=hi, live=self.live + m,
        )

    def remove_ids(self, remove: np.ndarray) -> "FlatIndex":
        """Tombstone rows whose external id is in `remove`. The hit set
        comes from the host mask mirror; only the hit slots are written,
        into a copy of the device mask."""
        remove = np.asarray(remove, np.int64)
        if remove.size == 0 or self.n == 0:
            return self
        hit = np.isin(self.ids[: self.n], remove) & self.mask_host[: self.n]
        if not hit.any():
            return self
        mask_host = self.mask_host.copy()
        mask_host[: self.n] &= ~hit
        slots = torch.from_numpy(np.flatnonzero(hit)).to(self.device)
        mask = self.mask.clone()
        mask[slots] = False
        return replace(
            self, mask=mask, mask_host=mask_host,
            live=self.live - int(hit.sum()),
        )

    def compact(self) -> "FlatIndex":
        """Drop tombstoned rows (host-side repack; background operation)."""
        keep = np.nonzero(self.mask_host[: self.n])[0]
        keep_t = torch.from_numpy(keep).to(self.device)
        host = PackedVectors(*[to_host(a[keep_t]) for a in self.packed])
        return FlatIndex.from_packed(host, self.ids[keep], device=self.device)

    # ---- queries ----

    def search(
        self,
        queries,
        k: int,
        chunk: int = 65_536,
        refine: int = 0,
    ):
        """Top-k cosine search. Returns (scores f32[B,k], ids int64[B,k])
        as numpy; empty slots carry score -inf and id -1. refine=m>0
        re-ranks the coarse top-m with the exact f32 query."""
        q = torch.atleast_2d(to_device(queries, self.device, torch.float32))
        coarse_k = max(k, refine) if refine else k
        scores, slots = cosine.scan_topk_streamed(
            q, self.packed, self.n, k=coarse_k, chunk=chunk,
            valid_mask=self.mask,
        )
        if refine:
            scores, slots = cosine.rescore_topk(q, self.packed, scores, slots, k)
        scores, slots = to_host(scores), to_host(slots)
        # slots of -inf entries may point at dead rows; clip before the id
        # lookup, then null them out
        safe = np.clip(slots, 0, len(self.ids) - 1)
        out_ids = np.where(np.isneginf(scores), -1, self.ids[safe])
        return scores, out_ids
