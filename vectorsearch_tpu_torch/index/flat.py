"""Device-resident flat (exhaustive) index with append and tombstones.

Counterpart of vectorsearch_tpu/index/flat.py. The corpus lives on the
device as a capacity-padded PackedVectors of tensors. A search takes one
of two routes, chosen by its `refine`:

  * refine = 0: the chunked streamed scan (cosine.scan_topk_streamed),
    whose coarse int8 scores are the answer, as the JAX package's are;
  * refine = m > 0: the band route (kernels/flat.py band_candidates): the
    s8 band kernel over the first n rows, the top max(k, m) bands, their
    rows, and the exact-f32 re-rank (cosine.rescore_topk). A row of the
    coarse top m lies in a band whose maximum is at least its score, so
    the rescored rows hold the streamed scan's coarse top m, and the
    answer at each rank is the JAX package's or a better one.

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

from .. import constants
from ..device import PACKED_DTYPES, resolve, to_device, to_host
from ..kernels import cosine, flat
from ..quant.layout import PackedVectors
from ..utils.profiling import count, span, traced


def _host_waits():
    """The span `flat.sync` around a point of `FlatIndex.search` where the
    host waits on the card (the pageable upload of the queries, a read),
    and one more on the counter `flat.syncs`."""
    count("flat.syncs")
    return span("flat.sync")


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
        for dst, src, upd, dt in zip(packed, self.packed, new, PACKED_DTYPES):
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

    @traced("flat.search")
    def search(
        self,
        queries,
        k: int,
        chunk: int = 65_536,
        refine: int = 0,
    ):
        """Top-k cosine search. Returns (scores f32[B,k], ids int64[B,k])
        as numpy; empty slots carry score -inf and id -1. refine=m>0
        re-ranks the coarse top-m with the exact f32 query.

        Spans (utils/profiling.py): `flat.search` around the call, with
        `flat.scan` and `flat.refine` (in `topk`) and `flat.sync` around
        each of its three waits on the card: the queries' upload and the
        reads of the scores and of the slots. Counters `flat.calls` and
        `flat.syncs` (`topk` alone, as the IVF spill tail calls it, counts
        no call), and `flat.band_scans` in `topk` for each call that takes
        the band route."""
        count("flat.calls")
        with _host_waits():
            q = torch.atleast_2d(to_device(queries, self.device, torch.float32))
        scores, slots = self.topk(q, k, chunk=chunk, refine=refine)
        with _host_waits():
            scores = to_host(scores)
        with _host_waits():
            slots = to_host(slots)
        return scores, self.map_ids(scores, slots)

    def topk(self, queries, k: int, chunk: int = 65_536, refine: int = 0):
        """search's device part: (scores f32 [B, k], slots i32 [B, k]) as
        device tensors, nothing read back. refine=0 takes the streamed scan
        (its coarse scores are the answer); refine=m>0 takes the band route
        (kernels/flat.py), whose candidates hold the streamed scan's coarse
        top m, and counts one `flat.band_scans`."""
        q = torch.atleast_2d(to_device(queries, self.device, torch.float32))
        if not refine:
            with span("flat.scan"):
                return cosine.scan_topk_streamed(q, self.packed, self.n, k=k, chunk=chunk,
                                                 valid_mask=self.mask)
        count("flat.band_scans")
        with span("flat.scan"):
            cand, rows = flat.band_candidates(q, self.packed, self.n, max(k, refine), k,
                                              self.mask)
        with span("flat.refine"):
            return cosine.rescore_topk(q, self.packed, cand, rows, k, valid=self.mask)

    def map_ids(self, scores: np.ndarray, slots: np.ndarray) -> np.ndarray:
        """External ids of topk's slots, read back: -1 where the score is
        -inf. Slots of -inf entries may point at dead rows; they are
        clipped before the lookup, then nulled."""
        safe = np.clip(slots, 0, len(self.ids) - 1)
        return np.where(np.isneginf(scores), -1, self.ids[safe])
