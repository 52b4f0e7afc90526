"""Sharded serving: the corpus split over a mesh, a top-k per shard, one
merge (counterpart of vectorsearch_tpu/parallel/sharded.py).

Rows (flat) or clusters (IVF) are split over the mesh's shards; each
shard scans its own part on its own device and the [B, k] candidate sets
are gathered and merged: candidates move, never the score matrix. Inside
one process the shards' results are copied to the mesh's first device and
merged there in shard order; across processes they are all_gathered.

Sharded indexes are read-only serving structures: built from a host
snapshot by the single writer (the engine's rebuild) and swapped in
whole. Writes go to the single-device index and drop the replica until
the next rebuild.

On CUDA tensors each shard's bucket scan is the grouped-scan kernel, on
the CPU its plain version. No setting routes around the kernel: the JAX
package's VSTPU_SHARDED_PALLAS_INTERPRET and VSTPU_NO_PALLAS have no
counterpart.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import check_exact_f32, to_device, to_host
from ..index.ivf import _flat_view, assign_clusters, bucket_capacity
from ..kernels import cosine, grouped_scan
from ..quant.layout import PackedVectors
from .distributed import gather_shards, put_sharded, put_sharded_rows
from .mesh import Mesh


def _pad_rows(packed: PackedVectors, total: int) -> PackedVectors:
    pad = total - packed.codes.shape[0]
    return PackedVectors(
        np.pad(packed.codes, ((0, pad), (0, 0))),
        *[np.pad(a, (0, pad)) for a in packed[1:]],
    )


def _queries(queries) -> np.ndarray:
    return np.atleast_2d(np.asarray(to_host(queries), np.float32))


def _merge(mesh: Mesh, s_parts, i_parts, k: int):
    """Gather the shards' [B, k] candidates (scores, global slots) and
    take the global top-k, identical on every rank."""
    s_all = gather_shards(mesh, s_parts)  # [size, B, k]
    i_all = gather_shards(mesh, i_parts)
    b = s_all.shape[1]
    s_flat = s_all.transpose(0, 1).reshape(b, -1)
    i_flat = i_all.transpose(0, 1).reshape(b, -1)
    best, pos = torch.topk(s_flat, k, dim=-1)
    return to_host(best), to_host(torch.gather(i_flat, 1, pos))


def _map_ids(ids: np.ndarray, gi: np.ndarray) -> np.ndarray:
    flat = ids.reshape(-1)
    return np.where(gi < 0, -1, flat[np.clip(gi, 0, flat.size - 1)])


@dataclass(frozen=True, eq=False)
class ShardedFlat:
    """Row-sharded exhaustive index."""

    mesh: Mesh
    shards: tuple  # PackedVectors [rows_per_shard, D] of each local shard
    n_local: tuple  # live (unpadded) rows of each local shard
    ids: np.ndarray  # host int64 [rows_per_shard * mesh.size]
    rows_per_shard: int
    n: int

    @staticmethod
    def build(mesh: Mesh, host_packed: PackedVectors, ids: np.ndarray) -> "ShardedFlat":
        host_packed = PackedVectors(*[to_host(a) for a in host_packed])
        n = host_packed.codes.shape[0]
        rows = max(8, -(-max(n, 1) // mesh.size))
        total = rows * mesh.size
        return ShardedFlat(
            mesh=mesh,
            shards=tuple(put_sharded_rows(_pad_rows(host_packed, total), mesh)),
            n_local=tuple(int(np.clip(n - rows * s, 0, rows)) for s in mesh.shard_ids),
            ids=np.pad(np.asarray(ids, np.int64), (0, total - n)),
            rows_per_shard=rows,
            n=n,
        )

    def search(self, queries, k: int, chunk: int = 65_536):
        """Exact top-k per shard (cosine.scan_topk_streamed, the padding
        masked by n_local), merged. Returns numpy (scores, ids); empty
        slots score -inf with id -1."""
        q = _queries(queries)
        s_parts, i_parts = [], []
        for dev, rows, n_live, s in zip(
            self.mesh.devices, self.shards, self.n_local, self.mesh.shard_ids
        ):
            sc, idx = cosine.scan_topk_streamed(
                to_device(q, dev), rows, n_live, k=k, chunk=chunk
            )
            s_parts.append(sc)
            i_parts.append(
                torch.where(torch.isneginf(sc), -1, idx.long() + s * self.rows_per_shard)
            )
        best, gi = _merge(self.mesh, s_parts, i_parts, k)
        return best, _map_ids(self.ids, gi)


@dataclass(frozen=True, eq=False)
class ShardedIVF:
    """Cluster-sharded IVF index.

    Global shard s owns clusters [s * k_per, (s + 1) * k_per) (centroids
    and buckets). Probing is exact-global: every shard's centroid
    similarities are gathered and the true global top-nprobe is taken,
    then each shard scans only the probed clusters it owns. The merged
    result equals the single-device index's."""

    mesh: Mesh
    centroids_n: tuple  # f32 [k_per, D] of each local shard
    buckets: tuple  # PackedVectors [k_per, cap, D] / [k_per, cap]
    bucket_mask: tuple  # bool [k_per, cap]
    counts: tuple  # i32 [k_per]
    folded: tuple  # grouped_scan.fold_sidecars of each local shard's store
    ids: np.ndarray  # host int64 [k_pad, cap]
    clusters_per_shard: int
    k_clusters: int

    @property
    def cap(self) -> int:
        return self.buckets[0].codes.shape[1]

    @staticmethod
    def build(
        mesh: Mesh,
        host_packed: PackedVectors,
        ids: np.ndarray,
        centroids: np.ndarray,
        assignments: np.ndarray | None = None,
    ) -> "ShardedIVF":
        """Pack a host corpus into cluster buckets split over the mesh.
        The pad clusters past K keep zero centroids and count 0."""
        host_packed = PackedVectors(*[to_host(a) for a in host_packed])
        centroids = to_host(centroids).astype(np.float32)
        kk, d = centroids.shape
        k_per = -(-kk // mesh.size)
        k_pad = k_per * mesh.size
        ids = np.asarray(ids, np.int64)
        if assignments is None:
            assignments = assign_clusters(host_packed, centroids, device=mesh.devices[0])
        assignments = np.asarray(assignments, np.int32)
        counts = np.bincount(assignments, minlength=k_pad).astype(np.int32)
        # headroom=1.0: a read-only replica takes no streaming inserts (they
        # land in the single-device index; the next rebuild re-shards)
        cap = bucket_capacity(int(counts.max()) if len(ids) else 1, headroom=1.0)

        order = np.argsort(assignments, kind="stable")
        sorted_cid = assignments[order]
        starts = np.zeros(k_pad + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        slot = np.arange(len(order), dtype=np.int64) - starts[sorted_cid]

        def scatter(src):
            out = np.zeros((k_pad, cap) + src.shape[1:], dtype=src.dtype)
            out[sorted_cid, slot] = src[order]
            return out

        buckets = tuple(put_sharded_rows(
            PackedVectors(*[scatter(a) for a in host_packed]), mesh
        ))
        mask = np.zeros((k_pad, cap), np.bool_)
        mask[sorted_cid, slot] = True
        id_grid = np.zeros((k_pad, cap), np.int64)
        id_grid[sorted_cid, slot] = ids[order]
        cents = np.zeros((k_pad, d), np.float32)
        cents[:kk] = centroids
        masks = put_sharded(mask, mesh)
        counts_dev = put_sharded(counts, mesh)
        return ShardedIVF(
            mesh=mesh,
            centroids_n=tuple(cosine.l2_normalize(c) for c in put_sharded(cents, mesh)),
            buckets=buckets,
            bucket_mask=tuple(masks),
            counts=tuple(counts_dev),
            folded=tuple(
                grouped_scan.fold_sidecars(b, c, m)
                for b, c, m in zip(buckets, counts_dev, masks)
            ),
            ids=id_grid,
            clusters_per_shard=k_per,
            k_clusters=kk,
        )

    def probes(self, qn: list, nprobe: int) -> list:
        """Each local shard's probe list for the L2-normalized queries `qn`
        (one [B, D] tensor a local shard, on its device), 1 <= nprobe <= K:
        (local cluster ids i32 [B, m], valid bool [B, m]) over m =
        min(nprobe, k_per) slots. A slot whose cluster another shard owns is
        not valid: the scan reads no codes for it and scores it -inf."""
        mesh, k_per = self.mesh, self.clusters_per_shard
        b = qn[0].shape[0]
        # exact GLOBAL top-nprobe (reference semantics, server/search.go:
        # 214-227): gather every shard's bf16 centroid similarities (K
        # columns, small) and take the true top-nprobe, not each shard's
        # local best (under cluster skew that union misses clusters)
        check_exact_f32(qn[0])
        sims = gather_shards(mesh, [
            x.bfloat16().float() @ c.bfloat16().float().T
            for x, c in zip(qn, self.centroids_n)
        ])  # [size, B, k_per]
        sims = sims.transpose(0, 1).reshape(b, mesh.size * k_per)
        sims[:, self.k_clusters :] = cosine.NEG_INF
        top_s, gprobed = torch.topk(sims, nprobe, dim=-1)  # global cluster ids

        # each shard takes the probed clusters IT owns over min(nprobe,
        # k_per) slots
        m_local = min(nprobe, k_per)
        out = []
        for dev, s in zip(mesh.devices, mesh.shard_ids):
            gp, ts = gprobed.to(dev), top_s.to(dev)
            own = torch.div(gp, k_per, rounding_mode="floor") == s
            pick = torch.topk(torch.where(own, ts, cosine.NEG_INF), m_local, dim=-1).indices
            local = (torch.gather(gp, 1, pick) - s * k_per).clamp(0, k_per - 1)
            out.append((local.to(torch.int32), torch.gather(own, 1, pick)))
        return out

    def search(self, queries, k: int, nprobe: int = 1, refine: int = 0):
        """Top-k over the global top-nprobe clusters; refine=m > 0 re-ranks
        each shard's coarse top-m with the exact f32 query on its own
        store. Returns numpy (scores, ids); nprobe < 0 probes everything."""
        mesh, k_per, cap = self.mesh, self.clusters_per_shard, self.cap
        if nprobe < 0:
            nprobe = self.k_clusters
        nprobe = max(1, min(nprobe, self.k_clusters))
        k_coarse = max(k, refine) if refine else k
        q = _queries(queries)
        on = {dev: to_device(q, dev) for dev in set(mesh.devices)}
        qs = [on[dev] for dev in mesh.devices]
        qn = [cosine.l2_normalize(x) for x in qs]
        s_parts, g_parts = [], []
        for j, (s, (local, valid)) in enumerate(zip(mesh.shard_ids, self.probes(qn, nprobe))):
            sc, gslot = grouped_scan.grouped_scan(
                qn[j], qn[j].sum(dim=-1), self.buckets[j], self.counts[j],
                self.bucket_mask[j], local, k_coarse,
                folded=self.folded[j], probe_valid=valid,
            )
            if refine:
                # exact f32 re-rank against the shard's own store (gslot is
                # a local slot here, before the shard's offset)
                sc, gslot = cosine.rescore_topk(
                    qs[j], _flat_view(self.buckets[j]), sc, gslot, k
                )
            s_parts.append(sc)
            g_parts.append(torch.where(torch.isneginf(sc), -1, gslot + s * (k_per * cap)))
        best, gi = _merge(mesh, s_parts, g_parts, k)
        return best, _map_ids(self.ids, gi)
