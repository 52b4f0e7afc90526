"""Index state carried across from the JAX package.

This system has no weights; its state is the index: centroids, the packed
bucket store and its masks, ids and the spill tail. `arrays_from_index`
reads those fields off any object with the JAX index's attributes (a
JAX array converts through `np.asarray`, so this module needs no jax
import; a port tensor through `device.to_host`), and `ivf_from_arrays` /
`flat_from_arrays` build the port's indexes from them on a given device.
The tests use it to hold port searches against JAX searches on identical
buckets, with no k-means variance between the two.

The sharded indexes need no converter: `parallel.ShardedIVF.build` and
`ShardedFlat.build` take the same numpy host arrays as the JAX package's
(packed rows, ids, centroids and assignments), so state carries across
as those arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve, to_device, to_host, upload_packed
from .index.flat import FlatIndex
from .index.ivf import HostMirror, IVFIndex
from .kernels import cosine
from .quant.layout import PackedVectors

_FIELDS = ("codes", "scale", "offset", "inv_norm")


def _flat_arrays(flat) -> dict:
    out = {f"spill_{f}": to_host(getattr(flat.packed, f)) for f in _FIELDS}
    out["spill_mask"] = to_host(flat.mask)
    out["spill_ids"] = to_host(flat.ids)
    out["spill_n"] = int(flat.n)
    return out


def arrays_from_index(obj) -> dict:
    """Host arrays of an IVF index (JAX or port layout: the same field
    names). Keys: centroids, codes/scale/offset/inv_norm, bucket_mask,
    counts, ids, and spill_* for the flat tail."""
    out = {"centroids": to_host(obj.centroids).astype(np.float32)}
    out.update({f: to_host(getattr(obj.buckets, f)) for f in _FIELDS})
    out["bucket_mask"] = to_host(obj.bucket_mask).astype(np.bool_)
    out["counts"] = to_host(obj.counts).astype(np.int32)
    out["ids"] = to_host(obj.ids).astype(np.int64)
    out.update(_flat_arrays(obj.spill))
    return out


def flat_from_arrays(arrays: dict, device=None, prefix: str = "spill_") -> FlatIndex:
    """A port FlatIndex holding exactly the given rows, mask and ids."""
    device = resolve(device)
    mask = np.asarray(arrays[prefix + "mask"], np.bool_)
    n = int(arrays[prefix + "n"])
    return FlatIndex(
        packed=upload_packed(
            PackedVectors(*[np.asarray(arrays[prefix + f]) for f in _FIELDS]),
            device,
        ),
        mask=to_device(mask, device),
        mask_host=mask.copy(),
        ids=np.asarray(arrays[prefix + "ids"], np.int64).copy(),
        n=n,
        live=int(mask[:n].sum()),
    )


def ivf_from_arrays(arrays: dict, device=None) -> IVFIndex:
    """A port IVFIndex with exactly the given centroids and buckets."""
    device = resolve(device)
    mask = np.asarray(arrays["bucket_mask"], np.bool_)
    counts = np.asarray(arrays["counts"], np.int32)
    cents = to_device(arrays["centroids"], device, torch.float32)
    return IVFIndex(
        centroids=cents,
        centroids_n=cosine.l2_normalize(cents),
        buckets=upload_packed(
            PackedVectors(*[np.asarray(arrays[f]) for f in _FIELDS]), device
        ),
        bucket_mask=to_device(mask, device),
        mask_mirror=HostMirror(mask.copy()),
        counts=counts.copy(),
        counts_dev=to_device(counts, device),
        id_mirror=HostMirror(np.asarray(arrays["ids"], np.int64).copy()),
        ids_dev=to_device(np.asarray(arrays["ids"], np.int64), device),
        spill=flat_from_arrays(arrays, device),
        live_count=int(mask.sum()),
    )
