"""Multi-process runtime (counterpart of vectorsearch_tpu/parallel/distributed.py).

The JAX package joins processes with `jax.distributed.initialize`, after
which `jax.devices()` is the global device list and shard_map programs
run psum/all_gather across hosts. Here every process calls
`maybe_initialize` before its first device use: it forms the default
torch.distributed process group over a TCP rendezvous (`nccl` on a card,
`gloo` on the CPU asked for by name). `global_mesh()` is then this
process's local shards plus that group, and the collectives below run
across ranks only where a mesh has a group.

Host-side placement goes through `put_sharded`: every process passes the
SAME host-global array and keeps the rows its own shards own. It never
takes process-local row blocks for the global array (the JAX package's
r2 bug, which doubled the global shape on a multi-host mesh).

Config wiring (config.py MeshConfig -> __main__.py): `mesh.coordinator`
("host0:1234"), `mesh.num_processes` and `mesh.process_id` on every
instance. With no coordinator all of this is a no-op.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve, to_device, upload_packed
from ..quant.layout import PackedVectors
from .mesh import Mesh, local_blocks, local_devices


def maybe_initialize(
    coordinator: str, num_processes: int = 1, process_id: int = 0
) -> bool:
    """Join (or form) the process group; a no-op without a coordinator.
    Idempotent per process. The backend follows the device resolve(None)
    gives: `nccl` on a card, `gloo` on the CPU (it raises with neither a
    card nor an ask). Returns whether the group exists."""
    if coordinator and not dist.is_initialized():
        backend = "nccl" if resolve(None).type == "cuda" else "gloo"
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id,
        )
    return dist.is_initialized()


def global_mesh(n_devices: int | None = None) -> Mesh:
    """This process's first n (default: all) local devices, joined to the
    other ranks by the default process group when maybe_initialize formed
    one (a mesh of one process otherwise). Every rank calls it, with the
    same n: it checks that each rank drives as many shards."""
    devs = tuple(local_devices(n_devices))
    if not dist.is_initialized():
        return Mesh(devs)
    mesh = Mesh(devs, dist.group.WORLD, dist.get_rank(), dist.get_world_size())
    n = torch.tensor([len(devs), -len(devs)], device=devs[0])
    dist.all_reduce(n, op=dist.ReduceOp.MAX, group=mesh.group)
    if n.tolist() != [len(devs), -len(devs)]:
        raise ValueError(f"ranks drive unequal shard counts: rank {mesh.rank} has {len(devs)}")
    return mesh


def put_sharded(array, mesh: Mesh, dtype=None) -> list[torch.Tensor]:
    """Place a HOST-GLOBAL array on the mesh: the rows (axis 0) that each
    local shard owns (mesh.local_blocks), on that shard's device. Every
    process passes the same whole array."""
    array = np.asarray(array)
    return [
        to_device(array[sl], dev, dtype)
        for sl, dev in zip(local_blocks(mesh, array.shape[0]), mesh.devices)
    ]


def put_sharded_rows(packed: PackedVectors, mesh: Mesh) -> list[PackedVectors]:
    """put_sharded of every field of host-global packed rows: one
    PackedVectors of tensors a local shard."""
    packed = PackedVectors(*[np.asarray(a) for a in packed])
    return [
        upload_packed(PackedVectors(*[a[sl] for a in packed]), dev)
        for sl, dev in zip(local_blocks(mesh, packed.codes.shape[0]), mesh.devices)
    ]


def gather_shards(mesh: Mesh, parts: list[torch.Tensor]) -> torch.Tensor:
    """[mesh.size, *shape] on mesh.devices[0]: the local shards' `parts`
    (one a shard, equal shapes) in global shard order, all_gathered
    across ranks where the mesh has a group."""
    local = torch.stack([p.to(mesh.devices[0]) for p in parts])
    if mesh.group is None:
        return local
    out = [torch.empty_like(local) for _ in range(mesh.world)]
    dist.all_gather(out, local, group=mesh.group)
    return torch.cat(out)


def sum_shards(mesh: Mesh, parts: list[torch.Tensor]) -> torch.Tensor:
    """The sum of the local shards' `parts`, added in shard order on
    mesh.devices[0], then all_reduced across ranks where the mesh has a
    group (the counterpart of psum)."""
    total = parts[0].to(mesh.devices[0], copy=True)
    for p in parts[1:]:
        total += p.to(mesh.devices[0])
    if mesh.group is not None:
        dist.all_reduce(total, group=mesh.group)
    return total
