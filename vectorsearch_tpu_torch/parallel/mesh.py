"""The shards a process drives (counterpart of vectorsearch_tpu/parallel/mesh.py).

JAX names a 1-D 'data' mesh of devices and lets shard_map place one shard
on each. Here a Mesh is the ordered list of torch devices whose shards
this process drives, and, in a run of several processes, the process group
that joins them. Global shard s = rank * n_local + j is the j-th device of
rank `rank`: the order of JAX's global device list. Every rank drives the
same number of shards.

A device may be named more than once: the CPU tests run 8 shards on the
CPU, as JAX's tests run 8 virtual CPU devices, and one card can hold
several shards. Each shard is its own set of tensors and its own kernel
launches either way.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve


@dataclass(frozen=True, eq=False)
class Mesh:
    """devices: this process's shards, in order; group: the
    torch.distributed process group across ranks (None: one process, no
    collectives); rank and world: this process's place in it."""

    devices: tuple
    group: object = None
    rank: int = 0
    world: int = 1

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """Shards across every rank."""
        return self.n_local * self.world

    @property
    def shard_ids(self) -> range:
        """The global shard index of each local device."""
        return range(self.rank * self.n_local, (self.rank + 1) * self.n_local)


def local_devices(n_devices: int | None = None) -> list[torch.device]:
    """The devices of this process's shards: the first n (all for None)
    CUDA cards, counted from the card VSTPU_DEVICE names (`cuda:N`, so
    that processes sharing a host can take distinct cards), or n CPU
    shards (1 for None) when the CPU is asked for by name. Raises
    device.NoDeviceError with neither a card nor an ask."""
    dev = resolve(None)
    if dev.type != "cuda":
        return [dev] * (n_devices or 1)
    first = dev.index or 0
    count = torch.cuda.device_count() - first
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"{n_devices} cards asked for, {count} from cuda:{first} on")
    return [torch.device("cuda", first + i) for i in range(n)]


def default_mesh(n_devices: int | None = None) -> Mesh:
    """A mesh over the first n (default: all) local devices, with no
    process group (jax.devices()[:n] on one host)."""
    return Mesh(tuple(local_devices(n_devices)))


def local_blocks(mesh: Mesh, n_rows: int) -> list[slice]:
    """The rows (or clusters) of a host-global array of n_rows that each
    local shard owns, in the order of mesh.devices: global shard s owns
    rows [s * per, (s + 1) * per) with per = ceil(n_rows / mesh.size),
    clipped to n_rows, so the last shards may hold fewer rows or none.
    The counterpart of row_sharding: the split put_sharded places."""
    per = -(-n_rows // mesh.size)
    return [slice(min(s * per, n_rows), min((s + 1) * per, n_rows)) for s in mesh.shard_ids]
