from .mesh import Mesh, default_mesh, local_blocks, local_devices
from .sharded import ShardedFlat, ShardedIVF

__all__ = [
    "Mesh",
    "ShardedFlat",
    "ShardedIVF",
    "default_mesh",
    "local_blocks",
    "local_devices",
]
