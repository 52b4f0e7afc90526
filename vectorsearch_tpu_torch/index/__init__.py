from .flat import FlatIndex, round_capacity
from .ivf import IVFIndex, assign_clusters, bucket_capacity

__all__ = [
    "FlatIndex",
    "IVFIndex",
    "assign_clusters",
    "bucket_capacity",
    "round_capacity",
]
