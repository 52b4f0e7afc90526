from . import snapshots
from .db import CategoryRow, CentroidRow, DocumentRow, OwnerRow, Store
from .remote import RemoteStore, StoreServer

__all__ = [
    "snapshots",
    "Store",
    "RemoteStore",
    "StoreServer",
    "OwnerRow",
    "CategoryRow",
    "CentroidRow",
    "DocumentRow",
]
