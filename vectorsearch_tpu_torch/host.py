"""The port's host modules in one place: the corpus codec and packed
layout, the SQLite store and its snapshots, the embedder interface and
the deterministic noop embedder, and the config file's schema.

Each is the port's own copy of the JAX package's module of the same
relative path (quant/, store/, embed/, config.py, constants.py), with the
same wire codec, int8 layout, SQLite schema and snapshot format, so that
a store or snapshot written by either package loads in the other. The
port imports nothing of the JAX package (tests/test_torch_imports.py
checks it).
"""
from . import config, constants
from .embed.base import AIProvider
from .embed.noop import NoopAI
from .quant import codec, layout
from .quant.layout import PackedVectors
from .store import Store, snapshots

__all__ = [
    "AIProvider", "NoopAI", "PackedVectors", "Store", "codec", "config",
    "constants", "layout", "snapshots",
]
