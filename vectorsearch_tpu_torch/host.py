"""The JAX package's jax-free host modules that the port shares.

Re-exported so that a caller of the port imports only the port: the
corpus codec and packed layout, the SQLite store and its snapshots, the
embedder interface and the deterministic noop embedder, and the config
file's schema. None of them imports jax (tests/test_torch_imports.py
checks it).
"""
from vectorsearch_tpu import config, constants
from vectorsearch_tpu.embed.base import AIProvider
from vectorsearch_tpu.embed.noop import NoopAI
from vectorsearch_tpu.quant import codec, layout
from vectorsearch_tpu.quant.layout import PackedVectors
from vectorsearch_tpu.store import Store, snapshots

__all__ = [
    "AIProvider", "NoopAI", "PackedVectors", "Store", "codec", "config",
    "constants", "layout", "snapshots",
]
