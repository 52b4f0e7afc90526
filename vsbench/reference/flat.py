"""Plain exact search: the answers a flat index owes its callers.

A flat index searched at k owes each query the k rows of highest cosine
similarity among all its rows, with those similarities. That is an IVF
index of one cluster, holding every row, that every query probes: this
module hands its rows to `ivf.search` so, and so computes every row
against every query in float64 over slabs of rows, with a running top k.
No candidate list, no quantized scan, no kernel.

`precision="tf32"` is the control, as in `ivf.search`: every product's
inputs rounded to TF32 and accumulated in float32.

Imports nothing of the program under test.
"""
from __future__ import annotations

import numpy as np

from . import ivf


def search(queries: np.ndarray, slabs, n_rows: int, k: int, dev, precision: str = "f64"):
    """(similarities f64 [Q, k] in descending order, row numbers int64
    [Q, k]) of each query's top k among all n_rows rows; slabs as
    `ivf.search` takes them (every row once)."""
    dim = np.shape(queries)[-1]
    one_cluster = np.ones((1, dim), np.float64)
    every_row = np.zeros(n_rows, np.int64)
    return ivf.search(queries, one_cluster, every_row, slabs, 1, k, dev, precision)
