"""Both packages side by side, for the parity tests that run one engine
scenario on the JAX package and on the port (tests/test_torch_concurrency.py,
test_torch_frozen_compact.py, test_torch_model_check.py, test_torch_pg.py,
test_torch_engine_paths.py).

A scenario is a function of a package namespace P that returns what it
observed (ids, row counts, pages); `both` runs it on PORT and on JAX and
compares the two. The port's engines run on the CPU (device="cpu"), and its
mesh is 8 CPU shards where JAX's is its 8-device virtual CPU mesh.
"""
from types import SimpleNamespace

import pytest

import vectorsearch_tpu.engine.engine as jax_engine_mod
import vectorsearch_tpu.index.ivf as jax_ivf_mod
import vectorsearch_tpu.store.db as jax_db
import vectorsearch_tpu.store.pgwire as jax_pgwire
import vectorsearch_tpu_torch.engine.engine as port_engine_mod
import vectorsearch_tpu_torch.index.ivf as port_ivf_mod
import vectorsearch_tpu_torch.store.db as port_db
import vectorsearch_tpu_torch.store.pgwire as port_pgwire
from vectorsearch_tpu import config as jax_config
from vectorsearch_tpu import constants as jax_constants
from vectorsearch_tpu.engine.batcher import QueryBatcher as JaxQueryBatcher
from vectorsearch_tpu.engine.cache import EngineCache as JaxEngineCache
from vectorsearch_tpu.engine.cache import TTLCache as JaxTTLCache
from vectorsearch_tpu.parallel import default_mesh as jax_default_mesh
from vectorsearch_tpu.store.pg import PgStore as JaxPgStore
from vectorsearch_tpu_torch import config as port_config
from vectorsearch_tpu_torch import constants as port_constants
from vectorsearch_tpu_torch.engine.batcher import QueryBatcher as PortQueryBatcher
from vectorsearch_tpu_torch.engine.cache import EngineCache as PortEngineCache
from vectorsearch_tpu_torch.engine.cache import TTLCache as PortTTLCache
from vectorsearch_tpu_torch.parallel import Mesh
from vectorsearch_tpu_torch.store.pg import PgStore as PortPgStore

ATOL = 1e-5  # similarities: both engines re-rank with exact f32 scores


def _package(name, engine_mod, ivf_mod, db, config, cache, ttl, batcher, pg, pgwire, mesh,
             **engine_kw):
    cls = engine_mod.Engine
    return SimpleNamespace(
        name=name, engine_mod=engine_mod, ivf_mod=ivf_mod, db=db, config=config,
        EngineClass=cls, IVFIndex=ivf_mod.IVFIndex, Store=db.Store, EngineCache=cache,
        TTLCache=ttl, QueryBatcher=batcher, PgStore=pg, pgwire=pgwire,
        UploadError=engine_mod.UploadError,
        RequestCanceled=engine_mod.RequestCanceled,
        Engine=lambda store, ai, **kw: cls(store, ai, **engine_kw, **kw),
        mesh8=mesh,
    )


JAX = _package(
    "jax", jax_engine_mod, jax_ivf_mod, jax_db, jax_config, JaxEngineCache, JaxTTLCache,
    JaxQueryBatcher, JaxPgStore, jax_pgwire, lambda: jax_default_mesh(8),
)
PORT = _package(
    "port", port_engine_mod, port_ivf_mod, port_db, port_config, PortEngineCache,
    PortTTLCache, PortQueryBatcher, PortPgStore, port_pgwire, lambda: Mesh(("cpu",) * 8),
    device="cpu",
)
PACKAGES = (PORT, JAX)


@pytest.fixture(autouse=True)
def small_buckets(monkeypatch):
    """BUCKET_ROUND 64 in both packages' constants (each reads its own)."""
    import torch

    monkeypatch.setattr(jax_constants, "BUCKET_ROUND", 64)
    monkeypatch.setattr(port_constants, "BUCKET_ROUND", 64)
    torch.set_num_threads(2)


def page(hits):
    """A search page as [(document_id, similarity, name)]."""
    return [(h.document_id, h.similarity, h.name) for h in hits]


def assert_same(a, b, where="observation"):
    """Two observations equal, floats (similarities) within ATOL."""
    if isinstance(a, float) and isinstance(b, float):
        assert abs(a - b) <= ATOL, (where, a, b)
    elif isinstance(a, (list, tuple)) and type(a) is type(b):
        assert len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def both(scenario, *args):
    """scenario(P, *args) on the port and on JAX: the two observations must
    agree (assert_same); returns the port's."""
    port, jax = (scenario(P, *args) for P in PACKAGES)
    assert_same(port, jax)
    return port
