"""The slice as a whole: the JAX Engine and the port's Engine, each with a
deterministic NoopAI and an in-memory Store, serve the same uploads,
searches and deletes.

Search pages must match as (document_id, similarity) lists, similarity
within 1e-5 (both engines re-rank with exact f32 scores).
"""
import numpy as np
import pytest
import torch

from vectorsearch_tpu import constants
from vectorsearch_tpu.embed.noop import NoopAI
from vectorsearch_tpu.engine import Engine as JaxEngine
from vectorsearch_tpu.quant import layout
from vectorsearch_tpu.store import Store
from vectorsearch_tpu_torch.engine import Engine

ATOL = 1e-5


@pytest.fixture(autouse=True)
def small_buckets(monkeypatch):
    # both packages read BUCKET_ROUND at call time; 64 makes the
    # bootstrap index spill after 64 rows
    monkeypatch.setattr(constants, "BUCKET_ROUND", 64)
    torch.set_num_threads(2)


@pytest.fixture
def engines():
    made = []

    def make(store, seed, port):
        eng = (
            Engine(store, NoopAI(seed=seed), device="cpu")
            if port else JaxEngine(store, NoopAI(seed=seed))
        )
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.close()


def docs(n, start=0):
    return [{"name": f"doc{i}", "document": {"text": f"body {i}"}} for i in range(start, start + n)]


def page(hits):
    return [(h.document_id, h.similarity) for h in hits]


def assert_pages_match(a, b):
    assert [d for d, _ in a] == [d for d, _ in b]
    np.testing.assert_allclose([s for _, s in a], [s for _, s in b], atol=ATOL)


def test_same_uploads_searches_and_deletes(engines):
    """Two stores, the same uploads: the bootstrap index (one centroid,
    bucket + spill tail) answers alike at centroids 1 and -1, and a
    delete removes the document from both."""
    jx, pt = engines(Store(":memory:"), 0, False), engines(Store(":memory:"), 0, True)
    for batch in (docs(50), docs(60, 50), docs(30, 110)):
        assert jx.upload("o", "c", batch) == pt.upload("o", "c", batch)
    assert pt._state_for(1).ivf.spill.live > 0
    for centroids in (1, -1, 1):
        assert_pages_match(
            page(pt.search("o", "c", "query", count=10, centroids=centroids)),
            page(jx.search("o", "c", "query", count=10, centroids=centroids)),
        )
    victim = page(pt.search("o", "c", "again", count=1, centroids=-1))
    jx.search("o", "c", "again", count=1, centroids=-1)  # keep the AIs in step
    doc_id = victim[0][0]
    jx.delete_document("o", "c", doc_id)
    pt.delete_document("o", "c", doc_id)
    a = page(pt.search("o", "c", "again", count=20, centroids=-1))
    b = page(jx.search("o", "c", "again", count=20, centroids=-1))
    assert doc_id not in [d for d, _ in a]
    assert_pages_match(a, b)


def test_rebuilt_index_serves_alike(engines):
    """After a JAX k-means rebuild, a JAX engine and a port engine booted
    from the same store hold the same clustering; their IVF searches
    (grouped scan at centroids 1 and 2, exhaustive at -1) and batched
    searches agree, and the port's went through the grouped scan."""
    store = Store(":memory:")
    builder = engines(store, 0, False)
    builder.upload("o", "c", docs(240))
    assert builder.refresh_centroids(target_cluster_size=40) == {1: True}
    jx, pt = engines(store, 1, False), engines(store, 1, True)
    assert pt._state_for(1).ivf.k_clusters == jx._state_for(1).ivf.k_clusters > 1
    for centroids in (1, 2, -1):
        assert_pages_match(
            page(pt.search("o", "c", "q", count=10, centroids=centroids)),
            page(jx.search("o", "c", "q", count=10, centroids=centroids)),
        )
    texts = [f"t{i}" for i in range(9)]
    for a, b in zip(
        pt.search_many("o", "c", texts, count=5, centroids=2),
        jx.search_many("o", "c", texts, count=5, centroids=2),
    ):
        assert_pages_match(page(a), page(b))


def test_port_rebuild_and_stats(engines):
    """The port's own rebuild (its k-means and bucket build) swaps in a
    multi-cluster index in which a stored vector finds itself first, and
    stats() and warmup() see it."""
    pt = engines(Store(":memory:"), 0, True)
    pt.upload("o", "c", docs(200))
    assert pt.refresh_centroids(target_cluster_size=50) == {1: True}
    ivf = pt._state_for(1).ivf
    n_emb = ivf.n_live  # the noop embedder splits each document in sections
    assert ivf.k_clusters > 1 and n_emb >= 200 and ivf.spill.live == 0
    pt.warmup()
    stats = pt.stats()["categories"][1]
    assert stats["live_vectors"] == n_emb and stats["clusters"] == ivf.k_clusters
    packed, ids = ivf.export_live()
    vec = layout.unpack(layout.take(packed, np.array([7])))
    s, i = ivf.search(vec, k=1, nprobe=1, refine=8)
    assert i[0, 0] == ids[7] and s[0, 0] > 0.999
