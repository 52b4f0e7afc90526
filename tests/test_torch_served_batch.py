"""The port's batched search over HTTP (`POST /api/search` with `texts`):
the served engine of the benchmark's 1M×768 deployment cut to a tiny size
on the CPU (vsbench's seeded corpus, store and embedding provider), held
against the benchmark's plain reference; the cell `d1m-http-batch256`
through the harness; and the spans and counter a batched request records."""
import contextlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vectorsearch_tpu_torch import constants
from vectorsearch_tpu_torch.engine import Engine, EngineCache
from vectorsearch_tpu_torch.store import Store
from vectorsearch_tpu_torch.tools.http_driver import Client, serving_app
from vectorsearch_tpu_torch.utils import profiling
from vsbench import corpus
from vsbench.drivers import http as http_driver
from vsbench.reference import codec
from vsbench.reference import ivf as ref_ivf
from vsbench.tests import tiny

OWNER, CATEGORY = http_driver.OWNER, http_driver.CATEGORY
SIM_TOL = 2e-05  # the cell's sim_err limit (vsbench/traffic/http-batch256-c2.json)
REQUEST_SPANS = ("http.parse", "http.encode", "engine.pages", "engine.hits")


@pytest.fixture(autouse=True)
def clean_tables():
    profiling.reset()
    yield
    profiling.reset()


class Deployment:
    """The configuration `vdbb-768d1m-engine` at `rows` × `dim` on the CPU:
    its seeded rows in an in-memory store (document `r<row>`), the engine
    booted from it with the benchmark's provider, a query pool."""

    def __init__(self, rows=4000, dim=64, clusters=16, seed=2**31 + 5, pool=512):
        cfg = json.loads((tiny.ROOT / "vsbench/configs/vdbb-768d1m-engine.json").read_text())
        cfg.update(rows=rows, dim=dim, clusters=clusters)
        recipe = corpus.Recipe.of(cfg)
        gen = corpus.Corpus(recipe, seed, torch.device("cpu"))
        self.wire, self.members = corpus.wire_rows(gen)
        centroids = gen.centroids()
        self.centroids = codec.dequantize(codec.quantize(centroids))  # as stored
        self.pool = corpus.query_pool(recipe, seed, pool, lambda idx: codec.dequantize(self.wire[idx]))
        self.store = Store(":memory:")
        http_driver.populate(self.store, self.wire, centroids, self.members)
        self.engine = Engine(self.store, http_driver.make_provider(self.pool, gen),
                             cache=EngineCache(ttl=60.0), device="cpu")

    def close(self):
        self.engine.close()
        self.store.close()

    def truth(self, idx, count, nprobe):
        """The reference's (similarities, rows) for pool queries idx, as
        the engine receives them (the provider's wire rows)."""
        q = codec.dequantize(codec.quantize(self.pool[np.asarray(idx)]))
        return ref_ivf.search(q, self.centroids, self.members, [(0, codec.dequantize(self.wire))],
                              nprobe, count, torch.device("cpu"))


@contextlib.contextmanager
def served(**kw):
    """(Deployment, a keep-alive client of its router on a free port)."""
    dep = Deployment(**kw)
    try:
        with serving_app(dep.engine) as port:
            yield dep, Client(port)
    finally:
        dep.close()


def search_body(idx, count=10, nprobe=8):
    return {"owner": OWNER, "category": CATEGORY, "texts": [f"q{i}" for i in idx],
            "count": count, "centroids": nprobe}


@pytest.mark.parametrize("count, nprobe", [(10, 8), (3, 2)])
def test_batched_pages_against_the_reference(count, nprobe):
    idx = np.random.default_rng(1).integers(0, 512, 200)
    with served() as (dep, client):
        out = client.post("/api/search", search_body(idx, count, nprobe))
    pages = out["results"]
    assert len(pages) == len(idx)
    ref_sims, ref_rows = dep.truth(idx, count, nprobe)
    for page, want_sims, want_rows in zip(pages, ref_sims, ref_rows):
        docs = page["documents"]
        assert len(docs) == count
        rows = np.array([d["document_id"] - 1 for d in docs])
        assert [d["name"] for d in docs] == [f"r{r}" for r in rows]
        sims = np.array([d["document_similarity"] for d in docs])
        np.testing.assert_allclose(sims, want_sims, rtol=0, atol=SIM_TOL)
        # the rows are the reference's top count but where two lie within rounding
        same = rows == want_rows
        assert np.all(same | (np.abs(want_sims - sims) <= SIM_TOL))


def test_more_texts_than_the_cap_are_refused():
    with served(rows=1000, clusters=4) as (_, client):
        cap = constants.MAX_QUERY_BATCH
        status, _, out = client.call("POST", "/api/search", search_body(range(cap + 1)))
        assert status == 400 and out == {"error": "Invalid request"}
        assert len(client.post("/api/search", search_body(range(cap)))["results"]) == cap


@pytest.mark.parametrize("trace", [False, True])
def test_cell_through_the_harness(trace):
    c = tiny.cell("d1m-http-batch256", seed=2**31 + 29, seconds=1, trace=trace,
                  texts=32, query_pool=128, sample=48)
    assert c.traffic["search_clients"] == 2 and c.traffic["upload_clients"] == 0
    result, check, ctrl = tiny.run(c, with_control=not trace)
    assert result["correct"], check
    assert result["attempted"] > 0 and result["failed"] == 0
    if trace:
        for name in ("served.json_ms", "served.pages_ms"):
            assert result["metrics"][name]["value"] > 0
    else:
        assert result["metrics"]["search_qps"]["value"] > 0
        assert set(result["metrics"]) == {"search_qps", "setup_s"}
        assert not all(v["value"] <= v["limit"] for v in ctrl.values()), ctrl


def test_a_batched_request_records_its_spans_once():
    with served() as (_, client):
        with profile(activities=[ProfilerActivity.CPU]):
            for s in range(3):
                client.post("/api/search", search_body(range(s * 64, s * 64 + 64)))
    snap = profiling.snapshot()
    assert snap["spans"]["http.request"]["count"] == 3
    for name in REQUEST_SPANS:
        assert snap["spans"][name]["count"] == 3, name
    # one section a document: the dedup never comes up short
    assert snap["counters"]["engine.fallbacks"] == 0


class EightDocuments:
    """A doc map under which the corpus holds 8 documents, each of many
    sections: embedding e belongs to document e % 8 + 1."""

    def __init__(self, inner):
        self.inner = inner

    def get(self, emb_id):
        return self.inner.get(emb_id % 8 + 1)


def test_fallbacks_count_the_rows_sent_to_the_window_helper():
    dep = Deployment(rows=2000, clusters=4)
    try:
        (state,) = dep.engine._states.values()
        state.doc_map = EightDocuments(state.doc_map)
        with profile(activities=[ProfilerActivity.CPU]):
            pages = dep.engine.search_many(OWNER, CATEGORY, [f"q{i}" for i in range(5)],
                                           count=10, centroids=-1)
    finally:
        dep.close()
    # a row's first candidates dedup to 8 documents, fewer than the 10
    # asked for: every row goes on to the window helper, which finds no more
    assert profiling.snapshot()["counters"]["engine.fallbacks"] == 5
    assert [sorted(d.document_id for d in p) for p in pages] == [list(range(1, 9))] * 5
