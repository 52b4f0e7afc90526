"""The port's spans and counters (vectorsearch_tpu_torch/utils/profiling.py)
at their sites, and the benchmark's readers of them (vsbench/spans.py,
vsbench/metrics): on the CPU, under torch.profiler's CPU activity."""
import asyncio
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vectorsearch_tpu_torch.build import build_centroids
from vectorsearch_tpu_torch.build.progress import BuildProgress
from vectorsearch_tpu_torch.index import IVFIndex
from vectorsearch_tpu_torch.quant import layout
from vectorsearch_tpu_torch.utils import profiling
from vsbench import harness, spans
from vsbench.trace import KERNEL, Event, Trace, from_profiler
from vsbench.tests import tiny


@pytest.fixture(autouse=True)
def clean_tables():
    profiling.reset()
    yield
    profiling.reset()


def recorder():
    return profile(activities=[ProfilerActivity.CPU])


def program_spans(prof) -> list:
    return [e for e in from_profiler(prof).host if e.name.startswith(spans.PREFIX)]


def inside(outer, events, name):
    return [e for e in events if e.name == spans.PREFIX + name
            and outer.start <= e.start and e.end <= outer.end]


def test_span_without_a_profiler_is_the_shared_noop():
    assert not profiling.recording()
    assert profiling.span("a") is profiling.span("b") is profiling.OFF
    with profiling.span("a"):
        profiling.count("c")
        profiling.append("d", (1, 2))
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_spans_nest_in_the_trace_and_fill_the_tables():
    @profiling.traced("outer")
    def work():
        with profiling.span("inner"):
            torch.ones(8, 8).sum()
        profiling.count("c", 2)
        profiling.append("shapes", (3, 4))

    with recorder() as prof:
        assert profiling.recording()
        work()
        work()
    assert not profiling.recording()
    events = program_spans(prof)
    outers = [e for e in events if e.name == "vs::outer"]
    assert len(outers) == 2
    assert all(len(inside(o, events, "inner")) == 1 for o in outers)
    snap = profiling.snapshot()
    assert {k: v["count"] for k, v in snap["spans"].items()} == {"outer": 2, "inner": 2}
    assert snap["spans"]["outer"]["seconds"] >= snap["spans"]["inner"]["seconds"] > 0
    assert snap["counters"] == {"c": 4, "shapes": [(3, 4), (3, 4)]}
    profiling.reset()
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_spans_carry_the_request_txid(tmp_path):
    token = profiling.TXID.set(41)
    try:
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
            with profiling.span("http.request"):
                pass
    finally:
        profiling.TXID.reset(token)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    (ev,) = [e for e in events if e.get("name") == "vs::http.request"]
    assert ev["args"]["txid"] == 41


def test_device_trace_holds_the_spans_of_every_thread(tmp_path):
    import threading

    with profiling.device_trace(str(tmp_path)):
        assert profiling.recording()
        def work():
            with profiling.span("worker"):
                pass

        with profiling.span("main"):
            worker = threading.Thread(target=work)
            worker.start()
            worker.join()
    assert not profiling.recording()
    (path,) = tmp_path.glob("trace-*.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"vs::main", "vs::worker"} <= names


def test_device_trace_holds_the_served_spans_of_the_loop_and_executor_threads(tmp_path):
    from test_torch_served_batch import search_body, served

    with served(rows=1000, clusters=4) as (_, client):
        with profiling.device_trace(str(tmp_path)):
            client.post("/api/search", search_body(range(8)))
    (path,) = tmp_path.glob("trace-*.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if str(e.get("name", "")).startswith(spans.PREFIX)]
    tid = {e["name"][len(spans.PREFIX):]: e["tid"] for e in events}
    # parsed and encoded on the event loop's thread, paged on an executor's
    assert tid["http.parse"] == tid["http.encode"] == tid["http.request"]
    assert tid["engine.pages"] == tid["engine.hits"] == tid["engine.search_many"]
    assert tid["http.parse"] != tid["engine.pages"]


def tiny_index(n=3000, d=64, k=12):
    rng = np.random.default_rng(3)
    packed = layout.pack_float(rng.normal(size=(n, d)).astype(np.float32))
    built = build_centroids(packed, k=k, max_iters=3, superset_iters=2, device="cpu")
    ivf = IVFIndex.build(packed, np.arange(n), built.centroids,
                         assignments=built.assignments, device="cpu")
    return ivf, rng.normal(size=(16, d)).astype(np.float32)


@pytest.mark.parametrize("spill", [False, True])
def test_ivf_search_spans_and_counters(spill):
    ivf, q = tiny_index()
    if spill:  # a frozen store sends inserts to the spill tail
        extra = layout.pack_float(q[:4])
        ivf = dataclasses.replace(ivf, frozen=True).insert(extra, np.arange(4) + 10_000)
        assert ivf.spill.live == 4
    with recorder() as prof:
        for _ in range(2):
            ivf.search(q, k=5, nprobe=3, refine=10)
    events = program_spans(prof)
    calls = [e for e in events if e.name == "vs::ivf.search"]
    assert len(calls) == 2
    children = ["ivf.upload", "ivf.dispatch", "ivf.id_map"] + (["ivf.spill"] if spill else [])
    stages = ["scan.probe", "scan.groups", "scan.kernel", "scan.epilogue", "scan.refine"]
    for call in calls:
        for child in children:
            assert len(inside(call, events, child)) == 1, child
        (dispatch,) = inside(call, events, "ivf.dispatch")
        for stage in stages:
            assert len(inside(dispatch, events, stage)) == 1, stage
        # two waits a call: the upload and the read of the answers (the
        # spill tail's too)
        assert len(inside(call, events, "ivf.sync")) == 2
    snap = profiling.snapshot()
    # the spill tail's refined FlatIndex.topk takes the band route
    band = {"flat.band_scans": 2} if spill else {}
    assert snap["counters"] == {"ivf.calls": 2, "ivf.syncs": 4, **band}
    assert snap["spans"]["ivf.sync"]["count"] == 4
    assert ("ivf.spill" in snap["spans"]) == spill


def test_build_records_its_phases_and_passes_as_the_pass_recorder_does():
    from vectorsearch_tpu_torch.kernels import kmeans as kmeans_kernels
    from vsbench.drivers.build import PassRecorder

    rng = np.random.default_rng(4)
    # two dense blobs among spread rows: the balance round has two clusters to split
    x = np.concatenate([rng.normal(size=(2500, 32)), 0.05 * rng.normal(size=(1500, 32)) + 3,
                        0.05 * rng.normal(size=(1500, 32)) - 3])
    packed = layout.pack_float(x.astype(np.float32))
    kw = dict(k=8, max_iters=4, superset_iters=2, min_cluster_size=1, device="cpu")
    # the clusters the round splits: those above twice the mean before it
    counts = build_centroids(packed, balance_rounds=0, **kw).counts
    splits = int((counts > 2 * max(1, int(counts.sum() // len(counts)))).sum())
    rec = PassRecorder(kmeans_kernels, len(x))
    rec.install()
    try:
        rec.recording = True
        with recorder() as prof:
            build_centroids(packed, **kw)
    finally:
        rec.remove()
    snap = profiling.snapshot()
    assert snap["counters"]["kmeans.pass_shapes"] == rec.passes
    assert snap["counters"]["kmeans.passes"] == len(rec.passes) > 0
    assert snap["spans"]["kmeans.pass"]["count"] == len(rec.passes)
    assert snap["spans"]["build"]["count"] == 1
    # a balance round's sub-builds open their own (nested) lloyd phases
    assert snap["spans"]["build.balance"]["count"] == 1
    # one pass over the assignments finds every split cluster's members
    assert snap["spans"]["balance.members"]["count"] == 1
    assert snap["counters"]["balance.splits"] == splits == 2
    assert snap["spans"]["build.lloyd"]["count"] > 1
    events = program_spans(prof)
    (build,) = [e for e in events if e.name == "vs::build"]
    (balance,) = inside(build, events, "build.balance")
    assert inside(balance, events, "build.lloyd") and inside(balance, events, "balance.members")


def test_nested_phase_opens_its_span_and_keeps_its_seconds():
    t = BuildProgress()
    with recorder():
        with t.phase("balance", "round 1") as outer:
            with t.phase("lloyd") as inner:
                assert t.snapshot()["phase"] == "balance"  # the tracker ignores it
    assert outer.seconds >= inner.seconds >= 0
    assert [p["phase"] for p in t.snapshot()["phases_done"]] == ["balance"]
    assert set(profiling.snapshot()["spans"]) == {"build.balance", "build.lloyd"}


def host(name, start, end):
    return Event(spans.PREFIX + name, "host", start, end)


# two calls of 3 ms: the first waits 1 ms on the card in two reads (0.5 ms
# of them overlapping), the second 0.5 ms; two builds of 2 s and 4 s
SEARCH = [host("ivf.search", 0, 3000), host("ivf.sync", 500, 1000), host("ivf.sync", 800, 1500),
          host("ivf.search", 4000, 7000), host("ivf.sync", 6000, 6500)]
BUILD = [host("build", 0, 2e6), host("build.upload", 0, 5e5), host("kmeans.pass", 6e5, 1.1e6),
         host("kmeans.pass", 1.2e6, 1.5e6), host("build", 3e6, 7e6),
         host("build.upload", 3e6, 4e6), host("kmeans.pass", 4e6, 6e6)]
COUNTERS = {"ivf.calls": 4, "ivf.syncs": 8, "kmeans.passes": 18}
# a batched request of 10 ms: parse 0.5 ms and encode 0.8 ms on the loop's
# thread, pages 1 ms and hits 0.5 ms in its search_many on an executor's
REQUEST = [host("http.request", 0, 10000), host("http.parse", 100, 600),
           host("engine.search_many", 700, 9000), host("engine.pages", 5000, 6000),
           host("engine.hits", 8000, 8500), host("http.encode", 9100, 9900)]
# and a second one that overlaps it on other threads: read by time, its
# parse, pages and hits would lie inside the first request's spans
OVERLAPPING = REQUEST + [
    host("http.request", 2000, 14000), host("http.parse", 2100, 2400),
    host("engine.search_many", 2500, 13000), host("engine.pages", 6500, 8000),
    host("engine.hits", 8200, 8400), host("http.encode", 13100, 13800)]
# as a program without the new spans records the same requests
UNSPLIT = [e for e in OVERLAPPING if e.name in ("vs::http.request", "vs::engine.search_many")]


def span_table(events) -> dict:
    """The table `profiling.snapshot()["spans"]` holds after the events:
    each span's count and summed seconds, over every thread."""
    table = {}
    for e in events:
        row = table.setdefault(e.name[len(spans.PREFIX):], {"count": 0, "seconds": 0.0, "cpu_s": 0.0})
        row["count"] += 1
        row["seconds"] += (e.end - e.start) / 1e6
    return table


@pytest.mark.parametrize("name, host_events, layer, want", [
    ("search.host_ms", SEARCH, {}, (2.0 + 2.5) / 2),
    ("search.sync_ms", SEARCH, {}, (1.0 + 0.5) / 2),
    ("search.syncs_per_call", [], {}, 2.0),
    ("build.host_s", BUILD, {}, (0.7 + 1.0) / 2),
    ("build.passes", [], {"builds": 3}, 6.0),
    ("served.json_ms", REQUEST, {}, 0.5 + 0.8),
    ("served.pages_ms", REQUEST, {}, 1.0 + 0.5),
    ("served.json_ms", OVERLAPPING, {}, (0.5 + 0.8 + 0.3 + 0.7) / 2),
    ("served.pages_ms", OVERLAPPING, {}, (1.0 + 0.5 + 1.5 + 0.2) / 2),
    ("served.json_ms", UNSPLIT, {}, None),
    ("served.pages_ms", UNSPLIT, {}, None),
])
def test_span_readers(monkeypatch, name, host_events, layer, want):
    reader = harness.load_module(tiny.ROOT / "vsbench" / "metrics" / f"{name}.py", f"t_{name}")
    cell = tiny.cell({"build": "d10m-build", "served": "d1m-http-batch256"}.get(
        name.split(".")[0], "d10m-lib-b512-np8"))

    def reading(events, trace=True):
        out = harness.Outcome(attempted=1, failed=0, e2e={}, layer=dict(layer))
        return harness.Reading(cell, out, 1.0, Trace([], list(events)) if trace else None)

    monkeypatch.setattr(profiling, "snapshot",
                        lambda: {"spans": span_table(host_events), "counters": COUNTERS})
    got = reader.read(reading(host_events))
    assert got is None if want is None else got == pytest.approx(want)
    # an older program: no spans in the trace, no snapshot() to read
    monkeypatch.delattr(profiling, "snapshot")
    assert reader.read(reading([])) is None
    assert reader.read(reading([], trace=False)) is None


def test_idle_by_span():
    dev = [Event("k", KERNEL, 0, 100), Event("k", KERNEL, 300, 400), Event("k", KERNEL, 600, 700),
           Event("k", KERNEL, 1000, 1100)]
    prog = [host("ivf.search", 50, 900), host("ivf.id_map", 420, 580)]
    # gaps 100-300 (in ivf.search), 400-600 (in ivf.id_map), 700-1000 (mid 850, in ivf.search)
    got = dict(spans.idle_by_span(Trace(dev, prog)))
    assert got == pytest.approx({"ivf.search": 500e-6, "ivf.id_map": 200e-6})
    assert dict(spans.idle_by_span(Trace(dev, []))) == pytest.approx({spans.NONE: 700e-6})


class StubEngine:
    """The engine's surface the router calls, recording what it saw."""

    def __init__(self):
        self.txids = []

    def stats(self):
        return {}

    def search(self, owner, category, text, **kw):
        with profiling.span("engine.search"):
            self.txids.append(profiling.TXID.get())
        return []


def call_app(app, method, path, body=b""):
    from vectorsearch_tpu_torch.api.http import Request

    async def go():
        return await app(Request(method, path, "HTTP/1.1", {}, body))

    return asyncio.run(go())


def test_stats_holds_trace_only_while_a_profiler_records():
    from vectorsearch_tpu_torch.api import build_app

    eng = StubEngine()
    app = build_app(eng)
    assert "trace" not in json.loads(call_app(app, "GET", "/api/stats").body)
    with recorder():
        resp = call_app(app, "POST", "/api/search", b'{"owner": "o", "category": "c"}')
        assert resp.status == 200
        stats = json.loads(call_app(app, "GET", "/api/stats").body)
    assert "trace" not in json.loads(call_app(app, "GET", "/api/stats").body)
    trace = stats["trace"]
    assert trace["spans"]["http.request"]["count"] == 1
    assert trace["spans"]["engine.search"]["count"] == 1
    assert trace["counters"]["http.queue_s"] >= 0
    # the engine's span, on an executor thread, carries the request's txid
    assert len(eng.txids) == 1 and isinstance(eng.txids[0], int)
