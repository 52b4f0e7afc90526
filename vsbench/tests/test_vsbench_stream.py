"""The writing cell (`d10m-stream-b512-w1024`) and the exhaustive cell
(`d10m-lib-exhaustive`, whose traffic file waits for a steady program
path before BENCHMARK.json lists it: PERF.md, Open questions) at a tiny
size on the CPU: each run through the harness in both modes, the
live-row reference on a hand example, the write readers on constructed
readings, the scan work counted over the live rows, and the comparison
that decides `correct` shown to fail for the control and for faults
planted in the write path."""
import json

import numpy as np
import pytest
import torch

from vsbench import checks, harness, spans
from vsbench.reference import stream as ref_stream
from vsbench.tests import tiny
from vsbench.trace import Event, Trace

STREAM = "d10m-stream-b512-w1024"
SEED = 2**31 + 24
# the tiny size: 6,000 x 64 base rows, 16 clusters, writes of 128 rows
# after every 2 calls of 32 queries, 8 of them read-your-writes; a window
# of 2 s, in which even a loaded test machine makes a call after a write
SMALL = {"batch": 32, "query_pool": 128, "calls_per_write": 2, "write_rows": 128,
         "stream_pool": 4096, "rw_queries": 8}
EXHAUSTIVE = "d10m-lib-exhaustive"


def spec_with_exhaustive() -> dict:
    """BENCHMARK.json with the exhaustive cell and the metrics it would
    report, in memory."""
    spec = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": EXHAUSTIVE, "config": "vdbb-768d10m-lib",
                              "traffic": "lib-b512-exhaustive", "chips": 1, "why": "-"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("search_qps", "device.idle_share.search"):
            m["workloads"].append(EXHAUSTIVE)
    return spec


def cell(name=STREAM, seed=SEED, trace=False, spill=False, monkeypatch=None):
    if name == STREAM:
        c = tiny.cell(name, seed=seed, seconds=2, trace=trace, **SMALL)
    else:  # the exhaustive cell, at tiny.cell's size: every cluster probed
        c = harness.load_cell(name, seed, 1, trace, torch.device("cpu"), tiny.ROOT,
                              spec_with_exhaustive())
        c.config.update(tiny.CONFIG, clusters=tiny.CLUSTERS[c.config["name"]])
        c.traffic.update(tiny.TRAFFIC["library"], nprobe=c.config["clusters"])
    if spill:  # buckets a little above the fullest cluster's rows, and
        # writes of 1,024 rows (64 a cluster): the first write spills
        from vectorsearch_tpu_torch import constants
        from vectorsearch_tpu_torch.index import ivf

        capacity = ivf.bucket_capacity
        monkeypatch.setattr(constants, "BUCKET_ROUND", 64)
        monkeypatch.setattr(ivf, "bucket_capacity", lambda n, headroom=1.0: capacity(n, 1.0))
        c.traffic["write_rows"] = 1024
    return c


@pytest.mark.parametrize("name, spill", [(STREAM, False), (STREAM, True),
                                         (EXHAUSTIVE, False)])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run(monkeypatch, capsys, name, spill, trace):
    c = cell(name, trace=trace, spill=spill, monkeypatch=monkeypatch)
    result, check, _ = tiny.run(c)
    assert result["correct"], check
    assert result["attempted"] > 0 and result["failed"] == 0
    if trace:  # no device on the CPU: only the counters and spans read
        assert set(result["metrics"]) <= {m["name"] for m in c.metrics("per_layer")}
        if name == STREAM:
            assert {"write.ms", "write.copy_gb", "search.host_ms", "search.sync_ms",
                    "search.graph_share"} <= set(result["metrics"])
            assert result["metrics"]["write.copy_gb"]["value"] > 0
            assert (spans.counters().get("ivf.spilled_rows", 0) > 0) == spill
    else:
        assert set(result["metrics"]) == {m["name"] for m in c.metrics("end_to_end")}
        assert all(v["value"] > 0 for v in result["metrics"].values())
    if name == STREAM:
        err = capsys.readouterr().err
        assert f"writes of {c.traffic['write_rows']} rows" in err
        assert check["write_missing"]["value"] == 0
    json.dumps(result)


@pytest.mark.parametrize("name", [STREAM, EXHAUSTIVE])
def test_control_fails_program_passes(name):
    result, check, ctrl = tiny.run(cell(name, seed=3), with_control=True)
    assert result["correct"], check
    assert not checks.passed(ctrl), ctrl


def _plant(monkeypatch, fault):
    from vectorsearch_tpu_torch.index import IVFIndex

    orig = IVFIndex.insert

    def insert(self, new, ids, cids=None):
        if fault == "dropped_write":  # the caller keeps searching the old index
            return self
        return orig(self, new, np.asarray(ids) + 1, cids)  # rows under the next ids

    monkeypatch.setattr(IVFIndex, "insert", insert)


@pytest.mark.parametrize("fault, fails", [("dropped_write", {"write_missing", "topk_gap"}),
                                          ("ids_shifted", {"write_missing", "sim_err"})])
def test_write_faults_fail(monkeypatch, fault, fails):
    _plant(monkeypatch, fault)
    result, check, _ = tiny.run(cell(seed=4))
    assert not result["correct"], check
    assert {k for k, c in check.items() if c["value"] > c["limit"]} >= fails, check


def test_stream_pool_used_up_searches_on(capsys):
    c = cell(seed=5)
    c.traffic.update(stream_pool=128)  # one write, then none at the fourth call
    result, check, _ = tiny.run(c)
    assert result["correct"], check
    assert "used up" in capsys.readouterr().err


def test_same_seed_same_stream():
    from vsbench import corpus
    from vsbench.drivers import stream

    def rows(seed):
        c = cell(seed=seed)
        gen = corpus.Corpus(corpus.Recipe.of(c.config), seed, torch.device("cpu"))
        return stream.stream_rows(gen, 300)

    (a, ma), (b, mb), (x, mx) = rows(99), rows(99), rows(100)
    assert all(np.array_equal(p, q) for p, q in zip(a, b)) and np.array_equal(ma, mb)
    assert not np.array_equal(a[0], x[0])


def test_live_rows_reference():
    rng = np.random.default_rng(1)

    def packed(n):
        return (rng.integers(-128, 128, (n, 4)).astype(np.int8), rng.random(n).astype(np.float32),
                rng.random(n).astype(np.float32), np.ones(n, np.float32))

    base, stream = packed(5), packed(6)
    live = ref_stream.n_live(5, 2, 2)
    assert live == 9
    assert ref_stream.members(np.arange(5), np.arange(6) + 10, live).tolist() == \
        [0, 1, 2, 3, 4, 10, 11, 12, 13]
    def f64(p):  # offset + scale * code
        return p[2][:, None].astype(np.float64) + p[1][:, None].astype(np.float64) * p[0]

    every = np.concatenate([f64(base), f64(stream)[:4]])
    assert np.allclose(ref_stream.rows_f64(base, stream, np.array([7, 0, 5])), every[[7, 0, 5]])
    got = list(ref_stream.slabs(base, stream, live, torch.device("cpu"), step=2))
    assert [s for s, _ in got] == [0, 2, 4, 5, 7]
    assert np.allclose(np.concatenate([r.numpy() for _, r in got]), every)


@pytest.mark.parametrize("events, want", [
    ([("vs::ivf.insert", 0, 2000), ("vs::ivf.insert", 5000, 9000), ("vs::ivf.search", 0, 9000)],
     3.0),
    ([("vs::ivf.search", 0, 9000)], None),  # a program without the span
])
def test_write_ms(events, want):
    reader = harness.load_module(tiny.ROOT / "vsbench" / "metrics" / "write.ms.py", "t_write.ms")
    trace = Trace(host=[Event(n, "host", s, e) for n, s, e in events])
    assert reader.read(harness.Reading(None, None, 1.0, trace)) == want


@pytest.mark.parametrize("counters, want", [
    ({"ivf.inserts": 4, "ivf.copied_bytes": 8e9}, 2.0),
    ({"ivf.inserts": 4}, None),  # a program without the byte counter
    ({"ivf.copied_bytes": 8e9}, None),
    ({}, None),
])
def test_write_copy_gb(monkeypatch, counters, want):
    reader = harness.load_module(tiny.ROOT / "vsbench" / "metrics" / "write.copy_gb.py",
                                 "t_write.copy_gb")
    monkeypatch.setattr(spans, "counters", lambda: counters)
    assert reader.read(None) == want


def test_new_cells_in_the_spec():
    spec = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    assert cells[STREAM]["config"] == "vdbb-768d10m-stream"
    assert EXHAUSTIVE not in cells  # until its path is steady across seeds
    traffic = tiny.ROOT / "vsbench" / "traffic"
    exhaustive = json.loads((traffic / "lib-b512-exhaustive.json").read_text())
    np8 = json.loads((traffic / "lib-b512-np8.json").read_text())
    lib = json.loads((tiny.ROOT / "vsbench" / "configs" / "vdbb-768d10m-lib.json").read_text())
    assert exhaustive.pop("nprobe") == lib["clusters"] and np8.pop("nprobe") == 8
    assert exhaustive == np8
    config = json.loads((tiny.ROOT / "vsbench" / "configs" / "vdbb-768d10m-stream.json").read_text())
    assert {k: config[k] for k in ("rows", "dim", "clusters", "corpus")} == \
        {k: lib[k] for k in ("rows", "dim", "clusters", "corpus")}
    assert config["reduced"] == [] and set(config["guarantees"]) == {"results", "writes"}
    stream = json.loads((traffic / "stream-b512-np8-w1024.json").read_text())
    assert stream["checks"] == {**np8["checks"], "write_missing": 0}
    assert stream["driver"] == "stream" and {"nprobe", "batch", "k", "refine"} <= set(stream)
    metrics = {m["name"]: m for m in spec["per_layer"] + spec["end_to_end"]}
    for name in ("search_qps", "device.idle_share.search", "search.host_ms", "search.sync_ms",
                 "search.graph_share", "search.syncs_per_call", "epilogue.device_ms",
                 "scan.roofline_share", "write.ms", "write.copy_gb"):
        assert STREAM in metrics[name]["workloads"]
        assert EXHAUSTIVE not in metrics[name]["workloads"]
    assert metrics["write.ms"]["layer"] == metrics["write.copy_gb"]["layer"] == "index write"


@pytest.mark.parametrize("writes", [0, 1, 3])
def test_scan_work_over_the_live_rows(writes):
    """The stream window's scan work is the library driver's count over
    the rows live at each call: with no write before a call, the same; a
    call after writes reads more rows, and a call after a write probes for
    its read-your-writes queries."""
    from vsbench import corpus, roofline
    from vsbench.drivers import library, stream
    from vsbench.reference import ivf as ref_ivf

    c = cell(seed=7)
    st = stream.setup(c)
    tr = c.traffic
    bi = int(st["order"][0])
    after = writes - 1  # the call right after the last write (none at 0)
    got = stream.scan_work(st, tr, [(bi, writes, after)])
    counts = np.zeros(len(st["batches"]), np.int64)
    counts[bi] = 1
    lib = library.scan_work(st, tr, counts)
    if not writes:
        assert got == lib
        return
    q = stream.rw_batch(st, st["batches"][bi], after)
    probed = ref_ivf.probe(q, st["centroids"], int(tr["nprobe"]), "cpu")
    added = st["stream_members"][: writes * st["rows_w"]]
    k_all = len(st["centroids"])
    rows = np.bincount(st["members"], minlength=k_all) + np.bincount(added, minlength=k_all)
    assert got == roofline.scan_work(probed, rows, st["recipe"].dim, int(tr["refine"]))
    assert got[1] > 0 and corpus.Recipe.of(c.config).n == st["recipe"].n
