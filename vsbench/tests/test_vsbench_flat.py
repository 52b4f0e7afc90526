"""The exact flat cell (`d1m-flat-b512`) and the library cell at nprobe 64
(`d10m-lib-b512-np64`) at a tiny size on the CPU: each run through the
harness, the flat reference against a brute-force top k, the flat work
count against a hand count, the flat readers on constructed readings,
and the comparison that decides `correct` shown to fail for the control
and for faults planted in the flat path."""
import json

import numpy as np
import pytest
import torch

from vsbench import checks, flat_work, harness, roofline
from vsbench.reference import flat as ref_flat
from vsbench.tests import tiny
from vsbench.trace import KERNEL, MEMCPY, Event, Trace

CELLS = ["d1m-flat-b512", "d10m-lib-b512-np64"]
SEED = 2**31 + 23


def cell(name, seed=SEED, trace=False):
    c = tiny.cell(name, seed=seed, seconds=1, trace=trace, batch=32, query_pool=128)
    # the tiny size holds 24 clusters, fewer than the cell's nprobe of 64
    nprobe = int(c.traffic.get("nprobe", 0))
    c.config["clusters"] = max(c.config["clusters"], 2 * nprobe)
    return c


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run(name, trace):
    c = cell(name, trace=trace)
    result, check, _ = tiny.run(c)
    assert result["correct"], check
    assert result["attempted"] > 0 and result["failed"] == 0
    if trace:  # no device on the CPU: only the counters and spans read
        assert set(result["metrics"]) <= {m["name"] for m in c.metrics("per_layer")}
        assert result["device"]["window_s"] > 0
    else:
        assert set(result["metrics"]) == {m["name"] for m in c.metrics("end_to_end")}
        assert all(v["value"] > 0 for v in result["metrics"].values())
    json.dumps(result)


def test_flat_host_ms_reads_on_the_cpu():
    result, _, _ = tiny.run(cell("d1m-flat-b512", trace=True))
    assert result["metrics"]["flat.host_ms"]["value"] > 0
    assert "flat.roofline_share" not in result["metrics"]  # no device kernels here


def test_new_cells_in_the_spec():
    spec = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    assert cells["d1m-flat-b512"]["config"] == "vdbb-768d1m-flat"
    assert cells["d10m-lib-b512-np64"]["config"] == "vdbb-768d10m-lib"
    np64 = json.loads((tiny.ROOT / "vsbench" / "traffic" / "lib-b512-np64.json").read_text())
    np8 = json.loads((tiny.ROOT / "vsbench" / "traffic" / "lib-b512-np8.json").read_text())
    assert np64.pop("nprobe") == 64 and np8.pop("nprobe") == 8 and np64 == np8
    config = json.loads((tiny.ROOT / "vsbench" / "configs" / "vdbb-768d1m-flat.json").read_text())
    engine = json.loads((tiny.ROOT / "vsbench" / "configs" / "vdbb-768d1m-engine.json").read_text())
    assert config["corpus"] == engine["corpus"] and config["reduced"] == []
    assert (config["rows"], config["dim"], config["clusters"]) == (1_000_000, 768, 1024)


@pytest.mark.parametrize("precision, tol", [("f64", 1e-12), ("tf32", 2e-3)])
def test_flat_reference_against_brute_force(precision, tol):
    rng = np.random.default_rng(11)
    rows = rng.normal(size=(37, 8))
    rows[5] = 0.0  # a zero row: cosine 0
    queries = rng.normal(size=(5, 8)).astype(np.float32)
    slabs = [(s, rows[s : s + 10]) for s in range(0, 37, 10)]
    sims, idx = ref_flat.search(queries, slabs, 37, 4, torch.device("cpu"), precision)
    q = queries.astype(np.float64)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    norms = np.linalg.norm(rows, axis=1, keepdims=True)
    cos = q @ (rows / np.where(norms == 0, 1, norms)).T
    want_idx = np.argsort(-cos, axis=1, kind="stable")[:, :4]
    want = np.take_along_axis(cos, want_idx, axis=1)
    assert sims.shape == idx.shape == (5, 4)
    assert np.allclose(sims, want, rtol=0, atol=tol)
    if precision == "f64":
        assert np.array_equal(idx, want_idx)
    # more rows asked for than the index holds: -inf and -1 after them
    sims, idx = ref_flat.search(queries, slabs, 37, 40, torch.device("cpu"))
    assert np.isneginf(sims[:, 37:]).all() and (idx[:, 37:] == -1).all()
    assert all(sorted(r[:37]) == list(range(37)) for r in idx.tolist())


def test_flat_work_hand_count():
    # 1000 rows of D = 8, 4 queries, k = 3, 5 calls
    b, ops = flat_work.flat_work(1000, 8, 4, 3, 5)
    # a call: 1000 rows x (8 codes + 12 sidecar bytes + 1 mask byte), 4 f32
    # queries of 8, 4 x 3 (score, id) pairs of 12 bytes
    assert b == 5 * (1000 * 21 + 4 * 8 * 4 + 4 * 3 * 12)
    assert ops == 5 * 2 * 4 * 1000 * 8
    assert flat_work.flat_work(1000, 8, 4, 3, 0) == (0.0, 0.0)


def reader(name):
    return harness.load_module(tiny.ROOT / "vsbench" / "metrics" / f"{name}.py", f"t_{name}")


def reading(layer, events=(), host=(), trace=True):
    out = harness.Outcome(attempted=1, failed=0, e2e={}, layer=dict(layer))
    tr = Trace(list(events), list(host)) if trace else None
    return harness.Reading(cell("d1m-flat-b512"), out, 1.0, tr)


def host(name, start, end):
    return Event("vs::" + name, "host", start, end)


def test_flat_roofline_share():
    ops = 2.0 * flat_work.PEAK_INT8_PER_S * 1e-3  # 2 ms at the int8 peak
    work = (1.0e9, ops)  # bytes: 0.3 ms at 3.35 TB/s, so the operations bind
    assert roofline.least_s(*work, flat_work.PEAK_INT8_PER_S) == pytest.approx(2e-3)
    ev = [Event("void at::native::gemm_f32(float*)", KERNEL, 0, 3000),
          Event("void at::native::topk(float*)", KERNEL, 3000, 4000),
          Event("Memcpy HtoD (Pageable -> Device)", MEMCPY, 4000, 9000)]
    r = reader("flat.roofline_share")
    assert r.read(reading({"flat_work": work}, ev)) == pytest.approx(50.0)  # 2 of 4 kernel ms
    assert r.read(reading({}, ev)) is None  # no work count in the outcome
    assert r.read(reading({"flat_work": work}, ev[2:])) is None  # no kernel
    assert r.read(reading({"flat_work": work}, ev, trace=False)) is None


def test_flat_host_ms():
    # two calls of 4 ms and 2 ms, waiting 1 + 0.5 ms and 0.5 ms on the card
    spans = [host("flat.search", 0, 4000), host("flat.sync", 100, 1100),
             host("flat.scan", 1200, 3000), host("flat.sync", 3200, 3700),
             host("flat.search", 5000, 7000), host("flat.sync", 6000, 6500),
             host("ivf.sync", 8000, 9000)]
    r = reader("flat.host_ms")
    assert r.read(reading({}, host=spans)) == pytest.approx(((4 - 1.5) + (2 - 0.5)) / 2)
    # a program without the spans (an older commit), no call, no trace
    assert r.read(reading({}, host=[host("ivf.search", 0, 10)])) is None
    assert r.read(reading({}, host=[])) is None
    assert r.read(reading({}, trace=False)) is None


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_program_passes(name):
    result, check, ctrl = tiny.run(cell(name, seed=3), with_control=True)
    assert result["correct"], check
    assert not checks.passed(ctrl), ctrl


@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered", "coarse_scores"])
def test_flat_faults_fail(monkeypatch, fault):
    from vectorsearch_tpu_torch.index import FlatIndex

    orig = FlatIndex.search

    def search(self, queries, k, chunk=65_536, refine=0):
        if fault == "coarse_scores":  # the int8 scan's scores, no exact refine
            return orig(self, queries, k, chunk=chunk, refine=0)
        scores, ids = orig(self, queries, k, chunk=chunk, refine=refine)
        scores, ids = scores.copy(), ids.copy()
        if fault == "half_left_out":  # the batch's second half never answered
            half = len(ids) // 2
            scores[half:], ids[half:] = -np.inf, -1
        else:  # one answer altered where it is produced
            ids[0, 0] = ids[0, -1] if ids[0, -1] != ids[0, 0] else ids[0, 0] + 1
        return scores, ids

    monkeypatch.setattr(FlatIndex, "search", search)
    result, check, _ = tiny.run(cell("d1m-flat-b512", seed=4))
    assert not result["correct"], check
