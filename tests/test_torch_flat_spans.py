"""The flat index's spans and counters (index/flat.py) at their sites, on
the CPU under torch.profiler's CPU activity: `FlatIndex.search` records
its call, its scan, its refine and each wait on the card; a refined call
takes the band route and counts one `flat.band_scans`, an unrefined one
none; the IVF spill tail, which calls `FlatIndex.topk`, counts no flat
call; the answers do not depend on whether a profiler records."""
import dataclasses

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from vectorsearch_tpu_torch.build import build_centroids
from vectorsearch_tpu_torch.index import FlatIndex, IVFIndex
from vectorsearch_tpu_torch.quant import layout
from vectorsearch_tpu_torch.utils import profiling
from vsbench import spans
from vsbench.trace import from_profiler

D = 48
CALLS = 3
WAITS = 3  # the queries' upload, the read of the scores, the read of the slots


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


def tiny_flat(n=2500):
    rng = np.random.default_rng(7)
    packed = layout.pack_float(rng.normal(size=(n, D)).astype(np.float32))
    flat = FlatIndex.from_packed(packed, np.arange(n, dtype=np.int64) + 100, device="cpu")
    flat = flat.remove_ids(np.array([100, 150, 2599]))  # tombstones in the scan
    return flat, rng.normal(size=(16, D)).astype(np.float32)


@pytest.mark.parametrize("refine", [0, 24])
def test_flat_search_spans_and_counters(refine):
    flat, q = tiny_flat()
    with recorder() as prof:
        for _ in range(CALLS):
            flat.search(q, k=5, chunk=1024, refine=refine)
    events = program_spans(prof)
    calls = [e for e in events if e.name == "vs::flat.search"]
    assert len(calls) == CALLS
    for call in calls:
        assert len(inside(call, events, "flat.scan")) == 1
        assert len(inside(call, events, "flat.refine")) == (1 if refine else 0)
        assert len(inside(call, events, "flat.sync")) == WAITS
    snap = profiling.snapshot()
    band = {"flat.band_scans": CALLS} if refine else {}
    assert snap["counters"] == {"flat.calls": CALLS, "flat.syncs": CALLS * WAITS, **band}
    assert snap["spans"]["flat.sync"]["count"] == CALLS * WAITS
    assert snap["spans"]["flat.search"]["seconds"] >= snap["spans"]["flat.scan"]["seconds"] > 0


@pytest.mark.parametrize("refine", [0, 1, 5, 24])
def test_band_scans_count_refined_calls(refine):
    """One `flat.band_scans` a call that refines (refine below, at and above
    k), none at refine 0; `topk` alone counts it too."""
    flat, q = tiny_flat()
    with recorder():
        for _ in range(CALLS):
            flat.search(q, k=5, chunk=1024, refine=refine)
        flat.topk(q, k=5, refine=refine)
    counters = profiling.snapshot()["counters"]
    assert counters.get("flat.band_scans", 0) == (CALLS + 1 if refine else 0)
    assert counters["flat.calls"] == CALLS


@pytest.mark.parametrize("refine", [0, 24])
def test_spans_nest_in_order(refine):
    """Within each `flat.search`: the upload's wait, then `flat.scan`, then
    `flat.refine` (refined calls only), then the two reads; none overlaps
    another."""
    flat, q = tiny_flat()
    with recorder() as prof:
        for _ in range(CALLS):
            flat.search(q, k=5, chunk=1024, refine=refine)
    events = program_spans(prof)
    names = ["flat.sync", "flat.scan"] + (["flat.refine"] if refine else []) + ["flat.sync"] * 2
    for call in [e for e in events if e.name == "vs::flat.search"]:
        inner = sorted((e for e in events if e is not call and call.start <= e.start
                        and e.end <= call.end), key=lambda e: e.start)
        assert [e.name for e in inner] == [spans.PREFIX + n for n in names]
        assert all(a.end <= b.start for a, b in zip(inner, inner[1:]))


def test_spill_tail_counts_no_flat_call():
    rng = np.random.default_rng(3)
    n = 3000
    packed = layout.pack_float(rng.normal(size=(n, D)).astype(np.float32))
    built = build_centroids(packed, k=12, max_iters=3, superset_iters=2, device="cpu")
    ivf = IVFIndex.build(packed, np.arange(n), built.centroids,
                         assignments=built.assignments, device="cpu")
    q = rng.normal(size=(16, D)).astype(np.float32)
    # a frozen store sends inserts to the spill tail
    ivf = dataclasses.replace(ivf, frozen=True).insert(layout.pack_float(q[:4]),
                                                        np.arange(4) + 10_000)
    assert ivf.spill.live == 4
    with recorder() as prof:
        ivf.search(q, k=5, nprobe=3, refine=10)
    counters = profiling.snapshot()["counters"]
    assert "flat.calls" not in counters and "flat.syncs" not in counters
    assert counters["flat.band_scans"] == 1  # the tail's refined topk takes the band route
    assert counters["ivf.calls"] == 1
    events = program_spans(prof)
    (spill,) = [e for e in events if e.name == "vs::ivf.spill"]
    assert len(inside(spill, events, "flat.scan")) == 1  # the tail's scan, inside ivf.spill
    assert not [e for e in events if e.name in ("vs::flat.search", "vs::flat.sync")]


@pytest.mark.parametrize("refine", [0, 24])
def test_answers_bit_identical_with_and_without_a_profiler(refine):
    flat, q = tiny_flat()
    off = flat.search(q, k=7, chunk=1024, refine=refine)
    with recorder():
        on = flat.search(q, k=7, chunk=1024, refine=refine)
    assert profiling.snapshot()["counters"]["flat.calls"] == 1
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert not np.isin(off[1], [100, 150, 2599]).any()  # tombstones stay out
