"""The per-layer readers on a recorded event list (the profiler's place
on the CPU), and the roofline's work count against a hand count."""
import numpy as np
import pytest

from vsbench import harness, roofline
from vsbench.trace import KERNEL, MEMCPY, Event, Trace, short_name
from vsbench.tests import tiny

SCAN = "void grouped_scores_kernel<16>(CUtensorMap, CUtensorMap, int const*)"
ASSIGN = "void kmeans_assign_kernel<4>(CUtensorMap, CUtensorMap, float const*)"


def reader(name):
    return harness.load_module(tiny.ROOT / "vsbench" / "metrics" / f"{name}.py", f"t_{name}")


def reading(layer, events, host=(), window_s=1.0):
    cell = tiny.cell("d10m-lib-b512-np8")
    out = harness.Outcome(attempted=1, failed=0, e2e={}, layer=layer)
    return harness.Reading(cell, out, window_s, Trace(list(events), list(host)))


def test_scan_work_hand_count():
    # 2 queries, nprobe 2, D = 4, k = 3; clusters hold 5, 7, 0 rows
    probed = np.array([[0, 1], [1, 2]])
    rows = np.array([5, 7, 0])
    b, ops = roofline.scan_work(probed, rows, dim=4, k=3)
    # distinct clusters 0, 1, 2: 12 rows x (4 codes + 12 sidecar bytes),
    # 2 bf16 queries of 4, 2 x 3 (score, slot) pairs of 12 bytes
    assert b == 12 * 16 + 2 * 4 * 2 + 2 * 3 * 12
    # (5 + 7) + (7 + 0) probed rows, 2 * D operations each
    assert ops == 2 * 4 * 19


def test_scan_roofline_share():
    work = (3.35e9, 1.0e9)  # 1 ms of bytes, 1 us of operations
    ev = [Event(SCAN, KERNEL, 0, 1000), Event(SCAN, KERNEL, 2000, 3000),
          Event("void at::topk(float*)", KERNEL, 3000, 3500)]
    share = reader("scan.roofline_share").read(reading({"scan_work": work}, ev))
    assert share == pytest.approx(50.0)
    assert reader("scan.roofline_share").read(reading({}, ev)) is None
    assert reader("scan.roofline_share").read(reading({"scan_work": work}, ev[2:])) is None


def test_epilogue_ms_and_idle_share():
    ev = [Event(SCAN, KERNEL, 0, 1000), Event("void at::topk(float*)", KERNEL, 500, 1500),
          Event("Memcpy HtoD (Pageable -> Device)", MEMCPY, 3000, 4000)]
    r = reading({"calls": 2}, ev, window_s=0.01)
    assert reader("epilogue.device_ms").read(r) == pytest.approx(0.5)
    # busy 0-1500 and 3000-4000 us: 2.5 ms of 10 ms
    assert reader("device.idle_share.search").read(r) == pytest.approx(75.0)
    assert reader("build.upload_share").read(r) == pytest.approx(10.0)


def test_assign_roofline_share():
    n, k, d = 100_000, 4096, 768  # operations bind
    least = roofline.assign_ops(n, k, d) / roofline.PEAK_BF16_PER_S
    ev = [Event(ASSIGN, KERNEL, 0, 2 * least * 1e6)]
    share = reader("assign.roofline_share").read(reading({"passes": [(n, k, d)]}, ev))
    assert share == pytest.approx(50.0)


def test_counters():
    r = reading({"batcher": {"dispatches": 4, "rows_served": 10},
                 "upload_batcher": {"batches": 2, "rows": 30},
                 "boot": {"source": "sql", "rows": 5, "sql_s": 1.0, "pack_s": 0.5}}, [])
    assert reader("batcher.rows_per_dispatch").read(r) == 2.5
    assert reader("upload.rows_per_batch").read(r) == 15
    assert reader("boot.total_s").read(r) == 1.5
    empty = reading({"batcher": {"dispatches": 0, "rows_served": 0}}, [])
    assert reader("batcher.rows_per_dispatch").read(empty) is None
    assert reader("device.idle_share.search").read(empty) is None


def test_breakdown():
    ev = [Event(SCAN, KERNEL, 0, 100), Event(SCAN, KERNEL, 300, 400),
          Event("Memcpy DtoH (Device -> Pageable)", MEMCPY, 1000, 1100)]
    host = [Event("aten::sort", "host", 90, 350), Event("outer", "host", 0, 2000)]
    tr = Trace(ev, host)
    assert tr.device_ops()[0] == ["grouped_scores_kernel", pytest.approx(2e-4)]
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::sort"] == pytest.approx(2e-4)
    assert gaps["outer"] == pytest.approx(6e-4)
    assert short_name("void ns::f<a<b>>(int*)") == "ns::f"
