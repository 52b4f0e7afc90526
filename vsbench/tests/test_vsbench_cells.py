"""Each driver at a tiny size on the CPU, through the harness: the result
line's keys, the metrics of each mode, and `correct` true."""
import json

import pytest

from vsbench import harness
from vsbench.tests import tiny

CELLS = ["d1m-http-c4", "d10m-lib-b512-np8", "d10m-build", "d1m-http-mixed"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run(name, trace):
    c = tiny.cell(name, seed=2**31 + 17, seconds=1, trace=trace)
    result, check, _ = tiny.run(c)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert result["correct"], check
    assert result["attempted"] > 0 and result["failed"] == 0
    want = {m["name"] for m in c.metrics("per_layer" if trace else "end_to_end")}
    if trace:  # no device on the CPU: only the counters and spans read
        assert set(result["metrics"]) <= want
        assert result["device"]["window_s"] > 0
        assert {"device_ops", "idle_gaps"} <= set(result["breakdown"])
    else:
        assert set(result["metrics"]) == want
        assert all(v["value"] > 0 for v in result["metrics"].values())
    json.dumps(result)


def test_counters_read_on_the_cpu():
    c = tiny.cell("d1m-http-mixed", seconds=1, trace=True)
    result, _, _ = tiny.run(c)
    for name in ("batcher.rows_per_dispatch", "boot.total_s", "upload.rows_per_batch"):
        assert result["metrics"][name]["value"] > 0


def test_same_seed_same_inputs():
    """Two runs of one seed get the same queries and the same rows."""
    import numpy as np

    from vsbench.drivers import library

    a = library.make_inputs(tiny.cell("d10m-lib-b512-np8", seed=99))
    b = library.make_inputs(tiny.cell("d10m-lib-b512-np8", seed=99))
    c = library.make_inputs(tiny.cell("d10m-lib-b512-np8", seed=100))
    assert all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))
    assert np.array_equal(a[4], b[4]) and not np.array_equal(a[4], c[4])


def test_finish_prints_checks_last(capsys):
    result = {"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {}}
    check = {"sim_err": {"value": float("inf"), "limit": 1e-5}}
    assert harness.finish(result, check, {}) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and line["checks"]["sim_err"]["value"] == 1e300
    assert err.strip().splitlines()[-1].startswith("check sim_err:")
