"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds, for the
tests: the same drivers, readers and comparisons, on the CPU (the
program's plain kernel versions)."""
from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from vsbench import harness

ROOT = Path(__file__).resolve().parents[2]

CONFIG = {"rows": 6000, "dim": 64}
CLUSTERS = {"vdbb-768d1m-engine": 16, "vdbb-768d10m-lib": 24}
TRAFFIC = {
    "http": {"search_clients": 3, "query_pool": 128, "warm": 2, "sample": 48},
    "library": {"batch": 32, "query_pool": 128},
    "build": {"build": {"k": 24, "min_size_div": 10, "max_iters": 4, "superset_iters": 2,
                        "chunk": 2048, "balance_rounds": 1}},
}


# the served cells, whose configuration and traffic files are kept for a
# later PR but which BENCHMARK.json does not hold: their runs spread too
# widely for a bound (PERF.md, Open questions)
UNLISTED = {"d1m-http-c4": ("vdbb-768d1m-engine", "http-closed-c4"),
            "d1m-http-mixed": ("vdbb-768d1m-engine", "http-mixed")}
E2E = {"d1m-http-c4": ["search_qps"],
       "d1m-http-mixed": ["search_p95_ms", "search_qps", "upload_p95_ms"]}
PER_LAYER = {"d1m-http-c4": ["batcher.rows_per_dispatch", "boot.total_s",
                             "device.idle_share.search"],
             "d1m-http-mixed": ["batcher.rows_per_dispatch", "boot.total_s",
                                "upload.rows_per_batch", "device.idle_share.search"]}


def spec_with_unlisted(root: Path = ROOT) -> dict:
    """root's BENCHMARK.json with the served cells added to it, in memory."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "vdbb-768d1m-engine", "source": "-", "reduced": [],
                            "file": "vsbench/configs/vdbb-768d1m-engine.json", "why": "-"})
    for name, (conf, traffic) in UNLISTED.items():
        spec["workloads"].append({"name": name, "config": conf, "traffic": traffic,
                                  "chips": 1, "why": "-"})
    for group, table in (("end_to_end", E2E), ("per_layer", PER_LAYER)):
        have = {m["name"]: m for m in spec[group]}
        for name, metrics in table.items():
            for m in metrics:
                if m not in have:
                    have[m] = {"name": m, "unit": "-", "workloads": []}
                    spec[group].append(have[m])
                have[m].setdefault("workloads", []).append(name)
    return spec


def cell(name: str, seed: int = 5, seconds: int = 1, trace: bool = False, root: Path = ROOT,
         **traffic) -> harness.Cell:
    """`name`'s cell of root's BENCHMARK.json (or a served cell) at the tiny
    size, on the CPU."""
    spec = spec_with_unlisted(root) if name in UNLISTED else None
    c = harness.load_cell(name, seed, seconds, trace, torch.device("cpu"), root, spec)
    c.config.update(CONFIG, clusters=CLUSTERS.get(c.config["name"], 16))
    c.traffic.update(TRAFFIC.get(c.traffic["driver"], {}))
    c.traffic.update(traffic)
    return c


def run(c: harness.Cell, with_control: bool = False):
    """(result, checks, control's checks or None) of one tiny run."""
    return harness.run_cell(c, time.perf_counter(), with_control)
