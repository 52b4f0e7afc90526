"""One run of one cell: set-up, the measured window, the comparison with
the reference, one JSON line.

Everything is found by name, as files: BENCHMARK.json names the cell's
configuration (its `file`) and traffic mix (vsbench/traffic/<traffic>.json);
the traffic file names its driver (vsbench/drivers/<driver>.py); each
per-layer metric is a reader of its own (vsbench/metrics/<name>.py). A new
cell, configuration, traffic mix or metric is new files and entries.

A driver module has
    setup(cell) -> state              inputs, the system, warm-up
    window(state, cell, win) -> Outcome   the measured seconds
    release(state)                    frees the system under test
    answers(state, cell) -> dict      readings of the program's answers
    control(state, cell) -> dict      the same readings of the control
and a metric reader `read(reading) -> float | None`.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from . import checks
from .trace import Window

ROOT = Path(__file__).resolve().parent.parent
# top-level module names that no run may load (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "vectorsearch_tpu")


@dataclass
class Cell:
    name: str
    spec: dict  # BENCHMARK.json
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: int
    trace: bool
    dev: object  # torch.device
    root: Path = ROOT

    def metrics(self, group: str) -> list:
        """The spec's `group` metrics ("end_to_end" or "per_layer") that
        this cell reports."""
        return [m for m in self.spec[group] if self.name in m.get("workloads", [self.name])]


@dataclass
class Outcome:
    attempted: int
    failed: int
    e2e: dict  # end-to-end readings by metric name
    layer: dict = field(default_factory=dict)  # facts the per-layer readers use


@dataclass
class Reading:
    """What a per-layer reader sees: the cell, the window's outcome, its
    length and its trace."""
    cell: Cell
    outcome: Outcome
    window_s: float
    trace: object  # trace.Trace


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, seed: int, seconds: int, trace: bool, dev, root: Path = ROOT,
              spec: dict | None = None) -> Cell:
    """`name`'s cell of root's BENCHMARK.json (or of `spec`)."""
    spec = spec or json.loads((root / "BENCHMARK.json").read_text())
    work = next((w for w in spec["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == work["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "vsbench" / "traffic" / f"{work['traffic']}.json").read_text())
    return Cell(name, spec, work, config, traffic, seed, seconds, trace, dev, root)


def driver_of(cell: Cell):
    d = cell.traffic["driver"]
    return load_module(cell.root / "vsbench" / "drivers" / f"{d}.py", f"vsbench_driver_{d}")


def device_name(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def card_info(dev) -> dict:
    """The card's name and power limit (nvidia-smi), printed beside every
    number of a run."""
    info = {"kind": device_name(dev)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
        info["power_limit"] = out[0] if out else "not read"
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "not read"
    return info


def memory_peak(dev) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def run_cell(cell: Cell, t_process: float, with_control: bool = False):
    """Set-up, window, comparison: (the result line's object, the checks,
    and with_control the control's readings in the program's place)."""
    from vectorsearch_tpu_torch import logger

    logger.configure("warn")  # a line a request would be the run's own cost
    driver = driver_of(cell)
    win = Window(cell.trace)
    state = driver.setup(cell)
    try:
        outcome = driver.window(state, cell, win)
        setup_s = win.t_start - t_process
        peak = memory_peak(cell.dev)
        win.reduce()
    finally:
        driver.release(state)
    gc.collect()
    readings = dict(driver.answers(state, cell))
    readings["failed"] = outcome.failed
    check = checks.with_limits(readings, cell.traffic["checks"])
    ctrl = None
    if with_control:
        ctrl = dict(driver.control(state, cell), failed=0)
        ctrl = checks.with_limits(ctrl, cell.traffic["checks"])

    metrics = {}
    if cell.trace:
        reading = Reading(cell, outcome, win.seconds, win.trace)
        for m in cell.metrics("per_layer"):
            reader = load_module(cell.root / "vsbench" / "metrics" / f"{m['name']}.py",
                                 f"vsbench_metric_{len(metrics)}_{os.getpid()}")
            value = reader.read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.metrics("end_to_end"):
            value = setup_s if m["name"] == "setup_s" else outcome.e2e[m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if cell.dev.type == "cuda" else cell.dev.type,
              "kind": device_name(cell.dev), "count": int(cell.workload["chips"]),
              "memory_peak_bytes": peak}
    result = {"correct": checks.passed(check), "attempted": int(outcome.attempted),
              "failed": int(outcome.failed), "metrics": metrics, "device": device}
    if cell.trace:
        device["busy_s"] = win.trace.union_s() if win.trace else 0.0
        device["window_s"] = win.seconds
        if win.trace:
            result["breakdown"] = {"device_ops": win.trace.device_ops(),
                                   "idle_gaps": win.trace.idle_gaps()}
    return result, check, ctrl


def finish(result: dict, check: dict, extra: dict) -> int:
    """Prints the comparison's numbers last on stderr and the result line
    last on stdout (the checks as its last key); refuses (exit 4, no
    result) where JAX or the JAX package was loaded."""
    found = forbidden_modules()
    if found:
        log(f"vsbench: refused: loaded {', '.join(found)}")
        return 4
    log("vsbench: " + json.dumps(extra))
    for name, c in check.items():
        log(f"check {name}: {checks.printable(c['value'])} (limit {c['limit']})")
    result["checks"] = {k: {"value": checks.printable(c["value"]), "limit": c["limit"]}
                        for k, c in check.items()}
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None, t_process: float | None = None) -> int:
    import argparse

    t_process = time.perf_counter() if t_process is None else t_process
    ap = argparse.ArgumentParser(prog="python3 -m vsbench.run",
                                 description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = ROOT / ".vsbench-cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    import torch

    if not torch.cuda.is_available():
        log("vsbench: no CUDA card: the benchmark runs only on the card")
        return 3
    cell = load_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0))
    if torch.cuda.device_count() < int(cell.workload["chips"]):
        log(f"vsbench: {cell.workload['chips']} cards asked for, "
            f"{torch.cuda.device_count()} present")
        return 3
    result, check, _ = run_cell(cell, t_process)
    extra = {"workload": cell.name, "seed": cell.seed, **card_info(cell.dev)}
    return finish(result, check, extra)
