"""Tracing / profiling utilities (counterpart of
vectorsearch_tpu/utils/profiling.py).

Per-request timing logs (`timed`, beside logger.next_txid and the engine's
logs), device-level tracing through torch.profiler (Chrome traces that
chrome://tracing or Perfetto open), and per-card memory statistics for
/api/stats.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

from ..logger import sugar


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block with torch.profiler (host ops, and the card's
    kernels when there is a CUDA card) and write a Chrome trace into
    log_dir."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(
            log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"
        )
        prof.export_chrome_trace(path)
        sugar().info("device trace written to %s", path)


@contextlib.contextmanager
def timed(label: str):
    """Wall-time a block at info level (reference logs per-request ms,
    server/search.go:111)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sugar().info("%s took %.1fms", label, (time.perf_counter() - t0) * 1e3)


def device_memory_stats() -> list[dict]:
    """Memory of each visible CUDA card (the caching allocator's counters
    and the driver's free/total bytes); [] where there is no card."""
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        stats = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i}",
            "name": torch.cuda.get_device_name(i),
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
            "bytes_free": free,
            "bytes_limit": total,
        })
    return out
