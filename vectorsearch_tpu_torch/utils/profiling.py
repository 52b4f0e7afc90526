"""Tracing / profiling utilities (counterpart of
vectorsearch_tpu/utils/profiling.py).

Spans and counters inside the program, on the profiler's clock: `span`
and `count` record only while a torch profiler records (the switch is the
profiler itself). Then a span is a host event `vs::<name>` in the
profiler's trace, beside the card's kernels and copies, and each span and
counter also adds to in-memory tables that `snapshot()` returns; with no
profiler they cost one flag test. `device_trace` (the server entry's
`VSTPU_TRACE_DIR`) records a Chrome trace that chrome://tracing or
Perfetto open, and `device_memory_stats` gives each card's memory for
/api/stats.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

from ..logger import sugar

PREFIX = "vs::"

# the txid of the HTTP request the current code serves, which its spans
# carry in their arguments (api/http.py sets it)
TXID: contextvars.ContextVar[int | None] = contextvars.ContextVar("vs_txid", default=None)

_lock = threading.Lock()
_spans: dict[str, list] = {}  # name -> [count, seconds, thread cpu seconds]
_counters: dict = {}  # name -> a number, or a list for append()


def recording() -> bool:
    """True while a torch profiler records, from whichever thread started
    it (the flag torch.profiler sets at its start and clears at its stop)."""
    return _autograd_profiler._is_profiler_enabled


class _Off:
    """The span while no profiler records: one shared object that does
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Span:
    __slots__ = ("name", "_rf", "_t0", "_c0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        txid = TXID.get()
        self._rf = (_RecordFunctionFast(PREFIX + self.name) if txid is None
                    else _RecordFunctionFast(PREFIX + self.name, [], {"txid": txid}))
        self._rf.__enter__()
        self._c0 = time.thread_time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        dc = time.thread_time() - self._c0
        self._rf.__exit__(*exc)
        with _lock:
            row = _spans.setdefault(self.name, [0, 0.0, 0.0])
            row[0] += 1
            row[1] += dt
            row[2] += dc
        return False


def span(name: str):
    """A context manager around one stage of the program. While a profiler
    records it is the host event `vs::<name>` (nested as the code nests;
    inside an HTTP request with the request's txid in its arguments, which
    a trace shows where its profiler records inputs: `record_shapes` on
    the profiling thread) and
    it adds its count, seconds and thread CPU seconds to the span table;
    otherwise it is the shared no-op OFF."""
    return _Span(name) if _autograd_profiler._is_profiler_enabled else OFF


def traced(name: str):
    """Decorate a function so that each call of it is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n=1) -> None:
    """Add n to counter `name` while a profiler records."""
    if _autograd_profiler._is_profiler_enabled:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def append(name: str, item) -> None:
    """Append item to the list counter `name` while a profiler records."""
    if _autograd_profiler._is_profiler_enabled:
        with _lock:
            _counters.setdefault(name, []).append(item)


def snapshot() -> dict:
    """{"spans": {name: {"count", "seconds", "cpu_s"}}, "counters": {name:
    value}}: what the spans and counters recorded since the last reset()."""
    with _lock:
        return {
            "spans": {k: {"count": c, "seconds": s, "cpu_s": u}
                      for k, (c, s, u) in _spans.items()},
            "counters": {k: list(v) if isinstance(v, list) else v
                         for k, v in _counters.items()},
        }


def reset() -> None:
    with _lock:
        _spans.clear()
        _counters.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block with torch.profiler (host ops and the program's
    spans of every thread, and the card's kernels when there is a CUDA
    card) and write a Chrome trace into log_dir. The trace grows with the
    block: it is for a bounded debugging session."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    # every thread's host events: the server's executor threads too, not
    # only the one that starts the profiler
    all_threads = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    prof = profile(activities=activities, experimental_config=all_threads)
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
