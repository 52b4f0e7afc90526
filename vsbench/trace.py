"""The measured window, and with --trace 1 its device trace.

`Window` brackets the measured seconds on the host clock. Traced, it runs
`torch.profiler` (CPU and CUDA activities) over exactly those seconds and
reduces the profile to a `Trace`: the device's operations (kernels,
copies, fills) and the host's torch operations, each a (name, start,
end) in microseconds. The per-layer readers (vsbench/metrics) take their
numbers from a Trace; the tests build one from a recorded event list.
"""
from __future__ import annotations

import bisect
import re
import time
from dataclasses import dataclass, field

KERNEL, MEMCPY, MEMSET = "kernel", "memcpy", "memset"


@dataclass(frozen=True)
class Event:
    name: str
    kind: str  # KERNEL, MEMCPY or MEMSET on the device; "host" on the CPU
    start: float  # microseconds
    end: float


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters: `void ns::foo_kernel<8>(int*)` -> `ns::foo_kernel`."""
    s = re.sub(r"^void ", "", name.strip())
    depth, out = 0, []
    for ch in s:
        if ch in "<(":
            if depth == 0 and ch == "(":
                break
            depth += 1 if ch == "<" else 0
            continue
        if ch == ">" and depth:
            depth -= 1
            continue
        if depth == 0:
            out.append(ch)
    return "".join(out).strip() or name


def device_kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return MEMCPY
    if low.startswith("memset"):
        return MEMSET
    return KERNEL


@dataclass
class Trace:
    device: list = field(default_factory=list)  # Events on the device
    host: list = field(default_factory=list)  # Events on the host

    def union_s(self, kinds=(KERNEL, MEMCPY, MEMSET)) -> float:
        """Seconds in which at least one device operation of `kinds` ran."""
        spans = sorted((e.start, e.end) for e in self.device if e.kind in kinds)
        total, cur_s, cur_e = 0.0, None, None
        for s, e in spans:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total / 1e6

    def time_s(self, match) -> float:
        """Summed device seconds of the operations whose name `match` accepts."""
        return sum(e.end - e.start for e in self.device if match(e)) / 1e6

    def kernel_s(self, names) -> float:
        """Summed seconds of the kernels whose name holds one of `names`."""
        return self.time_s(lambda e: e.kind == KERNEL and any(n in e.name for n in names))

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        by = {}
        for e in self.device:
            key = short_name(e.name) if e.kind == KERNEL else e.name
            by[key] = by.get(key, 0.0) + (e.end - e.start) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10, scan: int = 64) -> list:
        """[label, seconds]: the device's idle time inside the traced span,
        summed by what the host was doing at each gap's middle (the
        innermost host torch operation open there, or `no torch op`)."""
        spans = sorted((e.start, e.end) for e in self.device)
        if not spans:
            return []
        host = sorted(self.host, key=lambda e: e.start)
        starts = [e.start for e in host]
        by = {}
        cur_e = spans[0][1]
        for s, e in spans[1:]:
            if s > cur_e:
                mid = (cur_e + s) / 2
                i = bisect.bisect_right(starts, mid)
                inner = None
                for h in host[max(0, i - scan) : i]:
                    if h.end >= mid and (inner is None or h.end - h.start < inner.end - inner.start):
                        inner = h
                label = inner.name if inner else "no torch op"
                by[label] = by.get(label, 0.0) + (s - cur_e) / 1e6
            cur_e = max(cur_e, e)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def from_profiler(prof) -> Trace:
    """A Trace of a finished torch.profiler.profile."""
    from torch.autograd import DeviceType

    tr = Trace()
    for ev in prof.profiler.kineto_results.events():
        start, end = ev.start_ns() / 1e3, ev.end_ns() / 1e3
        if ev.device_type() == DeviceType.CUDA:
            tr.device.append(Event(ev.name(), device_kind(ev.name()), start, end))
        elif ev.device_type() == DeviceType.CPU and end > start:
            tr.host.append(Event(ev.name(), "host", start, end))
    return tr


TRACE_CAP_S = 20  # the longest traced window: the trace's reading stays short


class Window:
    """Brackets the measured window: start() and stop() on the host clock,
    and with trace=True the profiler over exactly that span, which lasts at
    most TRACE_CAP_S seconds (the per-layer readers take ratios, which a
    shorter window measures as well)."""

    def __init__(self, trace: bool):
        self.trace_on = trace
        self.t_start = self.t_stop = None
        self.trace: Trace | None = None
        self._prof = None

    def start(self) -> None:
        if self.trace_on:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        self.t_start = time.perf_counter()

    def end(self, seconds: float) -> float:
        """When a window of `seconds` that started at start() closes."""
        return self.t_start + (min(seconds, TRACE_CAP_S) if self.trace_on else seconds)

    def stop(self) -> None:
        self.t_stop = time.perf_counter()
        if self._prof is not None:
            self._prof.__exit__(None, None, None)

    def reduce(self) -> None:
        """Reduce the profile to self.trace (after the window; not timed)."""
        if self._prof is not None:
            self.trace = from_profiler(self._prof)
            self._prof = None

    @property
    def seconds(self) -> float:
        return self.t_stop - self.t_start
