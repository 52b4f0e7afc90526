"""The program's spans and counters, as the per-layer readers take them.

A span is a host event of the Trace named `vs::<name>`
(vectorsearch_tpu_torch/utils/profiling.py opens one where a torch
profiler records), on the device events' clock. The Trace's host events
carry no thread, so a span's children are the spans that lie inside it
in time: the cells that read them call the program from one thread.
The counters come from the program's own table (`profiling.snapshot()`),
which records only while a profiler does: in a traced run, the window.
A program without them (an older commit) gives no spans and no counters,
and each reader then returns None.
"""
from __future__ import annotations

import bisect

PREFIX = "vs::"
NONE = "no program span"


def named(trace, name: str) -> list:
    """The spans `name` of the trace, by start."""
    return sorted((e for e in trace.host if e.name == PREFIX + name), key=lambda e: e.start)


def _covered_us(start: float, end: float, inner: list, starts: list) -> float:
    """Microseconds of [start, end] that the events `inner` (sorted by
    start; `starts` their starts) cover."""
    total, cur_s, cur_e = 0.0, None, None
    for e in inner[bisect.bisect_left(starts, start) : bisect.bisect_right(starts, end)]:
        s, t = max(e.start, start), min(e.end, end)
        if t <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def split_s(trace, name: str, children) -> list:
    """(seconds, seconds covered by the spans `children` inside it) of
    each span `name`."""
    inner = sorted((e for c in children for e in named(trace, c)), key=lambda e: e.start)
    starts = [e.start for e in inner]
    return [((e.end - e.start) / 1e6, _covered_us(e.start, e.end, inner, starts) / 1e6)
            for e in named(trace, name)]


def counters() -> dict:
    """The program's counters over the traced window ({} where the program
    keeps none)."""
    try:
        from vectorsearch_tpu_torch.utils import profiling
    except ImportError:
        return {}
    snapshot = getattr(profiling, "snapshot", None)
    return snapshot()["counters"] if snapshot else {}


def idle_by_span(trace) -> list:
    """[label, seconds]: the device's idle time inside the traced span, by
    the innermost program span open at each gap's middle (NONE where none
    is), however long before the gap it opened. The harness's own
    `Trace.idle_gaps` labels a gap by any host event among the last 64."""
    dev = sorted((e.start, e.end) for e in trace.device)
    if not dev:
        return []
    prog = sorted((e for e in trace.host if e.name.startswith(PREFIX)),
                  key=lambda e: (e.start, -e.end))
    by, stack, i = {}, [], 0  # stack: the spans open, outermost first
    cur_e = dev[0][1]
    for s, e in dev[1:]:
        if s > cur_e:
            mid = (cur_e + s) / 2
            while i < len(prog) and prog[i].start <= mid:
                while stack and stack[-1].end < prog[i].start:
                    stack.pop()
                stack.append(prog[i])
                i += 1
            while stack and stack[-1].end < mid:
                stack.pop()
            label = stack[-1].name[len(PREFIX):] if stack else NONE
            by[label] = by.get(label, 0.0) + (s - cur_e) / 1e6
        cur_e = max(cur_e, e)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])]
