"""The program's span table, for readers of spans that several threads
record at once.

`profiling.snapshot()["spans"]` (vectorsearch_tpu_torch/utils/profiling.py)
holds each span's count, seconds and thread CPU seconds, summed over every
thread that recorded it while a profiler recorded: in a traced run, the
window. vsbench/spans.py takes a span's children from the trace by time,
which holds where one thread calls the program; a served cell calls it
from the router's event loop thread and from executor threads whose
requests overlap, and the window's profiler keeps the host events of its
own thread alone. So these readers sum durations from the table and
subtract nothing nested in time. A program without the spans (an older
commit) gives an empty table, and each reader then returns None.
"""
from __future__ import annotations


def table() -> dict:
    """{span name: {"count", "seconds", "cpu_s"}} over the traced window
    ({} where the program keeps no table)."""
    try:
        from vectorsearch_tpu_torch.utils import profiling
    except ImportError:
        return {}
    snapshot = getattr(profiling, "snapshot", None)
    return snapshot()["spans"] if snapshot else {}


def per(names, over: str):
    """Summed seconds of the spans `names` over the count of the span
    `over`; None where the table lacks any of them."""
    t = table()
    if not t.get(over, {}).get("count") or any(n not in t for n in names):
        return None
    return sum(t[n]["seconds"] for n in names) / t[over]["count"]
