"""Milliseconds an index write takes: each `IVFIndex.insert` span
(`vs::ivf.insert`) of the traced window (vsbench/spans.py), averaged over
the writes. A program without the span gives none: None."""

from vsbench import spans


def read(r):
    if r.trace is None:
        return None
    writes = spans.named(r.trace, "ivf.insert")
    if not writes:
        return None
    return sum(e.end - e.start for e in writes) / len(writes) / 1e3
