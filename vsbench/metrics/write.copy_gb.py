"""Gigabytes an index write copies: the program's counters
`ivf.copied_bytes` (the device and host arrays `IVFIndex.insert` copies)
over `ivf.inserts` in the traced window (vsbench/spans.py), in 1e9
bytes. A program without the counters gives none: None."""

from vsbench import spans


def read(r):
    c = spans.counters()
    if not c.get("ivf.inserts") or "ivf.copied_bytes" not in c:
        return None
    return c["ivf.copied_bytes"] / c["ivf.inserts"] / 1e9
