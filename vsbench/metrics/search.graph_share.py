"""Share of the library search calls that replayed a CUDA graph of their
device chain: the program's counters `ivf.graph_replays` over `ivf.calls`
in the traced window (vsbench/spans.py), in percent. A program that keeps
no such graphs replayed none of its calls: 0."""

from vsbench import spans


def read(r):
    c = spans.counters()
    if not c.get("ivf.calls"):
        return None
    return 100.0 * c.get("ivf.graph_replays", 0) / c["ivf.calls"]
