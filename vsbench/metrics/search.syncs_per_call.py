"""Points a library search call waits on the card at: the program's
counters `ivf.syncs` over `ivf.calls` in the traced window
(vsbench/spans.py)."""

from vsbench import spans


def read(r):
    c = spans.counters()
    if not c.get("ivf.calls") or "ivf.syncs" not in c:
        return None
    return c["ivf.syncs"] / c["ivf.calls"]
