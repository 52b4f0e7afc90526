"""Milliseconds a library search call waits on the card: the time the
`vs::ivf.sync` spans cover inside each `vs::ivf.search` span
(vsbench/spans.py), averaged over the calls."""

from vsbench import spans


def read(r):
    if r.trace is None:
        return None
    calls = spans.split_s(r.trace, "ivf.search", ("ivf.sync",))
    if not calls:
        return None
    return sum(w for _, w in calls) / len(calls) * 1e3
