"""Host milliseconds of a library search call that are not waits on the
card: each `IVFIndex.search` span (`vs::ivf.search`) less the time its
`vs::ivf.sync` spans cover (vsbench/spans.py), averaged over the calls."""

from vsbench import spans


def read(r):
    if r.trace is None:
        return None
    calls = spans.split_s(r.trace, "ivf.search", ("ivf.sync",))
    if not calls:
        return None
    return sum(t - w for t, w in calls) / len(calls) * 1e3
