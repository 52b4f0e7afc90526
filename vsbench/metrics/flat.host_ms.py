"""Host milliseconds of a flat search call that are not waits on the card:
each `FlatIndex.search` span (`vs::flat.search`) less the time its
`vs::flat.sync` spans cover (vsbench/spans.py), averaged over the calls."""

from vsbench import spans


def read(r):
    if r.trace is None:
        return None
    calls = spans.split_s(r.trace, "flat.search", ("flat.sync",))
    if not calls:
        return None
    return sum(t - w for t, w in calls) / len(calls) * 1e3
