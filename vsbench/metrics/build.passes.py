"""Lloyd's passes a build runs (superset, main, drop-small, balance and
its sub-builds): the program's counter `kmeans.passes` in the traced
window over the window's builds (vsbench/spans.py)."""

from vsbench import spans


def read(r):
    builds = r.outcome.layer.get("builds")
    passes = spans.counters().get("kmeans.passes")
    if not builds or passes is None:
        return None
    return passes / builds
