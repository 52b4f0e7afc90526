"""Milliseconds a batched search (`Engine.search_many`) spends on its
per-row work on the host: the summed durations of the spans `engine.pages`
(each row's dedup over the doc map, rows that fall back to the escalating
window included) and `engine.hits` (the hits assembled after the SQL
fetch) over the count of `engine.search_many` spans, from the program's
span table (vsbench/span_sums.py: summed, nothing nested subtracted, as
the executor threads' calls overlap)."""

from vsbench import span_sums


def read(r):
    if r.trace is None:
        return None
    ms = span_sums.per(("engine.pages", "engine.hits"), "engine.search_many")
    return None if ms is None else ms * 1e3
