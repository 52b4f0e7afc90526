"""Milliseconds a served request spends in JSON on the router's event loop
thread: the summed durations of the spans `http.parse` (the request body
read and parsed) and `http.encode` (the response dumped, and compressed
where the client asks) over the count of `http.request` spans, from the
program's span table (vsbench/span_sums.py: summed, nothing nested
subtracted, as requests overlap)."""

from vsbench import span_sums


def read(r):
    if r.trace is None:
        return None
    ms = span_sums.per(("http.parse", "http.encode"), "http.request")
    return None if ms is None else ms * 1e3
