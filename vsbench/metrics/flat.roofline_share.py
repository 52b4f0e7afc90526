"""The flat search's share of its roofline: the least time the card could
take for the window's flat searches, counted from the algorithm
(vsbench/flat_work.py: the live rows read once, the queries read once,
the top k written; 2 * D operations a (query, row) at the int8 peak),
over the profiler's time of every kernel in the window. Every kernel,
because the path's kernels carry generic aten names, and a later route
through other kernels reads the same work."""

from vsbench import flat_work, roofline
from vsbench.trace import KERNEL


def read(r):
    work = r.outcome.layer.get("flat_work")
    if r.trace is None or work is None:
        return None
    t = r.trace.time_s(lambda e: e.kind == KERNEL)
    if t <= 0:
        return None
    return 100.0 * roofline.least_s(work[0], work[1], flat_work.PEAK_INT8_PER_S) / t
