"""The grouped scan's share of its roofline: the least time the card
could take for the window's scans, counted from the algorithm
(vsbench/roofline.scan_work: the probed clusters' rows read once, the
queries, the top-k written; 2 * D operations a (query, probed row) at the
bfloat16 peak, the precision of the scan's query), over the profiler's
device time of the kernels named in KERNELS. A later redesign that fuses
or renames the scan adds its kernels' names here."""

from vsbench import roofline

KERNELS = ("grouped_scores_kernel",)


def read(r):
    work = r.outcome.layer.get("scan_work")
    if r.trace is None or work is None:
        return None
    t = r.trace.kernel_s(KERNELS)
    if t <= 0:
        return None
    return 100.0 * roofline.least_s(work[0], work[1], roofline.PEAK_BF16_PER_S) / t
