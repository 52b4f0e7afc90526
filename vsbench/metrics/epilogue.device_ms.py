"""Device milliseconds a library search call spends in every kernel but
the scan's (the probe, the group build, the exact top-k epilogue, the
refine's gather, product and top-k, the id map's copies excluded): the
profiler's kernel time over the window, less the scan kernels', per call."""

from vsbench.trace import KERNEL

SCAN_KERNELS = ("grouped_scores_kernel",)


def read(r):
    calls = r.outcome.layer.get("calls")
    if r.trace is None or not calls:
        return None
    total = r.trace.time_s(lambda e: e.kind == KERNEL)
    if total <= 0:
        return None
    return (total - r.trace.kernel_s(SCAN_KERNELS)) / calls * 1e3
