"""The k-means assign kernel's share of its roofline: for every Lloyd's
pass of the window (rows, K, D, recorded where the build hands a pass its
rows and centroids), the least time for its work (2 * D operations a
(row, centroid) at the bfloat16 peak, the precision of the centroids it
compares; or the rows' codes and sidecars read once), summed, over the
profiler's device time of the kernels named in KERNELS."""

from vsbench import roofline

KERNELS = ("kmeans_assign_kernel",)


def read(r):
    passes = r.outcome.layer.get("passes")
    if r.trace is None or not passes:
        return None
    t = r.trace.kernel_s(KERNELS)
    if t <= 0:
        return None
    least = sum(roofline.least_s(n * (d + roofline.SIDE_BYTES) + k * d * 2,
                                 roofline.assign_ops(n, k, d), roofline.PEAK_BF16_PER_S)
                for n, k, d in passes)
    return 100.0 * least / t
