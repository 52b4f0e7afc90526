"""Share of the traced search window in which no operation ran on the
card: 100 * (1 - union of the device's kernel, copy and fill intervals /
window)."""


def read(r):
    if r.trace is None or not r.trace.device:
        return None
    return 100.0 * (1.0 - r.trace.union_s() / r.window_s)
