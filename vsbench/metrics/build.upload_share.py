"""Share of the build window the card spent copying from the host (the
profiler's host-to-device copies, summed): the rows' upload that opens
every build."""


def read(r):
    if r.trace is None or not r.trace.device:
        return None
    up = r.trace.time_s(lambda e: e.kind == "memcpy" and "HtoD" in e.name)
    return 100.0 * up / r.window_s
