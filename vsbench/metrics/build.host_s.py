"""Seconds of a build that are neither its upload nor a Lloyd's pass:
each `build_centroids` span (`vs::build`) less the time its
`vs::build.upload` and `vs::kmeans.pass` spans cover (vsbench/spans.py),
averaged over the builds: the host's gathers, scans and reads between
passes."""

from vsbench import spans


def read(r):
    if r.trace is None:
        return None
    builds = spans.split_s(r.trace, "build", ("build.upload", "kmeans.pass"))
    if not builds:
        return None
    return sum(t - c for t, c in builds) / len(builds)
