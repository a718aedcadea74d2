"""query_p50_s: the median latency of every query sent in
the window, from its scheduled send time to its answer."""
from harness.stats import latencies, percentile


def read(run):
    xs = latencies(run)
    return percentile(xs, 50) if xs else None
