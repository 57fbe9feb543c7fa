"""The 95th percentile of every call's latency in the window (call to
outputs complete), in ms; a call that the rescue reruns shows here."""

from benchmark.readers import percentile


def read(run):
    if not run.latencies_s:
        return None
    return 1e3 * percentile(run.latencies_s, 95)
