"""The host's issue of a ``kminmers_batch`` call, from the program's spans:
the median over the window's calls of the time from ``batch.call``'s start
to the end of its last ``step.handoff`` (the spec's lookup, the compiled
step's key, input checks and copies, the graph's launch and the handoff),
in us."""

import statistics

from benchmark.spans import issue_ns, window_calls


def read(run):
    calls = window_calls(run)
    issued = [issue_ns(c) for c in calls or ()]
    issued = [t for t in issued if t is not None]
    return statistics.median(issued) / 1e3 if issued else None
