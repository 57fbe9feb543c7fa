"""The host's work on a ``kminmers_batch`` call after the card finished
it, from the program's spans: the median over the window's calls of the
time from the end of its last ``batch.wait`` (the first fetch, which waits
for the card) to the end of ``batch.call`` (the second fetch and the
overflow comparison), in us."""

import statistics

from benchmark.spans import check_ns, window_calls


def read(run):
    calls = window_calls(run)
    checked = [check_ns(c) for c in calls or ()]
    checked = [t for t in checked if t is not None]
    return statistics.median(checked) / 1e3 if checked else None
