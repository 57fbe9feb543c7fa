"""Overflow reruns of the window's ``kminmers_batch`` calls, from the
program's spans: 100 x ``batch.rescue`` spans / ``batch.call`` roots, in
%.  The cells' traffic overflows no capacity, so it reads 0."""

from benchmark.spans import window_calls


def read(run):
    calls = window_calls(run)
    if calls is None:
        return None
    return 100.0 * sum(len(c["batch.rescue"]) for c in calls) / len(calls)
