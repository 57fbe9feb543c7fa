"""CUDA graphs the compiled step captured during the window, from the
program's spans: ``step.capture`` spans of the window's ``kminmers_batch``
calls.  Every shape is captured in the set-up, so it reads 0; a call
that re-keys or re-captures a graph shows here."""

from benchmark.spans import window_calls


def read(run):
    calls = window_calls(run)
    return None if calls is None else float(sum(len(c["step.capture"]) for c in calls))
