"""The program's host share of the traced window, from its spans: 100 x
the sum over the window's calls of their issue and their check (as
``api.issue_us.batch`` and ``api.check_us.batch`` take them) / the
window, in %.  Beside ``device.idle_share.batch`` it says how much of the
device's idle time the program's host side can account for; the rest is
the caller's loop and the launch latency."""

from benchmark.spans import check_ns, issue_ns, window_calls


def read(run):
    calls = window_calls(run)
    if calls is None or run.window_s <= 0:
        return None
    parts = [(issue_ns(c), check_ns(c)) for c in calls]
    host = [i + c for i, c in parts if i is not None and c is not None]
    return 100.0 * sum(host) / 1e9 / run.window_s if host else None
