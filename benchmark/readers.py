"""Arithmetic that several metric readers share."""

from __future__ import annotations

from typing import Iterable, Optional


def window_gbps(run) -> Optional[float]:
    """All bases of all steps completed in the window over the window's
    wall, in GB/s."""
    if not run.steps or run.window_s <= 0:
        return None
    return run.bases / run.window_s / 1e9


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all values, interpolated linearly
    between the two nearest ranks."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def idle_share(run) -> Optional[float]:
    """100 x (1 - the device's busy union / the traced window)."""
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline(run, bound_key: str, kernels: Iterable[str]) -> Optional[float]:
    """100 x the kernels' least time over their device time in the trace;
    None where the trace holds none of them."""
    t = run.trace
    if t is None or not run.counters.get(bound_key):
        return None
    device_s = sum(t.kernel_s.get(name, 0.0) for name in kernels)
    if device_s <= 0:
        return None
    return 100.0 * run.counters[bound_key] / device_s

