"""The device trace of a measured window: ``torch.profiler`` with CUDA
activity, reduced to what the per-layer readers take.

The device is busy where one of its kernels, copies or sets runs; busy
time is the union of those intervals (``device_busy``), so overlapping
work counts once.  Each idle gap is named by the CUDA runtime call that the
host was in at the gap's middle, or "host code" where it was in none.
A session now and then records no device event at all (seen on an H100
late in a long process): the caller runs the window again, up to
``TRIES`` sessions.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import sys
from typing import Callable, Dict, List, Optional, Tuple

TRIES = 3
TOP = 10


@dataclasses.dataclass
class DeviceTrace:
    window_s: float  # the traced window on the host's clock
    busy_s: float  # union of the device's intervals
    kernel_s: Dict[str, float]  # device seconds by full kernel name
    device_ops: List[Tuple[str, float]]  # the ops that took most time
    idle_gaps: List[Tuple[str, float]]  # idle seconds by what the host was in


def device_busy(spans: List[Tuple[int, int]]) -> Tuple[int, List[Tuple[int, int]]]:
    """(union length, the union's intervals in order) of [start, end) spans."""
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return sum(e - s for s, e in merged), merged


def session_events(prof):
    """(device spans [(name, start_ns, end_ns)], host runtime calls
    [(start_ns, end_ns, name)]) of a finished profiler session."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            device.append((e.name(), start, end))
        elif e.name().startswith("cuda"):
            host.append((start, end, e.name()))
    return device, host


def name_gaps(merged, host, t0: int, t1: int) -> Dict[str, float]:
    """Idle seconds in [t0, t1) by the runtime call that covers each gap's
    middle ("host code" where none does)."""
    host = sorted(host)
    starts = [h[0] for h in host]
    gaps = collections.Counter()
    edges = [t0] + [x for s, e in merged for x in (s, e)] + [t1]
    for lo, hi in zip(edges[0::2], edges[1::2]):
        if hi <= lo:
            continue
        mid = (lo + hi) // 2
        i = bisect.bisect_right(starts, mid) - 1
        # The latest call that starts before mid; calls do not nest here.
        label = host[i][2] if i >= 0 and host[i][1] >= mid else "host code"
        gaps[label] += (hi - lo) / 1e9
    return dict(gaps)


def reduce(device, host, wall_s: float) -> DeviceTrace:
    """The trace of a window of ``wall_s`` host seconds; its gaps run from
    the first event the session recorded to the last."""
    busy, merged = device_busy([(s, e) for _, s, e in device])
    t0 = min([s for _, s, _ in device] + [s for s, _, _ in host])
    t1 = max([e for _, _, e in device] + [e for _, e, _ in host])
    by_name = collections.Counter()
    for name, s, e in device:
        by_name[name] += (e - s) / 1e9
    gaps = name_gaps(merged, host, t0, t1)
    return DeviceTrace(
        window_s=wall_s,
        busy_s=busy / 1e9,
        kernel_s=dict(by_name),
        device_ops=by_name.most_common(TOP),
        idle_gaps=collections.Counter(gaps).most_common(TOP),
    )


def traced(window: Callable[[], float]) -> Optional[DeviceTrace]:
    """Run ``window()`` (-> its wall seconds) under the profiler; -> the
    reduced trace, or None where no session recorded a device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for session in range(1, TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall_s = window()
            torch.cuda.synchronize()
        device, host = session_events(prof)
        if device:
            return reduce(device, host, wall_s)
        print(f"profiler session {session} of {TRIES} recorded no device event",
              file=sys.stderr, flush=True)
    return None
