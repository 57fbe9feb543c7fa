"""What the port's measuring tools share: the card's name, a CUDA-event
timer, the profiler's device events and one reduction of them.

The scripts beside this file and ``chip_smoke.py`` take these from here
and from nowhere else.  Nothing here imports the benchmark harness
(``benchmark/``, which keeps its own frozen copies) or jax.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

import torch

PROFILE_TRIES = 3
NOT_MEASURED = (f"device time not measured (the profiler recorded no device event in "
                f"{PROFILE_TRIES} sessions)")


def cards() -> list:
    """Each GPU's name and power limit, as nvidia-smi prints them, one line a card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()


def card() -> str:
    """The first GPU's name and power limit."""
    return cards()[0]


def timed(fn, spans: list):
    """fn with each call between two CUDA events on the current stream; a
    call appends its (start, end) pair to ``spans``."""
    def run(*args, **kwargs):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = fn(*args, **kwargs)
        e1.record()
        spans.append((e0, e1))
        return out
    return run


def _calls(fn, n: int):
    """fn(0), ..., fn(n - 1) as one call; each result is dropped at once, so
    the allocator can reuse its memory."""
    def run():
        for i in range(n):
            fn(i)
    return run


def event_ms(fn, reps: int, warmup: int = 2) -> float:
    """CUDA-event ms a call of fn(i), over reps calls after warmup calls."""
    _calls(fn, warmup)()
    torch.cuda.synchronize()
    spans = []
    timed(_calls(fn, reps), spans)()
    e0, e1 = spans[0]
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def device_busy(events) -> tuple:
    """(union, sum) in seconds of the device events' time ranges."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    union, lo, hi = 0, None, None
    for s, e in spans:
        if hi is None or s > hi:
            union += 0 if hi is None else hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    union += 0 if hi is None else hi - lo
    return union / 1e6, sum(e - s for s, e in spans) / 1e6


def device_events(fn, tries: int = PROFILE_TRIES) -> tuple:
    """fn() under torch.profiler, then a device sync -> (the device events,
    the host-clock seconds of the traced call).  Now and then a session
    late in a long process records no device event at all (CUPTI hands
    none over; seen on an H100); such a session is run again in a new one,
    up to ``tries`` sessions.  After those the events are [] and the caller
    reports the device time as not measured, or times by CUDA events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for session in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events:
            return events, wall
        print(f"profiler session {session} of {tries} recorded no device event",
              file=sys.stderr, flush=True)
    return [], wall


def kernel_name(name: str) -> str:
    """A device event's name without namespaces, template arguments and
    parameters (copies keep theirs, e.g. "Memcpy HtoD (Pinned -> Device)")."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip()


@dataclasses.dataclass(frozen=True)
class Profile:
    """What the device did in a traced run of ``calls`` calls; each figure
    is a call's."""

    wall_ms: float  # the host clock over the run, to its closing sync
    busy_ms: float  # the union of the device events' spans
    summed_ms: float  # their sum: overlapping spans count twice
    events: float  # device events: kernels, copies and sets
    kernels: float  # device kernels
    by_kernel: dict  # kernel_name -> (events, device ms)

    @property
    def idle_share(self) -> float:
        return 1 - self.busy_ms / self.wall_ms


def profile(fn, calls: int = 1, keys=None, tries: int = PROFILE_TRIES):
    """fn(i) for i < ``calls`` under the profiler -> a Profile of the device
    events, or of those whose names hold one of ``keys``; None where no
    session recorded a device event (``device_events``: ranks whose calls
    meet in collectives take one session, ``tries=1``, so that no rank runs
    them again alone)."""
    events, wall = device_events(_calls(fn, calls), tries)
    if not events:
        return None
    if keys is not None:
        events = [e for e in events if any(k in e.name for k in keys)]
    busy, summed = device_busy(events)
    totals = {}
    for e in events:
        n, us = totals.get(kernel_name(e.name), (0, 0))
        totals[kernel_name(e.name)] = (n + 1, us + e.time_range.end - e.time_range.start)
    return Profile(
        wall_ms=wall * 1e3 / calls, busy_ms=busy * 1e3 / calls, summed_ms=summed * 1e3 / calls,
        events=len(events) / calls,
        kernels=sum(not e.name.startswith(("Memcpy", "Memset")) for e in events) / calls,
        by_kernel={k: (n / calls, us / 1e3 / calls) for k, (n, us) in totals.items()})


def load_package(root: Path, name: str):
    """``rust_seq2kminmers_torch`` of the checkout at ``root``, imported as
    ``name`` (its modules import each other relatively), so that two
    versions run on one card in one process."""
    pkg_dir = root / "rust_seq2kminmers_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg_dir / "__init__.py", submodule_search_locations=[str(pkg_dir)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module
