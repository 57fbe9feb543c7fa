"""The program's spans of a traced window (``rust_seq2kminmers_torch/
tracing.py``), as the API layer's readers take them.

The window's calls are the last ``run.steps`` ``batch.call`` roots that
the recorder holds: ``drivers/resident_batches.py`` makes one
``kminmers_batch`` call a step, and a profiler session that came back
empty and was run again leaves older spans before them.  Each call is its root with every span of its
call id.  A program without the recorder, or a run that recorded no
span (an untraced run, the CPU), gives None.
"""

from __future__ import annotations

import collections
from typing import List, Optional


def window_calls(run) -> Optional[List[dict]]:
    """-> one {span name: [records]} a call of the window, oldest first,
    its root under "batch.call"; None where there are no spans."""
    try:
        from rust_seq2kminmers_torch import tracing
    except ImportError:  # a program that records no spans
        return None
    records = tracing.RECORDER.spans()
    roots = [r for r in records if r.name == "batch.call" and not r.parent]
    if not roots or run.steps <= 0:
        return None
    roots = roots[-run.steps:]
    calls = {r.call: collections.defaultdict(list) for r in roots}
    for r in records:
        if r.call in calls:
            calls[r.call][r.name].append(r)
    return [calls[r.call] for r in roots]


def issue_ns(call) -> Optional[int]:
    """The host's issue of a call: from its start to the end of its last
    ``step.handoff`` (None on a path without a captured step)."""
    if not call["step.handoff"]:
        return None
    return max(r.end_ns for r in call["step.handoff"]) - call["batch.call"][0].start_ns


def check_ns(call) -> Optional[int]:
    """The host's work after the card finished a call: from the end of its
    last ``batch.wait`` to its end."""
    if not call["batch.wait"]:
        return None
    return call["batch.call"][0].end_ns - max(r.end_ns for r in call["batch.wait"])

