"""Spans of the port's layers, on the clock of ``torch.profiler``'s events.

A span is a name, a start and an end in ``time.time_ns()``, the id of the
span that encloses it on its thread (its parent; 0 for a root) and the id
of its call: the root span of a public call (``batch.call``,
``long.call``), which every span under it shares.  The profiler stamps
its host and device events on the same clock (CLOCK_REALTIME), so spans
fall on the device trace's timeline.

The recorder records while a ``torch.profiler`` session records on the
calling thread, or inside ``recording()``.  Otherwise ``span`` costs that
one check and returns a shared object that does nothing.  A span's record
is kept when it ends, in a ring of ``CAPACITY`` records that drops the
oldest first and counts what it dropped (``dropped``).  Counts are counts
of spans: a name that marks an event (``step.capture``, ``batch.rescue``)
is counted by its records.

Spans may be taken from any thread.  A thread that works for a call (the
long read's producer) cannot see the profiler's session of the caller's
thread: it is handed the call's id (``current_call()`` on the caller's
thread) and records with ``span(name, call=...)``.  Such a span overlaps
the caller's spans, so it is a root of its own thread and no one's child.

The spans, their places and the metrics that read them are listed in
``PERF.md`` (section 3).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional

from torch._C._autograd import _profiler_enabled

CAPACITY = 1 << 20  # records kept; the oldest go first


class Record(NamedTuple):
    name: str
    start_ns: int  # time.time_ns()
    end_ns: int
    id: int
    parent: int  # the enclosing span's id on this thread; 0 for a root
    call: int  # the id of the call's root span


class _Off:
    """What ``span`` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("_rec", "name", "call", "id", "parent", "start_ns")

    def __init__(self, rec: "Recorder", name: str, call: Optional[int]):
        self._rec, self.name, self.call = rec, name, call

    def __enter__(self):
        stack = self._rec._stack()
        self.id = next(self._rec._ids)
        self.parent = 0
        if self.call is None:
            if stack:
                self.parent, self.call = stack[-1].id, stack[-1].call
            else:
                self.call = self.id
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self._rec._stack().pop()
        self._rec._keep((self.name, self.start_ns, end, self.id, self.parent, self.call))
        return False


class Recorder:
    """Spans kept in memory: ``span(name)`` as a context manager, the
    records by ``spans()`` (oldest first) or ``since(mark)``.  The ring
    holds plain tuples, which the garbage collector stops tracking: a
    window's hundreds of thousands of records would otherwise be scanned
    by every full collection, a pause of ~0.2 s on the card's host."""

    def __init__(self, capacity: int = CAPACITY):
        self.records: collections.deque = collections.deque(maxlen=capacity)
        self.kept = 0  # records ever kept; the ring holds the last of them
        self.forced = 0  # open ``recording()`` blocks
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    def span(self, name: str, call: Optional[int] = None):
        """A span of this thread, under its innermost open span; with
        ``call`` (a thread working for that call, 0 when it was not
        recorded), a root of this thread in that call."""
        if call is None:
            if not (self.forced or _profiler_enabled()):
                return _OFF
        elif not call:
            return _OFF
        return _Span(self, name, call)

    def current_call(self) -> int:
        """The call id of this thread's innermost open span; 0 for none."""
        stack = getattr(self._local, "stack", None)
        return stack[-1].call if stack else 0

    @contextlib.contextmanager
    def recording(self):
        """Record on every thread while the block runs -> a list that
        holds, once the block has ended, the records kept during it."""
        got: List[Record] = []
        mark = self.kept
        self.forced += 1
        try:
            yield got
        finally:
            self.forced -= 1
            got.extend(self.since(mark))

    @property
    def dropped(self) -> int:
        return self.kept - len(self.records)

    def spans(self) -> List[Record]:
        with self._lock:
            return list(map(Record._make, self.records))

    def since(self, mark: int) -> List[Record]:
        """The records kept after ``kept`` read ``mark``, as far as the
        ring still holds them."""
        with self._lock:
            n = min(self.kept - mark, len(self.records))
            return list(map(Record._make, itertools.islice(reversed(self.records), n)))[::-1]

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, record: tuple) -> None:
        with self._lock:
            self.records.append(record)
            self.kept += 1


RECORDER = Recorder()  # the port's recorder, which every layer records into
span = RECORDER.span
current_call = RECORDER.current_call
recording = RECORDER.recording


def self_seconds(records: Iterable[Record]) -> Dict[str, float]:
    """Seconds by span name, each span's duration less its children's (a
    thread's spans nest), names in the order their first span ended."""
    records = list(records)
    inner = collections.Counter()
    for r in records:
        if r.parent:
            inner[r.parent] += r.end_ns - r.start_ns
    out: Dict[str, float] = {}
    for r in records:
        out[r.name] = out.get(r.name, 0.0) + (r.end_ns - r.start_ns - inner[r.id]) / 1e9
    return out
