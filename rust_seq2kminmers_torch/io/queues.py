"""Hand-offs between a producer thread and its consumer that never block
for good: each waits in short slices and gives up once the run's stop
event is set.  Used by the streaming runner (``io/stream.py``) and the
long-read staging (``ops/long_read.py``)."""

from __future__ import annotations

import queue
import threading

POLL_S = 0.1  # how often a blocked producer checks for a stop


def put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Put ``item`` into ``q`` -> True, or False once ``stop`` is set."""
    while not stop.is_set():
        try:
            q.put(item, timeout=POLL_S)
            return True
        except queue.Full:
            pass
    return False


def get(q: queue.Queue, stop: threading.Event):
    """The next item of ``q``, or None once ``stop`` is set."""
    while not stop.is_set():
        try:
            return q.get(timeout=POLL_S)
        except queue.Empty:
            pass
    return None
