"""A step of CUDA work captured once as a CUDA graph, then replayed as one
launch: the port's counterpart of what ``jax.jit`` gives the reference
package.

A jitted JAX step is one dispatch of one compiled program.  The port's
eager step enqueues its ctypes launches and torch ops one by one from
Python, and at [32, 1 Mbp] the host takes about as long to enqueue a
step as the card takes to run it.  ``CapturedStep(fn, inputs, device)``
records ``fn`` once for these input shapes and dtypes:

  1. static input buffers, filled from ``inputs``;
  2. a warm-up run of ``fn`` on a side stream, which also fills lazy
     device state (the seed tables, the kernels' first load);
  3. a capture of ``fn`` (``torch.cuda.CUDAGraph.capture_begin`` and
     ``capture_end``, as ``torch.cuda.graph`` makes it) into a private
     memory pool, which holds the graph's intermediates and static
     outputs.

Each call then

  1. copies its arguments into the static inputs: the graph reads fixed
     addresses, and the copy makes a call read its own inputs, when it is
     called (32 MB of codes at the main shape);
  2. replays the graph on the caller's current stream;
  3. hands the outputs off in one copy (``Handoff``): the static outputs,
     as bytes, concatenated into one new buffer, returned as views.  The next replay
     overwrites the static outputs, never what an earlier call returned
     (JAX arrays are immutable, and callers hold two batches in flight).

The kernels' launch counters (``build.launches``) count where the kernels
run: the capture's rise is taken back and kept, and every replay adds it.
Spans (``tracing.py``): a call's ``step.inputs`` (checks, stream, input
copies), ``step.replay`` and ``step.handoff``; a compiled step's
``step.key`` (the key and its lookup) and, for a new key,
``step.capture`` (warm-up and capture).

A capture that fails raises; nothing falls back to the eager step.  The
capture keeps the default ``capture_error_mode="global"``: no
other thread may make an unsafe CUDA call (a pinned allocation, a
synchronising copy) while it runs, so a caller with worker threads that
touch CUDA captures before they start.  The event queries of NCCL's
watchdog thread are not such calls on CUDA, so the collectives' steps
capture in this mode too.  A ``CapturedStep`` is not thread-safe; its
owner serialises calls.

``CompiledStep(fn)`` keys its captured steps as ``jax.jit`` keys its
executables, by the inputs' shapes and dtypes, and answers a key's first
call with the warm-up's outputs: the warm-up is that call's run of
``fn``, the capture only records, and each later call replays.  So every
call runs ``fn``'s work exactly once, and a step whose ``fn`` holds NCCL
collectives issues them once a call on every rank, whichever rank
captures a new key (``parallel/driver.py``, ``parallel/seqshard.py``).
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Sequence

import torch

from ... import tracing
from . import build

# Captured steps a CompiledStep keeps; past it the least recently used key
# goes, with its graph's memory pool.  chip_smoke.py's phases meet at most
# 6 keys a spec and the file runner on its ~0.5 Gbp cell at most 5 a spec.
MAX_GRAPHS = 16


class CapturedStep:
    """``fn(*inputs)`` -> a sequence of tensors, captured for the shapes,
    dtypes and device of ``inputs`` (which may be empty: ``fn`` then reads
    only tensors it holds itself, at their fixed addresses).  Calling the
    step with tensors of those shapes returns ``fn``'s outputs on them, as
    new tensors."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor], device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {device}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        with torch.cuda.device(device):
            caller = torch.cuda.current_stream(device)
            self._inputs = [torch.empty(x.shape, dtype=x.dtype, device=x.device)
                            for x in inputs]
            for static, x in zip(self._inputs, inputs):
                static.copy_(x)
            side = torch.cuda.Stream(device)
            side.wait_stream(caller)
            with torch.cuda.stream(side):
                warm = tuple(fn(*self._inputs))
            caller.wait_stream(side)
            for t in warm:  # read on the caller's stream, allocated on the side's
                t.record_stream(caller)
            self._warm = warm
            self.graph = torch.cuda.CUDAGraph()
            # The capture ``torch.cuda.graph`` makes, on the warm-up's stream,
            # without what that context does first: synchronise the device
            # and empty the allocator's caches, device and pinned host, which
            # made a capture at a small shape cost ~20 ms (PERF.md, PR 10).
            with build.counted_as_captured() as self.launches, torch.cuda.stream(side):
                self.graph.capture_begin(capture_error_mode="global")
                try:
                    outs = [o.contiguous() for o in fn(*self._inputs)]
                finally:
                    self.graph.capture_end()
        self._handoff = Handoff(outs)
        self._stream = caller

    def take_warmup(self) -> tuple:
        """The warm-up's outputs, ``fn``'s answer for the inputs the step
        was made with; the first call returns them, later ones None."""
        warm, self._warm = self._warm, None
        return warm

    def __call__(self, *inputs: torch.Tensor) -> tuple:
        with tracing.span("step.inputs"):
            if len(inputs) != len(self._inputs):
                raise TypeError(f"expected {len(self._inputs)} inputs, got {len(inputs)}")
            for i, (static, x) in enumerate(zip(self._inputs, inputs)):
                if (x.shape != static.shape or x.dtype != static.dtype
                        or x.device != static.device):
                    raise ValueError(
                        f"input {i}: captured for {static.dtype}{list(static.shape)} on "
                        f"{static.device}, got {x.dtype}{list(x.shape)} on {x.device}")
            stream = torch.cuda.current_stream(self.device)
            if stream != self._stream:  # the last call's handoff must be read first
                stream.wait_stream(self._stream)
                self._stream = stream
            for static, x in zip(self._inputs, inputs):
                static.copy_(x)
        with tracing.span("step.replay"):
            self.graph.replay()
            build.launches.update(self.launches)
        with tracing.span("step.handoff"):
            return self._handoff()


class CompiledStep:
    """``fn(*inputs) -> a sequence of tensors`` compiled for CUDA inputs:
    one ``CapturedStep`` per key (device, each input's shape and dtype),
    made on the key's first call, which it answers with the warm-up's
    outputs, or ahead of that call by ``capture``.  Later calls replay.
    At most ``MAX_GRAPHS`` keys are kept, the least recently used dropped
    first.  Calls are serialised by a lock.  ``graphs`` holds the
    captured steps, oldest first; dropping the object frees their memory
    pools."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def __call__(self, *inputs: torch.Tensor) -> tuple:
        with self._lock:
            step, warm = self._step(inputs)
            return tuple(warm) if warm is not None else step(*inputs)

    def capture(self, *inputs: torch.Tensor) -> None:
        """Capture the key of these CUDA inputs now, unless it exists: ahead
        of a run whose threads must not meet a capture.  Runs ``fn`` once,
        as the warm-up."""
        with self._lock:
            self._step(inputs)

    def _step(self, inputs) -> tuple:
        """-> (the key's step, the warm-up's outputs if it was made now)."""
        with tracing.span("step.key"):
            key = (inputs[0].device, *((tuple(x.shape), x.dtype) for x in inputs))
            step = self.graphs.get(key)
            if step is not None:
                self.graphs.move_to_end(key)
                return step, None
        with tracing.span("step.capture"):
            step = self.graphs[key] = CapturedStep(self.fn, inputs, inputs[0].device)
        while len(self.graphs) > MAX_GRAPHS:
            self.graphs.popitem(last=False)
        return step, step.take_warmup()


class Handoff:
    """Copies a fixed list of contiguous tensors (a graph's static outputs)
    into one new buffer, in one copy, and returns them as views of it, in
    their order, dtypes and shapes.

    The bytes are grouped by dtype and shape, widest elements first, so
    that every group starts at a multiple of its element size; a call views
    each group once as [n, *shape] and unbinds it, which costs the host
    less than one view per tensor."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        if not tensors:
            raise ValueError("nothing to hand off")
        groups: dict = {}
        for i, t in enumerate(tensors):
            if not t.is_contiguous():
                raise ValueError(f"tensor {i} is not contiguous")
            groups.setdefault((-t.element_size(), str(t.dtype), tuple(t.shape)), []).append(i)
        self._bytes, self._groups, self._pick, at = [], [], [None] * len(tensors), 0
        for key in sorted(groups):
            members = groups[key]
            t = tensors[members[0]]
            nbytes = len(members) * t.numel() * t.element_size()
            self._groups.append((at, at + nbytes, t.dtype, (len(members), *t.shape)))
            at += nbytes
            for j, i in enumerate(members):
                self._bytes.append(tensors[i].view(-1).view(torch.uint8))
                self._pick[i] = (len(self._groups) - 1, j)

    def __call__(self) -> tuple:
        flat = torch.cat(self._bytes)
        groups = [flat[a:b].view(dtype).view(shape).unbind(0)
                  for a, b, dtype, shape in self._groups]
        return tuple(groups[g][j] for g, j in self._pick)
