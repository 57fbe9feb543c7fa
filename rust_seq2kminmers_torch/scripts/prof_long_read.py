"""Profiles the long-read path on one NVIDIA GPU: one 300 Mbp random-ACGT
read through ``kminmers_long`` (hpcsimd, l=31, k=5, d=0.01, chunk 2^25),
and with ``--reads 2`` two 150 Mbp reads through ``kminmers_long_batch``.

    python -m rust_seq2kminmers_torch.scripts.prof_long_read [--reads 2] [--parent DIR]
        [--text]

The path runs two ways in turns: with its compiled chunk step (a captured
CUDA graph), and with the eager chunk step (``_compiled_chunk_step``
patched to ``_chunk_step``).  ``--parent DIR`` adds the package of
another checkout (the parent commit, unpacked by ``git archive``),
imported as ``s2k_parent``, on the same read in the same process.
``--text`` adds the same reads given as ASCII strs, which the path stages
as raw bytes and encodes on the card (and, with ``--parent``, the other
checkout's package given those strs).

  1. the memory a capture of the chunk step holds at [1, 2^25] and [2,
     2^25]: ``memory_reserved`` before and after, the cache emptied;
  2. a warm-up call of each way (the kernels' build, the capture);
  3. three host-clock walls of each way's whole call, in turns, staging,
     transfers and assembly included; every call's records equal;
  4. each way of this tree split part by part on the host clock (three
     times), with a sync only where the path itself syncs: the path's
     own ``_Clock`` laps and the producer's fill seconds; phase A's host
     issue is its H2D issue, encode issue and dispatch;
  5. the host's staging alone, as the path does it: ``_Staging._fill``
     into one pinned buffer that was already touched, over every chunk;
  6. one call of each way under ``torch.profiler``: the device's busy
     time is the union of the intervals of its kernels and copies (copies
     on the staging stream overlap the compute stream, so a plain sum
     counts them twice), and the idle share is 1 - busy / wall; then the
     device time of each kernel and copy, summed by name.

Prints the card's name and power limit first.  Needs a GPU: without one it
exits with an error and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import importlib.util
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..ops.long_read import _Clock
from .prof_mxu_compact import card

N = 300_000_000
CHUNK = 1 << 25
ARGS = dict(l=31, k=5, density=0.01, mode="hpcsimd")


def random_read(n: int, seed: int = 9) -> np.ndarray:
    """uint8[n] xcodes of random ACGT with keep bits (a base is kept where
    it differs from the one before)."""
    seq = np.random.default_rng(seed).integers(0, 4, n, dtype=np.uint8)
    keep = np.empty(n, dtype=bool)
    keep[0] = True
    np.not_equal(seq[1:], seq[:-1], out=keep[1:])
    seq |= keep.view(np.uint8) << 3
    return seq


def as_text(codes: np.ndarray) -> str:
    """The ASCII str of a read of ACGT xcodes: the same read as text."""
    return np.frombuffer(b"ACGT", dtype=np.uint8)[codes & 7].tobytes().decode("ascii")


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


PROFILE_TRIES = 3


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


NOT_MEASURED = (f"device time not measured (the profiler recorded no device event in "
                f"{PROFILE_TRIES} sessions)")


def load_package(root: Path, name: str):
    """``rust_seq2kminmers_torch`` of the checkout at ``root``, imported as
    ``name`` (its modules import each other relatively)."""
    pkg_dir = root / "rust_seq2kminmers_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg_dir / "__init__.py", submodule_search_locations=[str(pkg_dir)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def same_records(a, b) -> bool:
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(
            x[c].dtype == y[c].dtype and np.array_equal(x[c], y[c]) for c in x)
        for x, y in zip(a, b))


def profile_call(fn):
    """fn() once under torch.profiler -> (wall s, device busy s, summed s,
    events, {name: (count, ms)}), or None where no session recorded a
    device event."""
    events, wall = device_events(fn)
    if not events:
        return None
    union, summed = device_busy(events)
    by_name = {}
    for e in events:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + (e.time_range.end - e.time_range.start) / 1e3)
    return wall, union, summed, len(events), by_name


def graph_memory(lr, B: int, dev) -> tuple:
    """MiB reserved by the device allocator before and after capturing the
    compiled chunk step at [B, CHUNK] (the cache emptied on both sides, so
    the capture's warm-up, freed, is not counted)."""
    spec = lr.PipelineSpec(**ARGS)
    lr._compiled_chunk_step.cache_clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(dev) / 2**20
    step = lr._compiled_chunk_step(spec, CHUNK)
    limit = torch.full((B,), (1 << 31) - 1, dtype=torch.int32, device=dev)
    lr._capture(step, B, CHUNK, spec.l, limit)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return before, torch.cuda.memory_reserved(dev) / 2**20


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=1, choices=(1, 2))
    ap.add_argument("--parent", default=None)
    ap.add_argument("--text", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from unittest import mock

    name = card()
    print(name, flush=True)
    dev = torch.device("cuda", 0)
    seq = random_read(N)
    if args.reads == 1:
        rows = [seq]
    else:
        rows = [seq[: N // 2], seq[N // 2 :].copy()]
        rows[1][0] |= 8  # a read's first base is always kept
    shape = f"{len(rows)} x {N // len(rows)} bases"
    here = sys.modules[__package__.rsplit(".", 1)[0]]
    lr = importlib.import_module(here.__name__ + ".ops.long_read")
    for B in (1, 2):
        before, after = graph_memory(lr, B, dev)
        print(f"graph memory, the chunk step at [{B}, 2^25] on {name}: "
              f"{before:.1f} -> {after:.1f} MiB reserved (+{after - before:.1f})",
              flush=True)

    texts = [as_text(r) for r in rows] if args.text else None

    def new_split(reads=rows):
        clock = _Clock()
        got = lr._records(reads, lr.PipelineSpec(**ARGS), CHUNK, dev, clock)
        return got, {**clock.parts, "fill (producer, overlapped)": clock.fill_s}

    def eager(fn):
        def run():
            with mock.patch.object(lr, "_compiled_chunk_step", lr._chunk_step):
                return fn()
        return run

    def call():
        return here.kminmers_long_batch(rows, chunk=CHUNK, device=dev, **ARGS)

    calls = {"compiled": call, "eager step": eager(call)}
    splits = {"compiled": new_split, "eager step": eager(new_split)}
    if texts:
        calls["text input"] = lambda: here.kminmers_long_batch(
            texts, chunk=CHUNK, device=dev, **ARGS)
        splits["text input"] = lambda: new_split(texts)
    if args.parent:
        parent = load_package(Path(args.parent).resolve(), "s2k_parent")
        calls["parent tree"] = lambda: parent.kminmers_long_batch(
            rows, chunk=CHUNK, device=dev, **ARGS)
        if texts:
            calls["parent tree, text input"] = lambda: parent.kminmers_long_batch(
                texts, chunk=CHUNK, device=dev, **ARGS)
    for label, call in calls.items():
        t0 = time.perf_counter()
        call()
        print(f"{label}: warm-up (build, capture, first call): "
              f"{time.perf_counter() - t0:.4f} s", flush=True)

    walls = collections.defaultdict(list)
    want = calls[next(iter(calls))]()
    for turn in range(3):
        for label in (calls if turn % 2 == 0 else reversed(list(calls))):
            t0 = time.perf_counter()
            got = calls[label]()
            walls[label].append(time.perf_counter() - t0)
            if not same_records(got, want):
                raise RuntimeError(f"{label}: records differ from the first call's")
    n_rec = sum(len(r["hash"]) for r in want)
    for label, ws in walls.items():
        print(f"{label}: {shape}, {n_rec} k-min-mers on {name}: walls "
              + ", ".join(f"{w:.4f}" for w in ws) + " s = "
              + ", ".join(f"{N / w / 1e9:.4f}" for w in ws) + " GB/s", flush=True)
    for turn in range(3):
        for label in (splits if turn % 2 == 0 else reversed(list(splits))):
            got, parts = splits[label]()
            if not same_records(got, want):
                raise RuntimeError(f"{label}: the split call's records differ")
            host_a = sum(v for k, v in parts.items()
                         if k in ("A: H2D issue", "A: encode issue", "A: dispatch"))
            print(f"{label} split (host clock, s): total "
                  f"{sum(v for k, v in parts.items() if not k.startswith('fill')):.4f}; "
                  f"phase A host issue {host_a:.4f}; "
                  + "; ".join(f"{k} {v:.4f}" for k, v in parts.items()), flush=True)

    staging = lr._Staging(rows, CHUNK, torch.device("cpu"))
    buf = torch.empty((len(rows), CHUNK), dtype=torch.uint8, pin_memory=True).numpy()
    staging._fill(0, buf)  # touched once
    nchunks = -(-max(len(r) for r in rows) // CHUNK)
    t0 = time.perf_counter()
    for ci in range(nchunks):
        staging._fill(ci, buf)
    print(f"host staging alone ({nchunks} chunks into one touched pinned buffer): "
          f"{time.perf_counter() - t0:.4f} s", flush=True)

    for label, call in calls.items():
        prof = profile_call(call)
        if prof is None:
            print(f"{label}: {NOT_MEASURED}")
            continue
        wall, union, summed, n_ev, by_name = prof
        print(f"{label}: profiled wall {wall:.4f} s; device busy {union:.4f} s (union of "
              f"{n_ev} kernels and copies; summed {summed:.4f} s); idle share "
              f"{1 - union / wall:.4f}")
        for key, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
            print(f"  {ms:10.3f} ms  x{n:<4d} {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
