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
     times), with a sync only where the path itself syncs: the self
     seconds of the path's spans (``tracing.recording()``; ``long.call``'s
     own is what no other span covers) and the producer's fill seconds
     (``long.fill``, which overlaps them); phase A's host issue is its
     ``long.h2d_issue``, ``long.encode_issue`` and ``long.dispatch`` with
     the compiled step's spans under it (``PHASE_A_ISSUE``);
  5. the host's staging alone, as the path does it: ``_Staging._fill``
     into one pinned buffer that was already touched, over every chunk;
  6. one call of each way under ``torch.profiler``: the device's busy
     time is the union of the intervals of its kernels and copies (copies
     on the staging stream overlap the compute stream, so a plain sum
     counts them twice), and the idle share is 1 - busy / wall; then the
     device time of each kernel and copy, summed by kernel name
     (``common.profile``).

Prints the card's name and power limit first.  Needs a GPU: without one it
exits with an error and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import tracing
from .common import NOT_MEASURED, card, load_package, profile

N = 300_000_000
CHUNK = 1 << 25
ARGS = dict(l=31, k=5, density=0.01, mode="hpcsimd")
PHASE_A_ISSUE = ("long.h2d_issue", "long.encode_issue", "long.dispatch", "step.inputs",
                 "step.replay", "step.handoff")


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


def same_records(a, b) -> bool:
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(
            x[c].dtype == y[c].dtype and np.array_equal(x[c], y[c]) for c in x)
        for x, y in zip(a, b))


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
        with tracing.recording() as spans:
            got = lr._records(reads, lr.PipelineSpec(**ARGS), CHUNK, dev)
        return got, tracing.self_seconds(spans)

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
            host_a = sum(v for k, v in parts.items() if k in PHASE_A_ISSUE)
            print(f"{label} split (host clock, s): total "
                  f"{sum(v for k, v in parts.items() if k != 'long.fill'):.4f}; "
                  f"phase A host issue {host_a:.4f}; "
                  + "; ".join(f"{k} {v:.4f}" for k, v in parts.items())
                  + " (long.fill: the producer's, overlapped)", flush=True)

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
        prof = profile(lambda i: call())
        if prof is None:
            print(f"{label}: {NOT_MEASURED}")
            continue
        print(f"{label}: profiled wall {prof.wall_ms / 1e3:.4f} s; device busy "
              f"{prof.busy_ms / 1e3:.4f} s (union of {prof.events:.0f} kernels and copies; "
              f"summed {prof.summed_ms / 1e3:.4f} s); idle share {prof.idle_share:.4f}")
        for key, (n, ms) in sorted(prof.by_kernel.items(), key=lambda kv: -kv[1][1])[:12]:
            print(f"  {ms:10.3f} ms  x{n:<4.0f} {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
