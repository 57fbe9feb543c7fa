"""Profiles the long-read path on one NVIDIA GPU: one 300 Mbp random-ACGT
read through ``kminmers_long`` (hpcsimd, l=31, k=5, d=0.01, chunk 2^25).

    python -m rust_seq2kminmers_torch.scripts.prof_long_read

  1. a warm-up on a 64 Mbp prefix (the kernels' build, pinned buffers);
  2. three host-clock walls of the whole read, staging, transfers and
     assembly included;
  3. the host's staging alone (filling the 9 chunks, no device);
  4. one run under ``torch.profiler``: the device's busy time is the union
     of the intervals of its kernels and copies (copies on the staging
     stream overlap the compute stream, so a plain sum counts them
     twice), and the idle share is 1 - busy / wall; then the device time
     of each kernel and copy, summed by name.

Prints the card's name and power limit first.  Needs a GPU: without one it
exits with an error and prints no result.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import kminmers_long
from ..ops.long_read import _Staging
from .prof_mxu_compact import card

N = 300_000_000
CHUNK = 1 << 25
ARGS = dict(l=31, k=5, density=0.01, mode="hpcsimd", chunk=CHUNK)


def random_read(n: int, seed: int = 9) -> np.ndarray:
    """uint8[n] xcodes of random ACGT with keep bits (a base is kept where
    it differs from the one before)."""
    seq = np.random.default_rng(seed).integers(0, 4, n, dtype=np.uint8)
    keep = np.empty(n, dtype=bool)
    keep[0] = True
    np.not_equal(seq[1:], seq[:-1], out=keep[1:])
    seq |= keep.view(np.uint8) << 3
    return seq


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


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    name = card()
    print(name, flush=True)
    dev = torch.device("cuda", 0)
    seq = random_read(N)
    t0 = time.perf_counter()
    kminmers_long(seq[: 2 * CHUNK], device=dev, **ARGS)
    print(f"warm-up (build + 64 Mbp): {time.perf_counter() - t0:.4f} s", flush=True)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        n_rec = len(kminmers_long(seq, device=dev, **ARGS)["hash"])
        walls.append(time.perf_counter() - t0)
    print(f"{N} bases, {n_rec} k-min-mers on {name}: walls "
          + ", ".join(f"{w:.4f}" for w in walls) + " s = "
          + ", ".join(f"{N / w / 1e9:.4f}" for w in walls) + " GB/s", flush=True)
    staging = _Staging([seq], CHUNK, torch.device("cpu"))
    t0 = time.perf_counter()
    for ci in range(-(-N // CHUNK)):
        staging.host_array(ci)
    print(f"host staging alone ({-(-N // CHUNK)} chunks): "
          f"{time.perf_counter() - t0:.4f} s", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        kminmers_long(seq, device=dev, **ARGS)
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise RuntimeError("the profiler recorded no device event")
    union, summed = device_busy(events)
    print(f"profiled wall {wall:.4f} s; device busy {union:.4f} s (union of "
          f"{len(events)} kernels and copies; summed {summed:.4f} s); idle share "
          f"{1 - union / wall:.4f}")
    by_name = {}
    for e in events:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + (e.time_range.end - e.time_range.start) / 1e3)
    for key, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"  {ms:10.3f} ms  x{n:<4d} {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
