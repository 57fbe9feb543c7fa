"""What the span recorder (``tracing.py``) costs on one NVIDIA GPU, and
where a ``kminmers_batch`` call's host time goes by its spans.

    python -m rust_seq2kminmers_torch.scripts.prof_tracing [--calls 2000] [--sets 6]

The calls are the benchmark's main cell's: hpcsimd, l=31, k=5, d=0.01
on [32, 2^20] xcode batches that live on the card (4 drawn, used in
turn), each call synchronised as the benchmark's driver does.  Prints the
card's name and power limit, then

  1. the off cost of a span: ns a ``with tracing.span(...)`` while
     nothing records, over 10^6 spans;
  2. us a call in alternating sets of ``--calls`` calls (off, on, on,
     off, ...) with ``tracing.recording()`` off and on; the median of each
     and their difference, the on cost a call;
  3. the recorded calls' host time by span: self us a call (a span's time
     less its children's) and spans a call, by name.

Needs a GPU: without one it exits with an error and prints no result.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch

from .. import tracing
from ..api import kminmers_batch
from ..ops.pipeline import PipelineSpec
from .prof_mxu_compact import card

B, L = 32, 1 << 20
SPEC = PipelineSpec(l=31, k=5, density=0.01, mode="hpcsimd")


def pool(n: int, dev) -> torch.Tensor:
    """uint8[n, B, L] uniform ACGT xcodes with keep bits, drawn on ``dev``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    codes = torch.randint(0, 4, (n, B, L), generator=gen, device=dev, dtype=torch.uint8)
    keep = torch.ones_like(codes, dtype=torch.bool)
    keep[..., 1:] = codes[..., 1:] != codes[..., :-1]
    return codes | keep.to(torch.uint8) << 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--sets", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    print(f"{card()}; torch {torch.__version__}", flush=True)
    dev = torch.device("cuda", 0)
    codes = pool(4, dev)
    lengths = torch.full((B,), L, dtype=torch.int32, device=dev)

    n = 10**6
    t0 = time.perf_counter()
    for _ in range(n):
        with tracing.span("off"):
            pass
    print(f"a span while nothing records: {(time.perf_counter() - t0) / n * 1e9:.1f} ns",
          flush=True)

    def calls() -> float:
        t0 = time.perf_counter()
        for i in range(args.calls):
            kminmers_batch(codes[i % len(codes)], lengths, SPEC)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / args.calls * 1e6

    for i in range(len(codes)):  # the capture and the first calls
        kminmers_batch(codes[i], lengths, SPEC)
    torch.cuda.synchronize()
    us = {"off": [], "on": []}
    spans = []
    for s in range(args.sets):
        for mode in (("off", "on") if s % 2 == 0 else ("on", "off")):
            if mode == "on":
                with tracing.recording() as spans:
                    us[mode].append(calls())
            else:
                us[mode].append(calls())
    for mode, sets in us.items():
        print(f"recording {mode}: us a call " + ", ".join(f"{u:.2f}" for u in sets)
              + f"; median {statistics.median(sets):.2f}", flush=True)
    print(f"on cost: {statistics.median(us['on']) - statistics.median(us['off']):.2f} us a "
          f"call ({args.sets} sets of {args.calls} calls each way, in turns)", flush=True)

    per_call = tracing.self_seconds(spans)
    counts = {}
    for r in spans:
        counts[r.name] = counts.get(r.name, 0) + 1
    ncalls = counts.get("batch.call", 0) or 1
    print(f"the last recorded set, {ncalls} calls ({tracing.RECORDER.dropped} spans dropped): "
          "self us a call by span (spans a call)", flush=True)
    for name, s in per_call.items():
        print(f"  {name:14s} {s / ncalls * 1e6:9.2f}  ({counts[name] / ncalls:g})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
