"""Races the two in-row compaction kernels on the same work, on one NVIDIA
GPU: K5, warp ballots and a shared-memory scatter, against K6, the same
permutation as an integer one-hot product on the tensor cores.

    python -m rust_seq2kminmers_torch.scripts.prof_mxu_compact

The port of ``scripts/prof_mxu_compact.py``, which asked whether a
one-hot permutation on the matrix unit beats a move network for the
in-row (128-lane) part of a data-dependent compaction.  The task is the
same: payloads x[R, 128] (u16 values carried in f32) and a keep mask
k[R, 128] at 75% keep from ``default_rng(3)``; left-pack each row's kept
payloads, with 1 and 4 payloads.

  1. both kernels are checked bit for bit against numpy on the [512, 128]
     tile;
  2. K5, K6 and the plain PyTorch version are timed with CUDA events on
     that tile and on R = 262,144 rows (32 Mi elements, the main path's
     [32, 1 Mbp] as 128-lane rows: a 512-row tile leaves the card bound
     by launches), where the kernels are checked against the plain
     version;
  3. the script prints ms per call, the card's name and power limit, and
     whether the tensor-core permutation beats the direct scatter.

Needs a GPU: without one it exits with an error and prints no result.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..ops.cuda.inrow_compact import (
    LANES,
    inrow_compact_ballot,
    inrow_compact_mma,
    inrow_compact_plain,
)
from .common import card, event_ms

R = 512  # the reference's tile of rows
BIG_R = 262144  # 32 Mi elements
KEEP = 0.75
PAYLOADS = (1, 4)
KERNELS = {"ballot": inrow_compact_ballot, "mma": inrow_compact_mma}


def tile_inputs():
    """The reference's inputs, drawn in its order: the keep mask, then the
    payloads for 1 and for 4 -> {npay: (xs, keep)} as numpy f32 [R, 128]."""
    rng = np.random.default_rng(3)
    keep = (rng.random((R, LANES)) < KEEP).astype(np.float32)
    return {
        npay: (
            [rng.integers(0, 1 << 16, size=(R, LANES)).astype(np.float32)
             for _ in range(npay)],
            keep,
        )
        for npay in PAYLOADS
    }


def numpy_reference(xs, keep):
    """Each row's kept payloads left-packed, zero after, by a row loop."""
    outs = []
    for x in xs:
        ref = np.zeros_like(x)
        for r in range(x.shape[0]):
            sel = x[r][keep[r] != 0]
            ref[r, : len(sel)] = sel
        outs.append(ref)
    return outs


def big_inputs(npay, device, seed=3):
    """R = 262,144 rows made on the device from a seed."""
    g = torch.Generator(device=device).manual_seed(seed)
    keep = (torch.rand((BIG_R, LANES), generator=g, device=device) < KEEP).float()
    xs = [torch.randint(0, 1 << 16, (BIG_R, LANES), generator=g, device=device)
          .float() for _ in range(npay)]
    return xs, keep


def bits_equal(got, want) -> bool:
    return all(torch.equal(g.view(torch.int32), w.contiguous().view(torch.int32))
               for g, w in zip(got, want))


def run(device) -> list:
    """Checks and times both kernels -> one dict per (rows, payloads)."""
    results = []
    for npay, (xh, kh) in tile_inputs().items():
        refs = numpy_reference(xh, kh)
        xs = [torch.from_numpy(x).to(device) for x in xh]
        keep = torch.from_numpy(kh).to(device)
        for name, fn in KERNELS.items():
            got = [o.cpu().numpy() for o in fn(xs, keep)]
            if not all(np.array_equal(g.view(np.uint32), w.view(np.uint32))
                       for g, w in zip(got, refs)):
                raise RuntimeError(f"{name} kernel differs from numpy (npay={npay})")
        results.append(_timed(xs, keep, reps=200))
        print(f"both kernels exact on [{R}, {LANES}] @ {KEEP:.0%} keep, "
              f"{npay} payload(s)", flush=True)
    for npay in PAYLOADS:
        xs, keep = big_inputs(npay, device)
        plain = inrow_compact_plain(xs, keep)
        for name, fn in KERNELS.items():
            if not bits_equal(fn(xs, keep), plain):
                raise RuntimeError(f"{name} kernel differs from plain ({BIG_R} rows)")
        results.append(_timed(xs, keep, reps=20))
        del xs, keep, plain
    return results


def _timed(xs, keep, reps):
    row = {"rows": keep.shape[0], "payloads": len(xs)}
    for name, fn in KERNELS.items():
        row[f"{name}_ms"] = event_ms(lambda i: fn(xs, keep), reps, 3)
    row["plain_ms"] = event_ms(lambda i: inrow_compact_plain(xs, keep), max(reps // 4, 3), 3)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    name = card()
    print(name, flush=True)
    results = run(torch.device("cuda", 0))
    for r in results:
        faster = "beats" if r["mma_ms"] < r["ballot_ms"] else "does not beat"
        print(f"[{r['rows']}, {LANES}] x {r['payloads']} payload(s) on {name}: "
              f"K5 ballot {r['ballot_ms']:.4f} ms, K6 mma {r['mma_ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms; the tensor-core permutation "
              f"{faster} the direct scatter (K6 / K5 = "
              f"{r['mma_ms'] / r['ballot_ms']:.3f})", flush=True)
    print(json.dumps({"card": name, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
