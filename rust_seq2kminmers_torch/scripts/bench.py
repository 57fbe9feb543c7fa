"""Benchmark: HPC + NtHash k-min-mer throughput on one GPU; the port's twin
of the reference package's ``bench.py``.

    python -m rust_seq2kminmers_torch.scripts.bench [--device cuda|cpu]
        [--size BASES] [--steps N]

Prints one JSON line with ``bench.py``'s keys: {"metric", "value",
"unit", "vs_baseline", "detail"}.

The same shape, spec and method as ``bench.py``: 32 reads x 1 Mbp
(``--size`` bases a batch, cut as the suite cuts them), mode hpcsimd,
l=31, k=5, d=0.01, ``max_minimizers = int(L * 0.02) + 256``; a pool of 16
distinct batches resident on the device; a unit of ``--steps`` (256)
pipeline steps over the pool whose checksum covers n_kminmers, hash_lo,
hash_hi, min_hash, start and end; one host sync a unit; the median of 3
units after a warm one.  On the card the unit is one captured CUDA graph
(``bench_suite.timed_units``), as the reference's unit is one jitted scan.
``value`` is B * L bases over the median step time.

``vs_baseline`` is null: the reference's 4 GB/s is the TPU's north star,
not the card's, and the card has no baseline yet.  ``detail.device`` is
the card's name and power limit (``nvidia-smi``), or "cpu".  A CUDA device
that does not exist raises: nothing falls back to the CPU.  Nothing is
written to disk.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

POOL = 16
STEPS = 256
SIZE = 32 << 20  # [32, 2^20]


def checksum(out):
    """(the checksum of ``bench.py``'s ``chk_of``, the k-min-mer count) of
    one KminmerBatch, int64 device scalars."""
    return (
        out.n_kminmers.sum() + out.hash_lo.sum() + out.hash_hi.sum()
        + out.min_hash.sum() + out.start.sum() + out.end.sum(),
        out.n_kminmers.sum(),
    )


def run(size: int = SIZE, steps: int = STEPS, device="cuda") -> dict:
    """One measurement -> the JSON line's object."""
    from rust_seq2kminmers_torch import bench_suite as bs
    from rust_seq2kminmers_torch.api import _device
    from rust_seq2kminmers_torch.ops.pipeline import PipelineSpec, kminmer_pipeline

    device = _device(device)
    B, L = bs.batch_shape(size)
    spec = PipelineSpec(l=31, k=5, density=0.01, mode="hpcsimd",
                        max_minimizers=int(L * 0.02) + 256)
    pool = bs.make_pool(B, L, device, POOL)
    lengths = torch.full((B,), L, dtype=torch.int32, device=device)
    dt, (_, n_km) = bs.timed_units(
        lambda codes: checksum(kminmer_pipeline(codes, lengths, spec)), pool, steps)
    name, power_limit = bs.card(device)
    return {
        "metric": "hpc_nthash_kminmers_throughput",
        "value": B * L / dt / 1e9,
        "unit": "GB/s/chip",
        "vs_baseline": None,
        "detail": {
            "mode": spec.mode,
            "l": spec.l,
            "k": spec.k,
            "density": spec.density,
            "batch": [B, L],
            "steps_per_sync": steps,
            "step_ms": dt * 1e3,
            "kminmers_per_s": int(n_km / (dt * steps)),
            "device": name if power_limit is None else f"{name}, {power_limit}",
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=SIZE, help="bases a batch")
    ap.add_argument("--steps", type=int, default=STEPS, help="steps a unit")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.size, args.steps, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    sys.exit(main())
