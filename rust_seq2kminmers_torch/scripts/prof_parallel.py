"""Runs the multi-process layer over NCCL on every GPU of one host, one GPU
a rank, and holds it to the one-GPU paths.

    python -m rust_seq2kminmers_torch.scripts.prof_parallel

  1. the data-parallel step, each rank on [32, 2^20] rows of its own (the
     main spec: hpcsimd, l=31, k=5, d=0.01): each rank's 12 fields equal
     ``kminmers_batch`` on its GPU, and ``merge_ordered`` gathers the
     batch's whole stream to rank 0; CUDA-event ms a step of
     ``kminmer_pipeline``, the DP step, the DP step, ``kminmer_pipeline``
     (in turns, 20 steps each) on every rank;
  2. one 300 Mbp random-ACGT read sharded over all the ranks: host-clock
     walls of the slowest rank (first, warm, warm), the codes already on
     the GPUs; the stitched records, gathered to rank 0, equal
     ``kminmers_long`` on rank 0's GPU.

Prints the cards' names and power limits first.  Needs two GPUs or more:
with fewer it exits with an error and prints no result.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .prof_long_read import random_read

B, L = 32, 1 << 20
N_LONG = 300_000_000
SEED = 13
LONG = dict(l=31, k=5, density=0.01, mode="hpcsimd")


def _time_ms(fn, reps=20, warmup=2):
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for i in range(reps):
        fn(i)
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def _dp(device) -> dict:
    from ..api import kminmers_batch
    from ..constants import with_keep_bits
    from ..ops.pipeline import PipelineSpec, kminmer_pipeline
    from ..parallel.driver import make_dp_pipeline, merge_ordered
    from ..parallel.mesh import make_mesh

    spec = PipelineSpec(max_minimizers=int(L * 0.02) + 256, **LONG)
    rng = np.random.default_rng(SEED + dist.get_rank())
    pool = [torch.from_numpy(with_keep_bits(rng.integers(0, 4, (B, L), dtype=np.uint8)))
            .to(device) for _ in range(2)]
    lengths = torch.full((B,), L, dtype=torch.int32, device=device)
    mesh = make_mesh()
    step = make_dp_pipeline(spec, mesh, device)
    res = step(pool[0], lengths)
    want = kminmers_batch(pool[0], lengths, spec)
    same = all(torch.equal(got, w) for got, w in zip(res.batch, want))
    merged = merge_ordered(res, mesh)
    times = [_time_ms(lambda i, f=f: f(pool[i % 2], lengths))
             for f in (lambda c, n: kminmer_pipeline(c, n, spec), step, step,
                       lambda c, n: kminmer_pipeline(c, n, spec))]
    return dict(same=same and int(res.lost) == 0, total=int(res.total),
                merged=None if merged is None else len(merged["hash"]), times=times)


def _seq(device) -> dict:
    from .. import kminmers_long
    from ..constants import XCODE_PAD
    from ..ops.pipeline import PipelineSpec
    from ..parallel.mesh import batch_sharding, make_mesh
    from ..parallel.seqshard import join_segments, make_seq_pipeline, stitch_segments

    S, rank = dist.get_world_size(), dist.get_rank()
    read = random_read(N_LONG)
    mesh = make_mesh(1, S)
    padded = -(-N_LONG // (S * 1024)) * S * 1024
    _, cols = batch_sharding(mesh, 1, padded, seq_sharded=True)
    local = np.full((1, cols.stop - cols.start), XCODE_PAD, dtype=np.uint8)
    part = read[cols.start : min(cols.stop, N_LONG)]
    local[0, : len(part)] = part
    x = torch.from_numpy(local).to(device)
    n = torch.tensor([N_LONG], dtype=torch.int32, device=device)
    step = make_seq_pipeline(PipelineSpec(**LONG), mesh, device)
    walls = []
    for _ in range(3):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seg = step(x, n)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    pieces = [None] * S if rank == 0 else None
    dist.gather_object(type(seg)(*(t.cpu().numpy() for t in seg)), pieces, dst=0)
    same = None
    if rank == 0:
        st = stitch_segments(join_segments(pieces, S))
        nk = int(st.n_kminmers[0])
        hi, lo = (a[0, :nk].astype(np.uint64) for a in (st.hash_hi, st.hash_lo))
        got = {"hash": (hi << np.uint64(32)) | lo, "start": st.start[0, :nk].astype(np.int64),
               "end": st.end[0, :nk].astype(np.int64), "offset": np.arange(nk, dtype=np.int64),
               "rev": st.rev[0, :nk]}
        want = kminmers_long(read, device=device, **LONG)
        same = all(got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
                   for k in want)
        same = (same, nk)
    return dict(walls=walls, same=same)


def rank_main(device) -> dict:
    return {"dp": _dp(device), "seq": _seq(device)}


def main() -> int:
    from ..parallel.launch import run_world

    ranks = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if ranks < 2:
        print(f"needs two GPUs or more, found {ranks}", file=sys.stderr)
        return 1
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(cards, flush=True)
    t0 = time.perf_counter()
    out = run_world(rank_main, ranks, "nccl", "cuda")
    print(f"world of {ranks} NCCL ranks, one GPU each: {time.perf_counter() - t0:.2f} s",
          flush=True)
    ok = True
    for r, res in enumerate(out):
        dp = res["dp"]
        ok &= dp["same"]
        print(f"rank {r} DP step [{B}, {L}] hpcsimd: 12 fields equal kminmers_batch: "
              f"{dp['same']}; CUDA events, in turns: kminmer_pipeline {dp['times'][0]:.4f} ms, "
              f"DP step {dp['times'][1]:.4f} ms, DP step {dp['times'][2]:.4f} ms, "
              f"kminmer_pipeline {dp['times'][3]:.4f} ms", flush=True)
    total = out[0]["dp"]["total"]
    ok &= out[0]["dp"]["merged"] == total and all(r["dp"]["total"] == total for r in out)
    print(f"DP step: merge_ordered at rank 0 gives the batch's {out[0]['dp']['merged']} "
          f"k-min-mers of {ranks * B} reads (all-gathered total {total})")
    same, nk = out[0]["seq"]["same"]
    ok &= same
    walls = np.array([r["seq"]["walls"] for r in out]).max(axis=0)
    print(f"{N_LONG}-base read hpcsimd l=31 over S={ranks} NCCL ranks: the {nk} stitched "
          f"records equal kminmers_long: {same}; walls (the slowest rank's; first, warm, "
          "warm) " + ", ".join(f"{w:.4f}" for w in walls) + " s")
    if not ok:
        print("FAILED: a sharded result differs from its one-GPU path", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
