"""Runs the multi-process layer over NCCL on the GPUs of one host, one GPU
a rank, and holds it to the one-GPU paths and to its own plain steps.

    python -m rust_seq2kminmers_torch.scripts.prof_parallel [--worlds 2 4]

Writes the ~0.5 Gbp FASTA of ``prof_stream.py`` into a temporary
directory, then in a world of each size given (default: 2 and every GPU
there is):

  1. the data-parallel step, each rank on [32, 2^20] rows of its own (the
     main spec: hpcsimd, l=31, k=5, d=0.01): the compiled step
     (``make_dp_pipeline``: one captured graph with the NCCL all-gather and
     all-reduce inside) equals ``dp_step`` (the plain function, eager) in
     all 12 fields, global_offset, total and lost, and ``kminmers_batch``
     on the rank's GPU; ``merge_ordered`` gathers the batch's stream to
     rank 0.  CUDA-event ms a step in turns (20 steps each):
     ``make_pipeline``'s graph step, the compiled step, the pipeline's
     graph followed by the eager collectives (the step as gloo runs it),
     ``dp_step``, then the same back; ``dp_step`` split into its parts
     (CUDA events around the local pipeline, the all-gather and the
     all-reduce, the glue as the rest); the host's ms to issue a step, and
     10 steps under the profiler (device busy, NCCL kernels' device ms,
     device kernels a step);
  2. ranks that pad their rows each to its own length (16 << rank
     kb) with a spec whose tiles overflow, through the compiled step with
     the file runner's rescue loop (each rank sizes its rescue from its own
     raw count), three batches: no hang, each batch equal to ``dp_step``
     and ``kminmers_batch``;
  3. one 300 Mbp random-ACGT read sharded over all the ranks: host-clock
     walls of the slowest rank (first, warm, warm), the codes already on
     the GPUs, of the compiled step (``make_seq_pipeline``: one graph with
     both all-gathers inside) and of ``seq_step``; each rank's segment of
     the compiled step equals ``seq_step``'s, and the stitched records,
     gathered to rank 0, equal ``kminmers_long`` on rank 0's GPU;
     ``seq_step`` split as in 1 (K1's passes 1-2, the all-gathers, K1
     from the carry, K2, K3, the glue), and the host's ms and the
     profiler's rows of both steps;
  4. ``run_file_distributed`` over NCCL on the FASTA with the CLI's
     defaults: each rank's chunks equal its slice of
     ``StreamingRunner.collect()``'s stream on its GPU.

Prints the cards' names and power limits first.  Needs two GPUs or more:
with fewer it exits with an error and prints no result.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .prof_long_read import device_busy, random_read
from .prof_stream import kernel_name

B, L = 32, 1 << 20
N_LONG = 300_000_000
SEED = 13
LONG = dict(l=31, k=5, density=0.01, mode="hpcsimd")
# Item 2: tiles of 8 survivors and M = 64 overflow at d = 0.05.
RESCUE = dict(l=11, k=3, density=0.05, mode="hpcsimd", max_minimizers=64, tile_cap=8)
FILE_ROWS_PER_RANK = 128


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


def _host_ms(fn, reps=20):
    """Host-clock ms to issue a call of fn(i), before the closing sync."""
    fn(0)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i)
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e3


def split_ms(fn, module, names, reps=10) -> dict:
    """fn(i) run reps times with each of ``module``'s ``names`` wrapped in
    CUDA events on the current stream -> {name: ms a step, "step": ms a
    step, "rest": the step less its named parts}."""
    real = {n: getattr(module, n) for n in names}
    spans = {n: [] for n in names}
    steps = []

    def timed(name):
        def run(*args, **kwargs):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out = real[name](*args, **kwargs)
            e1.record()
            spans[name].append((e0, e1))
            return out
        return run

    fn(0)
    torch.cuda.synchronize()
    for n in names:
        setattr(module, n, timed(n))
    try:
        for i in range(reps):
            dist.barrier()
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            fn(i)
            e1.record()
            steps.append((e0, e1))
        torch.cuda.synchronize()
    finally:
        for n, f in real.items():
            setattr(module, n, f)
    out = {n: sum(a.elapsed_time(b) for a, b in v) / reps for n, v in spans.items()}
    out["step"] = sum(a.elapsed_time(b) for a, b in steps) / reps
    out["rest"] = out["step"] - sum(out[n] for n in names)
    return out


def profiled(fn, reps=10) -> dict:
    """reps calls of fn(i) under the profiler -> device busy ms a call, the
    NCCL kernels' device ms a call, device kernels a call, and the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    dist.barrier()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = [e for e in p.events() if e.device_type == DeviceType.CUDA]
    if not evs:
        raise RuntimeError("the profiler recorded no device event")
    busy, _ = device_busy(evs)
    by = {}
    for e in evs:
        k = kernel_name(e.name)
        by[k] = by.get(k, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / reps
    return {"busy_ms": busy / reps * 1e3, "wall_ms": wall / reps * 1e3,
            "nccl_ms": sum(v for k, v in by.items() if k.startswith("ncclDevKernel")),
            "kernels": sum(not e.name.startswith(("Memcpy", "Memset")) for e in evs) / reps,
            "top": sorted(by.items(), key=lambda kv: -kv[1])[:8]}


def _equal(got, want) -> bool:
    return all(g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want))


def _flat(res) -> tuple:
    return (*res.batch, *res[1:])


def _dp(device) -> dict:
    from .. import api
    from ..api import kminmers_batch
    from ..constants import with_keep_bits
    from ..ops.pipeline import PipelineSpec
    from ..parallel import driver
    from ..parallel.driver import dp_step, make_dp_pipeline, merge_ordered
    from ..parallel.mesh import make_mesh

    spec = PipelineSpec(max_minimizers=int(L * 0.02) + 256, **LONG)
    rng = np.random.default_rng(SEED + dist.get_rank())
    pool = [torch.from_numpy(with_keep_bits(rng.integers(0, 4, (B, L), dtype=np.uint8)))
            .to(device) for _ in range(2)]
    lengths = torch.full((B,), L, dtype=torch.int32, device=device)
    mesh = make_mesh()
    group = mesh.get_group("data")
    step = make_dp_pipeline(spec, mesh, device)
    same = True
    for i in range(3):  # the first answered by the capture's warm-up, then replays
        res = step(pool[i % 2], lengths)
        same &= _equal(_flat(res), _flat(dp_step(pool[i % 2], lengths, spec, group)))
        same &= _equal(res.batch, kminmers_batch(pool[i % 2], lengths, spec))
    merged = merge_ordered(res, mesh)
    graph_step = api._cached_pipeline(spec)
    eager = lambda c, n: dp_step(c, n, spec, group)  # noqa: E731
    # The step as gloo runs it: the pipeline's graph, then the collectives.
    split = lambda c, n: driver._offsets(graph_step(c, n), group)  # noqa: E731
    times = [(what, _time_ms(lambda i, f=f: f(pool[i % 2], lengths)))
             for what, f in (("make_pipeline", graph_step), ("DP step", step),
                             ("graph + eager collectives", split), ("dp_step", eager),
                             ("DP step", step), ("graph + eager collectives", split),
                             ("make_pipeline", graph_step))]
    parts = split_ms(lambda i: dp_step(pool[i % 2], lengths, spec, group), driver,
                     ["kminmer_pipeline", "all_gather", "all_reduce_sum"])
    host = {what: _host_ms(lambda i, f=f: f(pool[i % 2], lengths))
            for what, f in (("DP step", step), ("graph + eager collectives", split),
                            ("dp_step", eager))}
    prof = {what: profiled(lambda i, f=f: f(pool[i % 2], lengths))
            for what, f in (("DP step", step), ("graph + eager collectives", split))}
    return dict(same=same and int(res.lost) == 0, total=int(res.total),
                merged=None if merged is None else len(merged["hash"]), times=times,
                parts=parts, host=host, prof=prof)


def _mixed(device) -> dict:
    """Item 2 -> whether every batch equalled dp_step and kminmers_batch,
    and the retries and pads of this rank."""
    from ..api import kminmers_batch, rescue_spec
    from ..constants import with_keep_bits
    from ..ops.pipeline import PipelineSpec
    from ..parallel.driver import dp_step, make_dp_pipeline
    from ..parallel.mesh import make_mesh

    rank = dist.get_rank()
    mesh = make_mesh()
    group = mesh.get_group("data")
    rng = np.random.default_rng(SEED + 100 + rank)
    same, retries, pads = True, [], []
    for g in range(3):
        pad = (16 << rank) * 1024 * (1 + g % 2)
        codes = torch.from_numpy(with_keep_bits(rng.integers(0, 4, (4, pad), dtype=np.uint8)))
        codes, lengths = codes.to(device), torch.full((4,), pad, dtype=torch.int32,
                                                       device=device)
        spec = PipelineSpec(**RESCUE)
        for n in range(8):  # run_file_distributed's loop
            res = make_dp_pipeline(spec, mesh, device)(codes, lengths)
            same &= _equal(_flat(res), _flat(dp_step(codes, lengths, spec, group)))
            if int(res.lost) == 0:
                break
            spec = rescue_spec(spec, int(res.batch.n_minimizers_raw.max()))
        same &= _equal(res.batch, kminmers_batch(codes, lengths, PipelineSpec(**RESCUE)))
        retries.append(n)
        pads.append(pad)
    return dict(same=same, retries=retries, pads=pads)


def _seq(device) -> dict:
    from .. import kminmers_long
    from ..constants import XCODE_PAD
    from ..ops.pipeline import PipelineSpec
    from ..parallel import seqshard
    from ..parallel.mesh import batch_sharding, make_mesh
    from ..parallel.seqshard import join_segments, make_seq_pipeline, seq_step, stitch_segments

    S, rank = dist.get_world_size(), dist.get_rank()
    read = random_read(N_LONG)
    mesh = make_mesh(1, S)
    group = mesh.get_group("seq")
    padded = -(-N_LONG // (S * 1024)) * S * 1024
    _, cols = batch_sharding(mesh, 1, padded, seq_sharded=True)
    local = np.full((1, cols.stop - cols.start), XCODE_PAD, dtype=np.uint8)
    part = read[cols.start : min(cols.stop, N_LONG)]
    local[0, : len(part)] = part
    x = torch.from_numpy(local).to(device)
    n = torch.tensor([N_LONG], dtype=torch.int32, device=device)
    spec = PipelineSpec(**LONG)
    step = make_seq_pipeline(spec, mesh, device)
    eager = lambda i: seq_step(x, n, spec, group)  # noqa: E731
    walls = {}
    for what, fn in (("compiled", lambda i: step(x, n)), ("seq_step", eager)):
        walls[what] = []
        for i in range(3):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            seg = fn(i)
            torch.cuda.synchronize()
            walls[what].append(time.perf_counter() - t0)
    seg = step(x, n)
    same_plain = _equal(seg, seq_step(x, n, spec, group))
    parts = split_ms(eager, seqshard, ["tile_carries", "all_gather", "fused_minimizer_scan",
                                       "slot_compact_counts", "assemble_masked_cuda"])
    host = {"compiled": _host_ms(lambda i: step(x, n), reps=10),
            "seq_step": _host_ms(eager, reps=10)}
    prof = {"compiled": profiled(lambda i: step(x, n), reps=5),
            "seq_step": profiled(eager, reps=5)}
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
    return dict(walls=walls, same=same, same_plain=same_plain, parts=parts, host=host,
                prof=prof)


def _file(device, path) -> dict:
    """Item 4 -> whether this rank's chunks equal its slice of the
    streaming runner's stream, and its wall."""
    from ..ops.pipeline import PipelineSpec
    from ..parallel.multihost import global_data_mesh, run_file_distributed
    from .prof_stream import run

    spec = PipelineSpec(l=31, k=5, density=0.01)
    dist.barrier()
    t0 = time.perf_counter()
    chunks = run_file_distributed(path, spec, global_data_mesh(device), FILE_ROWS_PER_RANK,
                                  device=device)
    wall = time.perf_counter() - t0
    want = run(path, spec, device)[1]
    same = bool(chunks)
    for c in chunks:
        n = len(c.records["hash"])
        for key, col in c.records.items():
            w = want[key][c.stream_start : c.stream_start + n]
            same &= col.dtype == w.dtype and np.array_equal(col, w)
    total = chunks[-1].stream_start + len(chunks[-1].records["hash"]) if chunks else 0
    return dict(same=same, chunks=len(chunks), wall=wall, stream=len(want["hash"]),
                last_end=total)


def rank_main(device, path) -> dict:
    return {"dp": _dp(device), "mixed": _mixed(device), "seq": _seq(device),
            "file": _file(device, path)}


def _parts(p) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in p.items())


def _prof(p) -> str:
    return (f"busy {p['busy_ms']:.4f} ms of a {p['wall_ms']:.4f} ms wall, NCCL kernels "
            f"{p['nccl_ms']:.4f} ms, {p['kernels']:.1f} device kernels; top: "
            + ", ".join(f"{k} {v:.4f}" for k, v in p["top"]))


def run(ranks: int, path) -> bool:
    from ..parallel.launch import run_world

    t0 = time.perf_counter()
    out = run_world(rank_main, ranks, "nccl", "cuda", str(path))
    print(f"world of {ranks} NCCL ranks, one GPU each: {time.perf_counter() - t0:.2f} s",
          flush=True)
    ok = True
    for r, res in enumerate(out):
        dp = res["dp"]
        ok &= dp["same"]
        print(f"[{ranks}] rank {r} DP step [{B}, {L}] hpcsimd: 3 compiled calls equal dp_step "
              f"(15 fields) and kminmers_batch: {dp['same']}; CUDA events, in turns: "
              + ", ".join(f"{w} {t:.4f} ms" for w, t in dp["times"]), flush=True)
        print(f"[{ranks}] rank {r} dp_step split (CUDA events, ms a step): "
              f"{_parts(dp['parts'])}; host issue ms: {_parts(dp['host'])}; profiler: "
              + "; ".join(f"{w}: {_prof(p)}" for w, p in dp["prof"].items()), flush=True)
    total = out[0]["dp"]["total"]
    ok &= out[0]["dp"]["merged"] == total and all(r["dp"]["total"] == total for r in out)
    print(f"[{ranks}] DP step: merge_ordered at rank 0 gives the batch's "
          f"{out[0]['dp']['merged']} k-min-mers of {ranks * B} reads (all-gathered total {total})")
    for r, res in enumerate(out):
        mx = res["mixed"]
        ok &= mx["same"]
        print(f"[{ranks}] rank {r} own pads {mx['pads']} with overflowing tiles: retries "
              f"{mx['retries']}, each batch equal to dp_step and kminmers_batch: {mx['same']}",
              flush=True)
    same, nk = out[0]["seq"]["same"]
    ok &= same and all(r["seq"]["same_plain"] for r in out)
    for what in ("compiled", "seq_step"):
        walls = np.array([r["seq"]["walls"][what] for r in out]).max(axis=0)
        print(f"[{ranks}] {N_LONG}-base read hpcsimd l=31 over S={ranks} NCCL ranks, {what}: "
              "walls (the slowest rank's; first, warm, warm) "
              + ", ".join(f"{w:.4f}" for w in walls) + " s")
    print(f"[{ranks}] the compiled sharded step equals seq_step on every rank: "
          f"{all(r['seq']['same_plain'] for r in out)}; its {nk} stitched records equal "
          f"kminmers_long: {same}")
    for r, res in enumerate(out):
        sq = res["seq"]
        print(f"[{ranks}] rank {r} seq_step split (CUDA events, ms a step): "
              f"{_parts(sq['parts'])}; host issue ms: {_parts(sq['host'])}; profiler: "
              + "; ".join(f"{w}: {_prof(p)}" for w, p in sq["prof"].items()), flush=True)
    for r, res in enumerate(out):
        f = res["file"]
        ok &= f["same"]
        print(f"[{ranks}] rank {r} run_file_distributed over NCCL, CLI defaults, "
              f"{FILE_ROWS_PER_RANK} rows a rank: {f['chunks']} chunks equal its slice of "
              f"StreamingRunner.collect() ({f['stream']} records): {f['same']}; wall "
              f"{f['wall']:.4f} s", flush=True)
    ok &= out[-1]["file"]["last_end"] <= out[-1]["file"]["stream"]
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worlds", type=int, nargs="*", default=None)
    args = ap.parse_args(argv)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    worlds = args.worlds or sorted({2, cards})
    if cards < 2 or max(worlds) > cards:
        print(f"needs {max(worlds + [2])} GPUs, found {cards}", file=sys.stderr)
        return 1
    from .prof_stream import make_reads, write_fasta

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "reads.fa"
        bases = write_fasta(path, make_reads())
        print(f"FASTA of {bases} bases written", flush=True)
        ok = all([run(w, path) for w in worlds])
    if not ok:
        print("FAILED: a sharded or compiled result differs from its one-GPU or plain path",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
