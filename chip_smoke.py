#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths through its user entry points, on data made from
a numpy seed, after building the CUDA kernels from
``rust_seq2kminmers_torch/csrc``.  Three batch paths on [32, 1 Mbp]:

  - the main path: mode hpcsimd, l=31, k=5, d=0.01, u32 hashes; the fused
    route K1 -> K2 -> K3;
  - the general path: hpcsimd, nthash2, l=301, k=5, d=0.01; the route for
    l = 1 or l > 255, K4's HPC form -> the general scan (whole-row hash,
    select and compaction) -> K3;
  - the u64 path: regular, hash_width=64, l=31, k=5, d=0.01; K1 -> K2 -> K3
    at width 64;

then the long-read path (one 300 Mbp random-ACGT read through
``kminmers_long``: K1 with its carry chunk by chunk -> K2 -> K3), the
profiling script (``rust_seq2kminmers_torch/scripts/prof_mxu_compact.py``:
K5 and K6), the file path (a FASTA through the reader and the
streaming runner, batches of the fused route; and the command line),
the multi-process layer (``rust_seq2kminmers_torch/parallel``: the
data-parallel step, the sequence-sharded step, whose shards run K1's
passes 1-2, K1 from the carry, K2 and K3, and the distributed file runner,
in worlds of spawned ranks on the one card), the burn-in against the
numpy oracle, the per-stage benchmark suite, and last the compiled step
(captured CUDA graphs) with the twin of ``bench.py``.

In order, and any failure raises (exit code != 0):

  1. needs a GPU; prints the card's name and power limit;
  2. builds the kernel library; prints the build time and ptxas's
     register / shared-memory / spill lines;
  3. checks each kernel bit for bit against its plain PyTorch version at
     the paths' shapes: K1 fused scan (u32, and widths 16/64 and nthash2;
     and its passes 1-2, the tiles' ranks and pending prefixes, against
     ``tile_carries_plain``), K2 slot compaction (its kept-count form,
     and the main path's form that reads K1's counts in place and writes
     n_min and n_raw), K3 assembly (xorshift, murmur and identity mixes,
     each also in the masked form that writes the k-min-mer fields, with
     per-row counts 0, k-1, k, M and random), K4 masked compaction (the
     dense packed HPC compaction, m = L, and a 3-column minimizer
     compaction at a 1% mask), K4's HPC form (read from the xcodes), the
     general scan (hpcsimd nthash2 l=301 on the HPC form's stream,
     regular u64 l=400, regular u32 l=1 at d=0.3), and xcode, the
     encoder of raw text (both families: [32, 2^20] full rows of every
     byte value with runs, lowercase and N; the same rows with ragged
     lengths, 0, 1, 15, 17 and random, and a row of xcodes passed
     through; a [1, 2^25] long-read chunk whose byte before it is real,
     aligned and as a view one byte past an allocation);
  4. reproduces the 15 u32 and 20 u64 golden hashes
     (tests/data/ecoli.genome.100k.fa, regular, l=10, k=5, d=0.0001) on
     the card from the fixture's str, with the counters at zero: xcode
     must have encoded it, once a call;
  5. runs each path through ``kminmers_batch`` (a replay of the path's
     captured graph, captured just before) with the launch counters
     set to zero just before and read just after: each path must launch
     its kernels (the general path K4's HPC form, the general scan and K3,
     never K1 or K2), and all 12 KminmerBatch fields must equal the plain
     pipeline's on the card; then forces the overflow rescue on a small
     batch (a tiny capacity on the fused and the general route) and checks
     that it retries and ends lossless, equal to its run on the CPU;
  6. times each path and each kernel with CUDA events, beside the plain
     versions; prints K1's time per instance beside its bound, and every
     kernel's bound (the larger of its bytes over the HBM rate and its
     integer operations over the peak rate: ``benchmark/roofline.py``,
     the benchmark's own yardstick, with its K1, K2 and K3 counts where
     they count this work); K2's and K3's device time under the profiler;
     profiles 10 main-path steps and 10 general-path steps (device busy
     time a step, idle share, device kernels a step, device time by
     kernel); times K4's two cases, its HPC form and the general scan
     beside their bounds and plain versions; xcode's device time under the
     profiler at [32, 2^20] and [1, 2^25] beside its bound and its plain
     version;
  7. checks K1 with a carry bit for bit against its plain version: chunk 2
     of [4, 2 x 4 Mbp] reads from the carry the kernel gave on chunk 1, for
     u32 hpcsimd l=31, u64 regular l=31 and nthash2 hpc l=201, and times
     it beside its bound;
  8. checks K5 and K6 bit for bit against their plain version at
     [512, 128] and [262144, 128], 1 and 4 payloads;
  9. runs the profiling script with the counters at zero: it checks K5 and
     K6 against numpy and times them;
 10. runs the long-read path with the counters at zero (hpcsimd, l=31,
     k=5, d=0.01, chunk 2^25: a producer thread staging the chunks, the
     chunk step one captured CUDA graph replayed a chunk, K3 on the
     device-resident stream) and checks it: the same records at chunk
     2^23; on a 64 Mbp prefix, the same records as ``kminmers_batch`` on
     one [1, 2^26] row; two 150 Mbp reads batched equal their own runs;
     the same records with the eager chunk step; one capture per batch
     size at chunk 2^25; the same read as an ASCII str (staged as raw
     bytes and encoded by xcode on the card, the counters at zero: xcode
     launched once a chunk) gives the same records.  Prints the wall time,
     its GB/s, warm walls of the compiled and the eager step in turns with
     a profiled call of each (device busy, idle share, the graph's
     device-to-device copies), warm walls of the xcode and the str input
     in turns with the producer's fill seconds,
     the memory a capture at [1, 2^25] holds, and K1's time per chunk.
     Then holds
     the long read's kernels bit for bit against their plain versions at
     its shapes: K1 with a carry (carry-out included) and its passes 1-2
     and K2 on a [1, 2^25] chunk, K3 on the read's whole [1, M] minimizer
     stream; K1's time per chunk beside its bound; K2 on the chunk with
     and without its fill (the long-read driver's form), checked and
     timed;
 11. runs the file path with the counters at zero: a seeded FASTA of ~0.5
     Gbp (``rust_seq2kminmers_torch/scripts/prof_stream.py``: 24,000 HiFi-like
     reads of 10-30 kb, 50,000 short reads, 4 wrapped contigs of 2-4 Mbp)
     through the streaming runner with the CLI's defaults (regular, l=31,
     k=5, d=0.01) and the main spec (hpcsimd): a first and two warm runs
     each (wall, GB/s, packing, first result, batches, buckets) and one
     profiled run (device busy, idle share, device time by kernel); K1, K2
     and K3 must have launched.  Checks that the records are ordered, that
     256 random reads and the 4 contigs equal ``kminmers_list`` on the card,
     that a ~2 Mbp prefix gives the same six columns on the card and on the
     CPU, that ``python -m rust_seq2kminmers_torch`` prints 1942 k-min-mers
     for the fixture, that the demo prints the same on the card as on the
     CPU, and that ``kminmers_vec`` agrees on the card and the CPU.

 12. runs the multi-process layer, the counters at zero in each rank before
     its run, each rank a process from ``parallel/launch.run_world``:
     (a) in an NCCL world of one: the compiled data-parallel step (one
     captured graph with its all-gather and all-reduce inside) on [32, 1
     Mbp] with the main spec, three calls with the counters at zero and
     one capture, each call's 12 fields, global_offset, total and lost
     equal to ``dp_step`` (the plain function) and ``kminmers_batch``,
     ``merge_ordered`` equal to ``stitch_records``; phase 5's rescue cells
     on both routes (the general one runs K4's HPC form and the general
     scan) retried through the compiled step on ``lost``, equal to
     ``kminmers_batch``; the compiled sharded step on a (1, 1) mesh over
     64 Mbp of phase 10's read, equal to ``seq_step`` and
     ``kminmers_long``; the captures counted; CUDA-event times in turns of
     ``make_pipeline``'s graph step, the DP step and ``dp_step``; (b)
     phase 10's read sharded over 2 and
     4 gloo ranks on the card (the stitched records equal phase 10's
     ``kminmers_long``; walls, K1's time per shard, the two all-gathers'
     seconds), and over 1, which K1's 2^28 length cap refuses; (c) [4,
     2^24] ragged reads at regular u64 l=31 and hpc nthash2 l=201 over a
     (2, 2) mesh, each equal to ``kminmers_batch``; (d)
     ``run_file_distributed`` over 2 gloo ranks on phase 11's whole file
     with the CLI defaults, equal to its ``StreamingRunner.collect()``.
     K1 (its passes 1-2 too), K2 and K3 must have launched in every rank.
     Then no child process of the script may be left running.
 13. runs the burn-in (``rust_seq2kminmers_torch/scripts/burnin.py``) at a
     fixed seed with the counters at zero: 24 fused-route configurations
     and 6 on the general route, 6 sequences each of up to 6 kb in five
     alphabets, each sequence's records through ``kminmers_list`` on the
     card equal to ``backend="oracle"``; K1, K2 and K3 must have launched
     for the fused-route sequences, the general scan for the general-route
     ones and K4's HPC form for those in an hpc mode, and xcode for every
     sequence (each is a str, encoded on the card).  Then the memory the
     graphs hold: ``memory_reserved`` after the burn-in, and over a
     ``kminmers_batch`` sweep of 120 shapes with and without the cap on
     captured steps a pipeline keeps.
 14. runs the per-stage suite (``rust_seq2kminmers_torch/bench_suite.py``):
     its 9 host rows (the host library), and its 9 device rows at [32,
     2^20] with 16 steps a
     unit, the counters at zero; a unit is one captured graph, so each
     case runs its capture's eager warm-up unit, one warm replay and 3
     timed replays, and the 8 pipeline cases must have launched K1, K2 and
     K3 at every step of those; each pipeline case's checksum of one step
     equals ``kminmer_pipeline_plain``'s on the card, and the dense hash
     stage's first 2^16 columns of row 0 equal the CPU's.
 15. runs the compiled step (``make_pipeline``: captured CUDA graphs)
     with the counters at zero before each use: for the main, general and
     u64 paths at [32, 1 Mbp], the capture's warm-up launches the path's
     kernels once, the capture none, and each replay what the capture
     recorded; the graph's 12 fields equal eager ``kminmer_pipeline`` and
     the plain pipeline, and a batch survives a later call; a rescue
     after ``precompile_rescue`` captures nothing and equals the CPU run;
     a capture that fails raises; last the twin of ``bench.py``
     (``rust_seq2kminmers_torch/scripts/bench.py``) at its defaults, its
     JSON line printed.

Then the script's wall time.  The second-to-last line is a JSON object
with one entry per kernel (its launches on the paths, error, time, plain
time, bound and what binds it; no PyTorch call computes any of these
functions, so ``library_ms`` is null); the last is ``{"ok": true,
"device": {...}}``.

The card's name, the CUDA-event timer and the profiler's reads are the
measuring scripts' own (``rust_seq2kminmers_torch/scripts/common.py``).
A profiler session that records no device event is run again, up to three
sessions; after three empty ones the line says the device time was not
measured, and a kernel's time in the JSON line is its CUDA-event time.
Every check still holds.
"""

import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

from benchmark import roofline
from benchmark.roofline import HBM_BYTES_PER_S, bound_s, k1_bound_s, k2_bound_s, k3_bound_s

REPO = Path(__file__).resolve().parent
SEED = 7
B, L = 32, 1 << 20
KERNELS = {  # name -> (source, the TPU kernel or XLA code it replaces)
    "fused_scan": (
        "rust_seq2kminmers_torch/csrc/fused_scan.cu",
        "rust_seq2kminmers_tpu/ops/pallas/fused_scan.py:357",
    ),
    "slot_compact": (
        "rust_seq2kminmers_torch/csrc/slot_compact.cu",
        "rust_seq2kminmers_tpu/ops/pallas/slot_compact.py:37",
    ),
    "assemble": (
        "rust_seq2kminmers_torch/csrc/assemble.cu",
        "rust_seq2kminmers_tpu/ops/pallas/assemble_kernel.py:71",
    ),
    "masked_compact": (
        "rust_seq2kminmers_torch/csrc/masked_compact.cu",
        "rust_seq2kminmers_tpu/ops/pallas/compact_kernel.py:125",
    ),
    "general_scan": (
        "rust_seq2kminmers_torch/csrc/general_scan.cu",
        "rust_seq2kminmers_tpu/ops/pipeline.py:198-264",
    ),
    "inrow_compact_ballot": (
        "rust_seq2kminmers_torch/csrc/inrow_compact.cu",
        "scripts/prof_mxu_compact.py:63",
    ),
    "inrow_compact_mma": (
        "rust_seq2kminmers_torch/csrc/inrow_compact.cu",
        "scripts/prof_mxu_compact.py:91",
    ),
    "xcode": (  # no TPU kernel: the reference encodes on the host
        "rust_seq2kminmers_torch/csrc/xcode.cu",
        "rust_seq2kminmers_tpu/io/native/rle_kernels.h:368-409",
    ),
}
# Launch counters per kernel: K4 counts its masked form and its HPC form.
COUNTERS = {name: (name,) for name in KERNELS}
COUNTERS["masked_compact"] = ("masked_compact", "hpc_compact")
COUNTERS["fused_scan"] = ("fused_scan", "tile_carries")  # K1, and its passes 1-2 alone
N_LONG = 300_000_000  # the reference's own long-read size (LONGREAD_r05.json)


def bound(fn, *counts):
    """(bound ms, what binds it) of ``fn(*counts)``, a bound in seconds by
    ``benchmark/roofline.py``: the larger of the bytes over the HBM rate and
    the operations over the peak rate.  The operations bind it where their
    rate alone gives that time."""
    seconds = fn(*counts)
    with mock.patch.object(roofline, "HBM_BYTES_PER_S", math.inf):
        operations = fn(*counts)
    return seconds * 1e3, "operations" if operations >= seconds else "bytes"


def k1_bound(codes, counts, width):
    """K1's bound on these inputs and its tiles' counts (``k1_bound_s``)."""
    B_, nt_ = counts.shape[:2]
    return bound(k1_bound_s, B_, codes.shape[1], nt_, int(counts[..., 0].sum()),
                 int(counts[..., 2].sum()), width)


def k1_carry_bound(codes, counts, l, width):
    """K1 with a carry, which ``k1_bound_s`` does not count: its work, and
    base0, carry-in and carry-out read or written once.  Each base read
    once, the lengths and limits, each kept survivor's (start, end,
    hash[, hash_hi]) and the counts written once; integer operations: the
    keep test per base (3), and per stream element its two rotated terms
    and two prefix XORs, then its window's two XORs, two rotations, the
    min and the compare (12)."""
    B_, L_ = codes.shape
    survivors = int(counts[..., 0].sum())
    nbytes = (B_ * L_ + 8 * B_ + survivors * (16 if width == 64 else 12)
              + counts.numel() * 4 + B_ * (8 * l + 4))
    return bound(bound_s, nbytes, 3 * B_ * L_ + 12 * int(counts[..., 2].sum()))


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"FAILED: {msg}")


def log(msg):
    print(msg, flush=True)


def live_children():
    """{pid: command line} of this process's live child processes."""
    import os

    out = {}
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
            if int(fields[1]) == os.getpid() and fields[0] != "Z":
                cmd = (stat.parent / "cmdline").read_bytes().replace(b"\0", b" ")
                out[int(stat.parent.name)] = cmd.decode(errors="replace").strip()
        except OSError:  # the process ended meanwhile
            continue
    return out


def file_phase(dev, card, counters, tmp: Path):
    """Phase 11: a seeded FASTA of ~0.5 Gbp (``scripts/prof_stream.py``),
    written into ``tmp``, through the streaming runner; -> (the kernels'
    launches while it ran, the file, the ordered stream of its CLI-defaults
    run)."""
    import io

    import numpy as np
    import torch

    from rust_seq2kminmers_torch import kminmers_list
    from rust_seq2kminmers_torch.__main__ import demo
    from rust_seq2kminmers_torch.kminmer import kminmers_vec
    from rust_seq2kminmers_torch.ops.cuda import build
    from rust_seq2kminmers_torch.scripts import prof_stream as ps

    columns = ("hash", "start", "end", "offset", "rev", "read")
    path = tmp / "reads.fa"
    t0 = time.perf_counter()
    reads = ps.make_reads()
    total = ps.write_fasta(path, reads)
    log(f"file path: {len(reads)} records, {total} bases, {path.stat().st_size} bytes of "
        f"FASTA written in {time.perf_counter() - t0:.2f} s")

    # The runs, counters at 0: per spec one first and two warm runs,
    # then one warm run under the profiler.
    build.launches.clear()
    kept = {}
    for what, spec in ps.SPECS.items():
        for i in range(3):
            stats, recs, _ = ps.run(path, spec, dev)
            if i == 0:
                kept[what] = (spec, stats, recs)
            log(f"file path, {what}, {'first' if i == 0 else 'warm'} run on {card}: "
                f"{ps.describe(stats)}")
        log(f"file path, {what}, warm run under the profiler on {card}: "
            + ps.describe_profile(ps.run(path, spec, dev, profiled=True)[2]))
    torch.cuda.synchronize()
    ran = {c: build.launches[c] for c in counters}
    log(f"file path launches: {ran}")
    for name in ("fused_scan", "slot_compact", "assemble"):
        check(ran[name] > 0, f"the file path never launched {name}")

    # The records: ordered, and each of 256 random reads and the 4
    # contigs equal to kminmers_list on that read alone.
    rng = np.random.default_rng(SEED + 3)
    n_contig = int(reads.wrapped.sum())
    held = np.concatenate([rng.choice(len(reads) - n_contig, 256, replace=False),
                           np.arange(len(reads) - n_contig, len(reads))])
    for what, (spec, stats, recs) in kept.items():
        read = recs["read"]
        check(stats.num_records == len(reads) and stats.total_bases == total
              and stats.total_kminmers == len(read), f"{what}: stream counts")
        check(bool((np.diff(read) >= 0).all()), f"{what}: read ids not ascending")
        first = np.searchsorted(read, read, "left")
        check(np.array_equal(recs["offset"], np.arange(len(read)) - first),
              f"{what}: offsets are not 0..n-1 within each read")
        for i in held:
            lo, hi = np.searchsorted(read, [i, i + 1])
            want = kminmers_list(reads.seq(i).tobytes(), spec.l, spec.k, spec.density,
                                 spec.mode, device=dev)
            got = [(int(recs["hash"][j]), int(recs["start"][j]), int(recs["end"][j]),
                    int(recs["offset"][j]), bool(recs["rev"][j])) for j in range(lo, hi)]
            check(got == [(r.hash, r.start, r.end, r.offset, r.rev) for r in want],
                  f"{what}: read {i} differs from kminmers_list")
        log(f"file path, {what}: {len(read)} k-min-mers, ordered by read then offset; "
            f"{len(held)} reads (256 random, {n_contig} contigs) equal kminmers_list on the card")
    file_recs = kept[next(iter(ps.SPECS))][2]  # the CLI defaults' stream, for phase 12
    del kept

    # A ~2 Mbp prefix of the file: the card's stream equals the CPU's.
    count = min(len(reads), int(np.searchsorted(reads.starts, 2_000_000)))
    prefix = tmp / "prefix.fa"
    n_prefix = ps.write_fasta(prefix, reads, count)
    for what, spec in ps.SPECS.items():
        got = ps.run(prefix, spec, dev)[1]
        t0 = time.perf_counter()
        want = ps.run(prefix, spec, "cpu")[1]
        cpu_s = time.perf_counter() - t0
        for c in columns:
            check(got[c].dtype == want[c].dtype and np.array_equal(got[c], want[c]),
                  f"{what}: prefix column {c} differs from the CPU run")
        log(f"file path, {what}: the {count}-record, {n_prefix}-base prefix gives the same "
            f"{len(got['hash'])} records in all six columns on the card and on the CPU "
            f"(CPU run {cpu_s:.2f} s)")

    # The CLI on the fixture, the demo and kminmers_vec.
    proc = subprocess.run(
        [sys.executable, "-m", "rust_seq2kminmers_torch", "tests/data/ecoli.genome.100k.fa", "4"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    check(proc.returncode == 0 and "1942 k-min-mers from 99925 bases" in proc.stdout,
          f"the CLI on the fixture: rc {proc.returncode}\n{proc.stdout}\n{proc.stderr}")
    log("CLI: " + " | ".join(proc.stdout.strip().splitlines()))
    shown = {}
    for d in (dev, "cpu"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            demo(device=d)
        shown[str(d)] = buf.getvalue()
    check(shown[str(dev)] == shown["cpu"], "the demo on the card differs from the CPU")
    log(f"demo: the card prints the CPU's {len(shown['cpu'].splitlines())} lines")
    seq = (REPO / "tests/data/ecoli.genome.100k.fa").read_text().split("\n")[1]
    vecs = {str(d): [(v.mers, v.start, v.end, v.offset, v.rev)
                     for v in kminmers_vec(seq, 31, 5, 0.01, "regular", device=d)]
            for d in (dev, "cpu")}
    check(vecs[str(dev)] == vecs["cpu"] and len(vecs["cpu"]) == 1942,
          "kminmers_vec on the card differs from the CPU")
    log(f"kminmers_vec on the fixture: {len(vecs['cpu'])} records, equal on the card and the CPU")
    return ran, path, file_recs

# Phase 12: the multi-process layer.  The rank functions run in processes
# that run_world spawns; each imports this file as its main module.
PHASE12_COUNTERS = ("tile_carries", "fused_scan", "slot_compact", "assemble",
                    "hpc_compact", "general_scan")
FILE_ROWS_PER_RANK = 128


def main_spec():
    from rust_seq2kminmers_torch.ops.pipeline import PipelineSpec

    return PipelineSpec(l=31, k=5, density=0.01, mode="hpcsimd",
                        max_minimizers=int(L * 0.02) + 256)


def long_read_codes():
    """Phase 10's read: N_LONG random bases from SEED + 2, as xcodes."""
    import numpy as np

    rng = np.random.default_rng(SEED + 2)
    seq = rng.integers(0, 4, N_LONG, dtype=np.uint8)
    keep_bit = np.empty(N_LONG, dtype=bool)
    keep_bit[0] = True
    np.not_equal(seq[1:], seq[:-1], out=keep_bit[1:])
    seq |= keep_bit.view(np.uint8) << 3
    return seq


def text_rows(seed, rows, length):
    """uint8[rows, length] raw text: every byte value, with runs,
    lowercase and N."""
    import numpy as np

    rng = np.random.default_rng(seed)
    alphabet = np.concatenate([np.frombuffer(b"ACGTNacgtn", dtype=np.uint8),
                               np.arange(256, dtype=np.uint8)])
    n = rows * length
    return np.repeat(rng.choice(alphabet, n), rng.integers(1, 6, n))[:n].reshape(rows, length)


def ragged_batch(seed, rows, length):
    """Random ACGT rows of at least half ``length`` bases, padded."""
    import numpy as np

    from rust_seq2kminmers_torch.constants import XCODE_PAD, with_keep_bits

    rng = np.random.default_rng(seed)
    codes = with_keep_bits(rng.integers(0, 4, (rows, length), dtype=np.uint8))
    lengths = (length - rng.integers(0, length // 2, rows)).astype(np.int32)
    for b in range(rows):
        codes[b, lengths[b]:] = XCODE_PAD
    return codes, lengths


def rank_launches():
    import torch

    from rust_seq2kminmers_torch.ops.cuda import build

    torch.cuda.synchronize()
    return {c: build.launches[c] for c in PHASE12_COUNTERS}


def dp_rank(device, long_path):
    """(a) In this rank's NCCL world of one.  The compiled DP step
    (``make_dp_pipeline``: one captured graph with its all-gather and
    all-reduce inside) at [B, L] with the main spec, three calls on phase
    3's two batches with the counters at 0 just before and the captures
    counted; each call's 12 fields, global_offset, total and lost equal
    ``dp_step``'s (the plain function, run in turns) and kminmers_batch's;
    merge_ordered against stitch_records.  Then phase 5's rescue cells
    ([4, 2^16], fused and general route) retried through the compiled step
    on ``lost`` read after each replay, each equal to kminmers_batch; then
    the compiled sharded step on a (1, 1) mesh over a 64 Mbp prefix of
    phase 10's read, twice, equal to ``seq_step`` and ``kminmers_long``.
    Last, CUDA-event times in turns: ``make_pipeline``'s graph step, the DP
    step, ``dp_step``, the DP step, the graph step.  -> (launches of the
    main path, launches of the rest, captures, times, k-min-mers)."""
    import numpy as np
    import torch

    from rust_seq2kminmers_torch import api, kminmers_long
    from rust_seq2kminmers_torch.api import kminmers_batch, rescue_spec
    from rust_seq2kminmers_torch.constants import with_keep_bits
    from rust_seq2kminmers_torch.ops.cuda import build, graph
    from rust_seq2kminmers_torch.ops.pipeline import PipelineSpec
    from rust_seq2kminmers_torch.parallel import seqshard
    from rust_seq2kminmers_torch.parallel.driver import (
        dp_step,
        make_dp_pipeline,
        merge_ordered,
        stitch_records,
    )
    from rust_seq2kminmers_torch.parallel.mesh import make_mesh
    from rust_seq2kminmers_torch.scripts.common import event_ms

    captures = []

    class Counted(graph.CapturedStep):
        def __init__(self, *args):
            captures.append(tuple(args[1][0].shape))
            super().__init__(*args)

    graph.CapturedStep = Counted

    def same(got, want, what):
        for name, g, w in zip(want._fields, got, want):
            check(g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w),
                  f"{what}: field {name}")

    spec = main_spec()
    rng = np.random.default_rng(SEED)  # phase 3's two batches
    pool = [torch.from_numpy(with_keep_bits(rng.integers(0, 4, (B, L), dtype=np.uint8)))
            .to(device) for _ in range(2)]
    lengths = torch.full((B,), L, dtype=torch.int32, device=device)
    mesh = make_mesh()
    group = mesh.get_group("data")
    step = make_dp_pipeline(spec, mesh, device)
    check(make_dp_pipeline(spec, mesh, device) is step, "make_dp_pipeline is not cached")
    build.launches.clear()
    outs = [step(pool[i % 2], lengths) for i in range(3)]
    ran = rank_launches()
    check(len(captures) == 1 and len(step.compiled.graphs) == 1,
          f"the DP step captured {captures}")
    for i, res in enumerate(outs):
        want = kminmers_batch(pool[i % 2], lengths, spec)
        plain = dp_step(pool[i % 2], lengths, spec, group)
        same(res.batch, want, f"DP call {i} vs kminmers_batch")
        same(res.batch, plain.batch, f"DP call {i} vs dp_step")
        nk = want.n_kminmers.cpu().numpy().astype(np.int64)
        excl = np.cumsum(nk) - nk
        for name, got, w in (("global_offset", res.global_offset, plain.global_offset),
                             ("total", res.total, plain.total), ("lost", res.lost, plain.lost)):
            check(got.shape == w.shape and got.dtype == w.dtype and torch.equal(got, w),
                  f"DP call {i}: {name} differs from dp_step")
        check(int(res.lost) == 0 and int(res.total) == nk.sum()
              and np.array_equal(res.global_offset.cpu().numpy(), excl), f"DP call {i} offsets")
    res, want = outs[0], kminmers_batch(pool[0], lengths, spec)
    nk = want.n_kminmers.cpu().numpy().astype(np.int64)
    excl = np.cumsum(nk) - nk
    mk = int(nk.max())
    words = [t[:, :mk].cpu().numpy().view(np.uint32).astype(np.uint64)
             for t in (want.hash_hi, want.hash_lo)]
    ref = stitch_records(nk, excl, int(nk.sum()), (words[0] << np.uint64(32)) | words[1],
                         *(t[:, :mk].cpu().numpy() for t in (want.start, want.end, want.rev)))
    merged = merge_ordered(res, mesh)
    for key in ref:
        check(merged[key].dtype == ref[key].dtype and np.array_equal(merged[key], ref[key]),
              f"merge_ordered column {key} differs from stitch_records")

    # Phase 5's rescue cells through the compiled step.
    small = pool[0][:4, : 1 << 16].contiguous()
    small_len = torch.full((4,), 1 << 16, dtype=torch.int32, device=device)
    rescued = {}
    build.launches.clear()
    for route, rs in (
        ("fused", PipelineSpec(l=11, k=3, density=0.05, mode="hpcsimd", max_minimizers=64,
                               tile_cap=8)),
        ("general", PipelineSpec(l=301, k=3, density=0.05, mode="hpc", max_minimizers=64)),
    ):
        specs = [rs]
        while True:
            res = make_dp_pipeline(specs[-1], mesh, device)(small, small_len)
            if int(res.lost) == 0:  # read after the replay
                break
            check(len(specs) < 4, f"the {route} rescue did not end")
            specs.append(rescue_spec(specs[-1], int(res.batch.n_minimizers_raw.max())))
        rescued[route] = (rs, specs, res)
    ran_rest = rank_launches()
    n_dp = len(captures)
    rescues = {}
    for route, (rs, specs, res) in rescued.items():
        check(len(specs) >= 2, f"the {route} rescue never retried")
        same(res.batch, kminmers_batch(small, small_len, rs), f"{route} rescue vs kminmers_batch")
        plain = dp_step(small, small_len, specs[-1], group)
        same(res.batch, plain.batch, f"{route} rescue vs dp_step")
        check(torch.equal(res.global_offset, plain.global_offset) and int(res.total)
              == int(plain.total), f"{route} rescue offsets")
        rescues[route] = (len(specs) - 1, int(res.batch.n_minimizers.sum()))

    # The compiled sharded step on a (1, 1) mesh, below K1's 2^28 cap.
    read = np.load(long_path, mmap_mode="r")[: 1 << 26]
    n = len(read)
    x = torch.from_numpy(np.array(read)[None, :]).to(device)
    nl = torch.tensor([n], dtype=torch.int32, device=device)
    smesh = make_mesh(1, 1)
    sstep = seqshard.make_seq_pipeline(PipelineSpec(l=31, k=5, density=0.01,
                                                    mode="hpcsimd"), smesh, device)
    build.launches.clear()
    n_before = len(captures)
    segs = [sstep(x, nl) for _ in range(2)]
    n_sharded = len(captures) - n_before
    for name, c in rank_launches().items():
        ran_rest[name] += c
    check(len(sstep.compiled.graphs) == 1, "the sharded step's graphs")
    check(n_sharded == 1, f"the sharded step captured {n_sharded} times")
    captured = {"DP main": 1, "DP rescues": n_dp - 1, "sharded": n_sharded}
    plain = seqshard.seq_step(x, nl, sstep.spec, smesh.get_group("seq"))
    for i, seg in enumerate(segs):
        same(seg, plain, f"sharded call {i} vs seq_step")
    st = seqshard.stitch_segments(seqshard.join_segments([plain], 1))
    nkl = int(st.n_kminmers[0])
    hi, lo = (a[0, :nkl].astype(np.uint64) for a in (st.hash_hi, st.hash_lo))
    got = {"hash": (hi << np.uint64(32)) | lo, "start": st.start[0, :nkl].astype(np.int64),
           "end": st.end[0, :nkl].astype(np.int64), "offset": np.arange(nkl, dtype=np.int64),
           "rev": st.rev[0, :nkl]}
    want_l = kminmers_long(np.ascontiguousarray(read), device=device, l=31, k=5, density=0.01,
                           mode="hpcsimd")
    for key in want_l:
        check(got[key].dtype == want_l[key].dtype and np.array_equal(got[key], want_l[key]),
              f"the sharded step's {key} differs from kminmers_long")
    del segs, plain, x

    graph_step = api._cached_pipeline(spec)
    turns = [("make_pipeline", graph_step), ("DP step", step),
             ("dp_step", lambda c, n: dp_step(c, n, spec, group)), ("DP step", step),
             ("make_pipeline", graph_step)]
    times = [(what, event_ms(lambda i, f=f: f(pool[i % 2], lengths), 20)) for what, f in turns]
    return (ran, ran_rest, captured, times, int(nk.sum()), rescues, nkl)


def _timed_step(step, x, n):
    """One step with K1's launches timed by CUDA events and the
    collectives by the host clock (the device synchronised first) -> (K1
    ms, [seconds of each all-gather])."""
    import time as _time

    import torch

    from rust_seq2kminmers_torch.parallel import seqshard
    from rust_seq2kminmers_torch.scripts.common import timed

    events, gathers = [], []
    real = {name: getattr(seqshard, name)
            for name in ("tile_carries", "fused_minimizer_scan", "all_gather")}

    def timed_gather(t, group):
        torch.cuda.synchronize()
        t0 = _time.perf_counter()
        out = real["all_gather"](t, group)
        gathers.append(_time.perf_counter() - t0)
        return out

    seqshard.tile_carries = timed(real["tile_carries"], events)
    seqshard.fused_minimizer_scan = timed(real["fused_minimizer_scan"], events)
    seqshard.all_gather = timed_gather
    try:
        step(x, n)
        torch.cuda.synchronize()
    finally:
        for name, fn in real.items():
            setattr(seqshard, name, fn)
    return sum(e0.elapsed_time(e1) for e0, e1 in events), gathers


def parallel_rank(device, jobs):
    """Each job in turn, on every rank of the world -> {name: result}.

    ("seq", name, spec keywords, (n_data, n_seq), source, runs): the
    sequence-sharded step on this rank's block of the source (("long",
    .npy of phase 10's read), or ("ragged", seed, rows, length)), timed over
    ``runs`` walls and one instrumented run when runs > 1 -> this rank's
    segment as numpy, its launches in the first run, walls, K1 ms, gather
    seconds; None outside the mesh; the message if the step raised
    ValueError.
    ("file", name, path, rows per rank): run_file_distributed with the CLI
    defaults -> (this rank's chunks, launches, wall)."""
    import time as _time

    import numpy as np
    import torch
    import torch.distributed as dist

    from rust_seq2kminmers_torch.constants import XCODE_PAD
    from rust_seq2kminmers_torch.ops.cuda import build
    from rust_seq2kminmers_torch.ops.pipeline import PipelineSpec
    from rust_seq2kminmers_torch.parallel import seqshard
    from rust_seq2kminmers_torch.parallel.mesh import batch_sharding, make_mesh
    from rust_seq2kminmers_torch.parallel.multihost import global_data_mesh, run_file_distributed

    out = {}
    for job in jobs:
        kind, name = job[:2]
        if kind == "file":
            path, rows = job[2:]
            dist.barrier()
            build.launches.clear()
            t0 = _time.perf_counter()
            chunks = run_file_distributed(path, PipelineSpec(l=31, k=5, density=0.01),
                                          global_data_mesh(device), rows, device=device)
            out[name] = (chunks, rank_launches(), _time.perf_counter() - t0)
            continue
        kw, shape, source, runs = job[2:]
        mesh = make_mesh(*shape)
        if mesh.get_coordinate() is None:
            out[name] = None
            continue
        if source[0] == "long":
            read = np.load(source[1], mmap_mode="r")
            S = shape[1]
            Lp = -(-len(read) // (S * 1024)) * (S * 1024)
            rows, cols = batch_sharding(mesh, 1, Lp, seq_sharded=True)
            local = np.full((1, cols.stop - cols.start), XCODE_PAD, dtype=np.uint8)
            part = read[cols.start : min(cols.stop, len(read))]
            local[0, : len(part)] = part
            lengths = np.array([len(read)], dtype=np.int32)
        else:
            codes, lengths = ragged_batch(*source[1:])
            rows, cols = batch_sharding(mesh, *codes.shape, seq_sharded=True)
            local, lengths = codes[rows, cols], lengths[rows]
        x = torch.from_numpy(np.ascontiguousarray(local)).to(device)
        n = torch.from_numpy(lengths).to(device)
        try:
            step = seqshard.make_seq_pipeline(PipelineSpec(**kw), mesh, device)
            group = mesh.get_group("seq")
            walls, ran = [], None
            build.launches.clear()
            for i in range(runs):
                dist.barrier(group=group)
                torch.cuda.synchronize()
                t0 = _time.perf_counter()
                seg = step(x, n)
                torch.cuda.synchronize()
                walls.append(_time.perf_counter() - t0)
                ran = ran or rank_launches()
        except ValueError as e:
            out[name] = str(e)
            continue
        k1_ms, gathers = _timed_step(step, x, n) if runs > 1 else (None, None)
        out[name] = dict(seg=type(seg)(*(t.cpu().numpy() for t in seg)), ran=ran, walls=walls,
                         k1_ms=k1_ms, gathers=gathers)
        del seg, x
        torch.cuda.empty_cache()
    return out


def parallel_phase(dev, card, long_recs, long_path, file_path, file_recs) -> dict:
    """Phase 12, the multi-process layer on the one card -> the kernels'
    launches in the ranks.  (a) the data-parallel step, an NCCL world of
    one; (b) phase 10's read sharded over 2 and 4 gloo ranks (and over 1,
    which K1's length cap refuses); (c) [4, 2^24] over a (2, 2) mesh at two
    more specs; (d) the distributed file runner over 2 gloo ranks on phase
    11's file."""
    import numpy as np
    import torch

    from rust_seq2kminmers_torch.api import kminmers_batch
    from rust_seq2kminmers_torch.ops.pipeline import PipelineSpec
    from rust_seq2kminmers_torch.parallel.launch import run_world
    from rust_seq2kminmers_torch.parallel.seqshard import join_segments, stitch_segments

    launches = {c: 0 for c in PHASE12_COUNTERS}

    def count(ran, what):
        log(f"phase 12 {what} launches: {ran}")
        for c in ("fused_scan", "slot_compact", "assemble"):
            check(ran[c] > 0, f"phase 12 {what} never launched {c}")
        for c in ran:
            launches[c] += ran[c]

    # (a)
    t0 = time.perf_counter()
    (ran, ran_rest, captured, times, n_km, rescues, n_long), = run_world(
        dp_rank, 1, "nccl", dev, str(long_path))
    count(ran, "(a) compiled DP step, 3 calls (the first answered by the capture's warm-up)")
    log(f"phase 12 (a) rescues and the sharded step, launches: {ran_rest}")
    for c in ("fused_scan", "tile_carries", "slot_compact", "assemble", "hpc_compact",
              "general_scan"):
        check(ran_rest[c] > 0, f"phase 12 (a) never launched {c} outside the main DP calls")
    for c in ran_rest:
        launches[c] += ran_rest[c]
    log(f"phase 12 (a) compiled DP step [{B}, {L}] hpcsimd, NCCL world of 1 on {card}: 3 calls, "
        f"one capture; each call's 12 fields, global_offset, total and lost equal dp_step's and "
        f"kminmers_batch's; merge_ordered equals stitch_records ({n_km} k-min-mers); rescues "
        "through the compiled step, lost read after each replay (retries, minimizers): "
        f"{rescues}, each equal to kminmers_batch and dp_step; the compiled sharded step on a "
        f"(1, 1) mesh, 64 Mbp of phase 10's read, twice: equal to seq_step, {n_long} records "
        f"equal to kminmers_long; captures {captured}; CUDA events, in turns: "
        + ", ".join(f"{what} {t:.4f} ms" for what, t in times)
        + f" (world {time.perf_counter() - t0:.2f} s)")

    # (b), (c), (d): phase 10's read over S = 1, 2 in a world of 2 and over
    # S = 4 in a world of 4; the (2, 2) mesh and the file in those worlds.
    lr = dict(l=31, k=5, density=0.01, mode="hpcsimd")
    ragged = {"regular u64 l=31": dict(l=31, k=5, density=0.01, mode="regular", hash_width=64),
              "hpc nthash2 l=201": dict(l=201, k=5, density=0.01, mode="hpc",
                                        variant="nthash2")}
    worlds = {
        2: [("seq", "S=1", lr, (1, 1), ("long", long_path), 1),
            ("seq", "S=2", lr, (1, 2), ("long", long_path), 3),
            ("file", "file", file_path, FILE_ROWS_PER_RANK)],
        4: [("seq", "S=4", lr, (1, 4), ("long", long_path), 3)]
        + [("seq", what, kw, (2, 2), ("ragged", SEED + 4 + i, 4, 1 << 24), 1)
           for i, (what, kw) in enumerate(ragged.items())],
    }
    results = {}
    for world, jobs in worlds.items():
        t0 = time.perf_counter()
        ranks = run_world(parallel_rank, world, "gloo", dev, jobs)
        log(f"phase 12 world of {world} gloo ranks on the card: {time.perf_counter() - t0:.2f} s")
        for job in jobs:
            results[job[1]] = [r[job[1]] for r in ranks]

    def stitched(name, S):
        pieces = [r for r in results[name] if r is not None]
        for r in pieces:
            count(r["ran"], f"{name} rank")
        return stitch_segments(join_segments([r["seg"] for r in pieces], S))

    s1 = results["S=1"][0]
    check(isinstance(s1, str) and "2^28" in s1, f"S=1 was not refused: {s1!r}")
    log(f"phase 12 (b) S=1: refused, as it must be: {s1}")
    for S in (2, 4):
        name = f"S={S}"
        st = stitched(name, S)
        nk = int(st.n_kminmers[0])
        hi, lo = (a[0, :nk].astype(np.uint64) for a in (st.hash_hi, st.hash_lo))
        got = {"hash": (hi << np.uint64(32)) | lo, "start": st.start[0, :nk].astype(np.int64),
               "end": st.end[0, :nk].astype(np.int64), "offset": np.arange(nk, dtype=np.int64),
               "rev": st.rev[0, :nk]}
        for key in long_recs:
            check(got[key].dtype == long_recs[key].dtype
                  and np.array_equal(got[key], long_recs[key]),
                  f"(b) {name}: field {key} differs from kminmers_long")
        ranks = results[name]
        walls = np.array([r["walls"] for r in ranks]).max(axis=0)
        log(f"phase 12 (b) {N_LONG}-base read hpcsimd l=31 over {name} gloo ranks on one card "
            f"({card}): the {nk} stitched records equal kminmers_long's on the card; walls "
            f"(the slowest rank's; first, warm, warm) "
            + ", ".join(f"{w:.4f}" for w in walls) + " s; K1 per shard (passes 1-2, then 1-3 "
            "from the carry; CUDA events, ranks sharing the card) "
            + ", ".join(f"{r['k1_ms']:.4f}" for r in ranks) + " ms; the two all-gathers per "
            "shard (host clock) " + "; ".join(
                ", ".join(f"{g:.6f}" for g in r["gathers"]) for r in ranks) + " s")
    for what, kw in ragged.items():
        st = stitched(what, 2)
        i = list(ragged).index(what)
        codes, lengths = ragged_batch(SEED + 4 + i, 4, 1 << 24)
        want = kminmers_batch(torch.from_numpy(codes).to(dev), torch.from_numpy(lengths).to(dev),
                              PipelineSpec(**kw))
        for field in ("n_kminmers", "n_minimizers", "n_minimizers_raw"):
            check(np.array_equal(getattr(st, field), getattr(want, field).cpu().numpy()),
                  f"(c) {what}: {field}")
        for field in st._fields:
            w = getattr(want, field).cpu().numpy()
            if w.ndim == 1:
                continue
            g = getattr(st, field)
            w = w.view(np.uint32) if g.dtype == np.uint32 else w
            counts = st.n_kminmers if field in ("hash_hi", "hash_lo", "start", "end",
                                                "rev") else st.n_minimizers
            for b, n in enumerate(counts):
                check(np.array_equal(g[b, :n], w[b, :n]), f"(c) {what}: {field} row {b}")
        log(f"phase 12 (c) [4, 2^24] {what} over a (2, 2) mesh of gloo ranks: the stitched "
            f"batch equals kminmers_batch on the card ({int(st.n_kminmers.sum())} k-min-mers)")
    # (d)
    ranks = results["file"]
    for _, ran, _ in ranks:
        count(ran, "(d) file rank")
    chunks = sorted(((c.batch_index, r, c) for r, (cs, _, _) in enumerate(ranks) for c in cs),
                    key=lambda x: x[:2])
    pos = 0
    for _, _, c in chunks:
        check(c.stream_start == pos, "(d) chunk stream offsets")
        pos += len(c.records["hash"])
    for key in file_recs:
        got = np.concatenate([c.records[key] for _, _, c in chunks])
        check(got.dtype == file_recs[key].dtype and np.array_equal(got, file_recs[key]),
              f"(d) column {key} differs from StreamingRunner.collect()")
    log(f"phase 12 (d) run_file_distributed, CLI defaults, 2 gloo ranks x {FILE_ROWS_PER_RANK} "
        f"rows on one card: the whole phase-11 file, {pos} records in {len(chunks)} chunks, "
        f"equal to StreamingRunner.collect() in all six columns; walls "
        + ", ".join(f"{w:.4f}" for _, _, w in ranks) + " s")
    return launches


# Phase 13's draw: fixed, so that every run checks the same sequences.
BURNIN_SEED = 20261017
BURNIN_CONFIGS, BURNIN_SEQS, BURNIN_GENERAL = 24, 6, 6
SUITE_SIZE, SUITE_STEPS = 32 << 20, 16  # the suite's default size: [32, 2^20]


def burnin_phase(dev) -> dict:
    """Phase 13, the burn-in on the card with the counters at 0 just
    before -> its launches.  Every sequence's records equal the oracle's;
    K1 and K2 launched for each fused-route sequence, the general scan for
    each general-route one and K4's HPC form for each of those in an hpc
    mode, K3 for every one."""
    import torch

    from rust_seq2kminmers_torch.ops.cuda import build
    from rust_seq2kminmers_torch.scripts import burnin

    build.launches.clear()
    counts = burnin.run(BURNIN_CONFIGS, BURNIN_SEQS, BURNIN_SEED, None, dev,
                        BURNIN_GENERAL, log=log)
    torch.cuda.synchronize()
    ran = dict(build.launches)
    log(f"phase 13 launches: {ran}; counts: {counts}")
    check(counts["sequences"] == (BURNIN_CONFIGS + BURNIN_GENERAL) * BURNIN_SEQS,
          "burn-in sequences")
    check(counts["general"] == BURNIN_GENERAL * BURNIN_SEQS and counts["general_hpc"] > 0,
          "burn-in general-route sequences")
    for name, need in (("fused_scan", counts["fused"]), ("slot_compact", counts["fused"]),
                       ("assemble", counts["sequences"]), ("general_scan", counts["general"]),
                       ("hpc_compact", counts["general_hpc"]), ("xcode", counts["sequences"])):
        check(ran.get(name, 0) >= need, f"the burn-in launched {name} {ran.get(name, 0)} "
              f"times for {need} sequences")
    return ran


def graph_memory(dev, pool):
    """The device memory the captured graphs hold: ``memory_reserved``
    after phase 13 (its ~100 keys), then over a ``kminmers_batch`` sweep of
    one spec over 120 shapes [2, 4096 i], every 20 shapes, as it is and
    after ``empty_cache``, once with the cap of ``graph.MAX_GRAPHS``
    captured steps a compiled pipeline and once with no cap.  The sweep's
    launches are not counted: it drives no path the counts read."""
    import torch

    from rust_seq2kminmers_torch import api
    from rust_seq2kminmers_torch.api import kminmers_batch
    from rust_seq2kminmers_torch.ops.cuda import build, graph
    from rust_seq2kminmers_torch.ops.pipeline import PipelineSpec

    def mib():
        torch.cuda.synchronize()
        return torch.cuda.memory_reserved(dev) / 2**20

    log(f"graph memory after phase 13: {mib():.1f} MiB reserved; the pipelines' cache "
        f"{api._cached_pipeline.cache_info()}")
    spec = PipelineSpec(l=31, k=5, density=0.01, mode="hpcsimd")
    cap = graph.MAX_GRAPHS
    t0 = time.perf_counter()
    for what, limit in (("no cap", 1 << 30), (f"cap {cap}", cap)):
        api._cached_pipeline.cache_clear()
        torch.cuda.empty_cache()
        graph.MAX_GRAPHS = limit
        try:
            seen = [f"0: {mib():.1f}"]
            for i in range(1, 121):
                kminmers_batch(pool[0][:2, : 4096 * i].contiguous(),
                               torch.full((2,), 4096 * i, dtype=torch.int32, device=dev), spec)
                if i % 20 == 0:
                    seen.append(f"{i}: {mib():.1f}")
            kept = len(api._cached_pipeline(spec).graphs)
            torch.cuda.empty_cache()
            seen.append(f"emptied: {mib():.1f}")
        finally:
            graph.MAX_GRAPHS = cap
        check(kept == min(limit, 120), f"graph memory, {what}: {kept} graphs kept")
        log(f"graph memory, kminmers_batch over 120 shapes [2, 4096 i], {what}: {kept} graphs "
            "kept; MiB reserved after i shapes " + ", ".join(seen))
    api._cached_pipeline.cache_clear()
    torch.cuda.empty_cache()
    build.launches.clear()
    log(f"graph memory sweeps: {time.perf_counter() - t0:.2f} s; {mib():.1f} MiB reserved after")


def suite_phase(dev) -> dict:
    """Phase 14, the per-stage suite on the card with the counters at 0
    just before its device cases -> their launches.  Then, apart from the
    counts: each pipeline case's checksum of one step on pool[0] equals
    ``kminmer_pipeline_plain``'s on the card, and the dense hash's first
    2^16 columns of row 0 equal the CPU's."""
    import torch

    from rust_seq2kminmers_torch import bench_suite as bs
    from rust_seq2kminmers_torch.ops.cuda import build
    from rust_seq2kminmers_torch.ops.pipeline import kminmer_pipeline, kminmer_pipeline_plain

    t0 = time.perf_counter()
    host = list(bs.host_cases(10_000))
    build.launches.clear()
    rows = list(bs.device_cases(SUITE_SIZE, SUITE_STEPS, dev))
    torch.cuda.synchronize()
    ran = dict(build.launches)
    for r in host + rows:
        log(json.dumps(r))
    B, L = bs.batch_shape(SUITE_SIZE)
    cases = bs.pipeline_cases(L)
    check([r["case"] for r in rows] == ["nthash32_dense_l31"] + [c for c, _ in cases]
          and len(host) == 9, "the suite's rows")
    check(all(r["backend"].startswith(bs.host_backend()) for r in host),
          "the suite's host rows name the host library that served them")
    check(all(r["backend"] == torch.cuda.get_device_name(0) and r["power_limit"]
              for r in rows), "the suite's rows name the card and its power limit")
    # A unit is one captured graph: its capture's warm-up runs one unit
    # eagerly, then one warm replay and UNITS timed replays.
    launched = len(cases) * (2 + bs.UNITS) * SUITE_STEPS
    log(f"phase 14 launches: {ran}")
    for name in ("fused_scan", "slot_compact", "assemble"):
        check(ran.get(name, 0) == launched,
              f"the suite launched {name} {ran.get(name, 0)} times, not {launched}")
    pool = bs.make_pool(B, L, dev)
    lengths = torch.full((B,), L, dtype=torch.int32, device=dev)
    for case, spec in cases:
        got = int(bs.checksum(kminmer_pipeline(pool[0], lengths, spec)))
        want = int(bs.checksum(kminmer_pipeline_plain(pool[0], lengths, spec)))
        check(got == want, f"{case}: checksum {got} on the kernels, {want} plain")
    n = 1 << 16
    got = bs.dense_hash(pool[0])[0, :n].cpu()
    check(torch.equal(got, bs.dense_hash(pool[0][:1, : n + 30].cpu())[0]),
          "nthash32_dense_l31 on the card against the CPU")
    log(f"phase 14: {len(host)} host and {len(rows)} device rows; {len(cases)} pipeline "
        f"checksums equal kminmer_pipeline_plain's on the card, the dense hash equals the "
        f"CPU's on [1, 2^16]; {time.perf_counter() - t0:.2f} s")
    return ran


def graph_phase(dev, card, pool, lengths, path_kernels, small, small_len) -> dict:
    """Phase 15, the compiled step (``make_pipeline``: captured CUDA
    graphs) -> the kernels' launches.  For each path at [B, L], the
    counters at 0 just before each use: the capture's warm-up launches the
    path's kernels once, the capture nothing, each replay what the capture
    recorded; a batch the graph returned equals eager ``kminmer_pipeline``
    and the plain pipeline, and survives a later call; then eager and
    A rescue after ``precompile_rescue`` captures nothing; a capture
    that fails raises.
    Last, the twin of ``bench.py`` at its defaults."""
    import torch

    from rust_seq2kminmers_torch import api
    from rust_seq2kminmers_torch.ops import pipeline
    from rust_seq2kminmers_torch.ops.cuda import build
    from rust_seq2kminmers_torch.ops.cuda import graph
    from rust_seq2kminmers_torch.ops.cuda.graph import CapturedStep
    from rust_seq2kminmers_torch.ops.pipeline import PipelineSpec
    from rust_seq2kminmers_torch.scripts import bench as twin

    t0 = time.perf_counter()
    launches = {}

    def counted():
        torch.cuda.synchronize()
        ran = dict(build.launches)
        for c, n in ran.items():
            launches[c] = launches.get(c, 0) + n
        build.launches.clear()
        return ran

    def same(got, want, what):
        for name, g, w in zip(want._fields, got, want):
            check(g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w),
                  f"{what}: field {name}")

    for path, (ps, used, unused) in path_kernels.items():
        once = {c: 1 for c in used}
        fn = pipeline.make_pipeline(ps)
        build.launches.clear()
        fn.capture(pool[0], lengths)
        check(counted() == once, f"phase 15 {path}: the capture's warm-up launches")
        (step,) = fn.graphs.values()
        check(dict(step.launches) == once, f"phase 15 {path}: the capture recorded "
              f"{dict(step.launches)}")
        first = fn(pool[0], lengths)
        ran = counted()
        check(ran == once, f"phase 15 {path}: a replay counted {ran}")
        kept = [t.clone() for t in first]
        second = fn(pool[1], lengths)
        counted()
        # The comparisons' own launches do not count.
        same(first, pipeline.kminmer_pipeline(pool[0], lengths, ps), f"{path} graph vs eager")
        same(second, pipeline.kminmer_pipeline(pool[1], lengths, ps), f"{path} graph vs eager")
        same(first, pipeline.kminmer_pipeline_plain(pool[0], lengths, ps),
             f"{path} graph vs plain")
        build.launches.clear()
        check(all(torch.equal(g, w) for g, w in zip(first, kept)),
              f"phase 15 {path}: a later call changed an earlier batch")
        log(f"phase 15 {path} path [{B}, {L}]: the capture's warm-up launched {once}, the "
            f"capture nothing, each replay {dict(step.launches)}; the graph's 12 fields equal "
            "eager kminmer_pipeline and the plain pipeline on the card, and a batch survives "
            "a later call")
        del fn, first, second, kept

    # The rescue after precompile_rescue: a tile overflow, M ample.
    rs = PipelineSpec(l=11, k=3, density=0.05, mode="hpcsimd", max_minimizers=8192,
                      tile_cap=8)
    api.precompile_rescue(rs, tuple(small.shape), dev)
    api._cached_pipeline(rs).capture(small, small_len)
    retries, real = [], (api.rescue_spec, graph.CapturedStep)

    def no_capture(*args):
        raise RuntimeError("FAILED: a capture after precompile_rescue")

    api.rescue_spec = lambda s_, n=0: retries.append(n) or real[0](s_, n)
    graph.CapturedStep = no_capture
    try:
        out = api.kminmers_batch(small, small_len, rs)
    finally:
        api.rescue_spec, graph.CapturedStep = real
    counted()
    check(len(retries) == 1 and real[0](rs, retries[0]) == real[0](rs),
          f"phase 15 rescue: retries {retries}")
    check(torch.equal(out.n_minimizers, out.n_minimizers_raw), "phase 15 rescue lost minimizers")
    same(type(out)(*(t.cpu() for t in out)), api.kminmers_batch(small.cpu(), small_len.cpu(), rs),
         "phase 15 rescue vs CPU")
    log(f"phase 15 rescue [4, 2^16] hpcsimd l=11 tile_cap=8 after precompile_rescue: one "
        f"retry, replays only (no capture), lossless ({int(out.n_minimizers.sum())} "
        "minimizers), all 12 fields equal the CPU run")

    # A capture that fails raises, and leaves the card and the counters.
    try:
        CapturedStep(lambda t: (t + int(t.sum()),), (small_len,), dev)
        failed = None
    except RuntimeError as e:
        failed = e
    check(failed is not None, "phase 15: a capture with a host sync inside did not raise")
    check(not build.launches and int((small_len + 1).sum()) == 4 * ((1 << 16) + 1),
          "phase 15: the card after a failed capture")
    log(f"phase 15: a capture with a host sync inside raises {type(failed).__name__}: "
        f"{(str(failed).splitlines() or [''])[0][:120]}")

    rec = twin.run()
    counted()
    log(json.dumps(rec))
    check(rec["value"] > 0 and rec["detail"]["device"].startswith(card.split(",")[0]),
          "the twin's line")
    log(f"phase 15: {time.perf_counter() - t0:.2f} s")
    return launches


def main():
    t_script = time.perf_counter()
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    from rust_seq2kminmers_torch import api, kminmers_list, kminmers_long, kminmers_long_batch
    from rust_seq2kminmers_torch.api import kminmers_batch
    from rust_seq2kminmers_torch.constants import CODE_PAD, with_keep_bits
    from rust_seq2kminmers_torch.ops.assemble import assemble_masked_plain, assemble_plain
    from rust_seq2kminmers_torch.ops.compact import compact
    from rust_seq2kminmers_torch.ops.cuda import build
    from rust_seq2kminmers_torch.ops.cuda.assemble_kernel import (
        assemble_kminmers_cuda,
        assemble_masked_cuda,
    )
    from rust_seq2kminmers_torch.ops.cuda.fused_scan import (
        TILE,
        fused_minimizer_scan,
        fused_scan_plain,
        tile_carries,
        tile_carries_plain,
        valid_slots,
    )
    from rust_seq2kminmers_torch.ops.cuda.inrow_compact import (
        inrow_compact_ballot,
        inrow_compact_mma,
        inrow_compact_plain,
    )
    from rust_seq2kminmers_torch.ops.cuda.general_scan import (
        general_minimizers,
        general_minimizers_plain,
    )
    from rust_seq2kminmers_torch.ops.cuda.masked_compact import hpc_compact, masked_compact
    from rust_seq2kminmers_torch.ops.cuda.slot_compact import (
        slot_compact,
        slot_compact_counts,
        slot_compact_counts_plain,
        slot_compact_plain,
    )
    from rust_seq2kminmers_torch.ops.cuda.xcode import encode_xcodes_cuda
    from rust_seq2kminmers_torch.ops.hpc import hpc_compress_packed, hpc_keep_mask
    from rust_seq2kminmers_torch.ops.xcode import READ_START, XCODE_ROW, encode_xcodes_plain
    from rust_seq2kminmers_torch import tracing
    from rust_seq2kminmers_torch.ops import long_read
    from rust_seq2kminmers_torch.ops.long_read import minimizer_stream_long
    from rust_seq2kminmers_torch.ops.pipeline import (
        PipelineSpec,
        kminmer_pipeline,
        kminmer_pipeline_plain,
    )
    from rust_seq2kminmers_torch.scripts import prof_mxu_compact as prof
    from rust_seq2kminmers_torch.scripts import prof_long_read
    from rust_seq2kminmers_torch.scripts.common import NOT_MEASURED, cards, event_ms, profile

    # 1. the card
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    smi = cards()
    card = smi[0]
    log("\n".join(smi))
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 2. the build
    lib = build.library()
    how = "built" if lib.built else "loaded an earlier build"
    log(f"build: {how} in {lib.seconds:.2f} s -> {lib.path.relative_to(REPO)}")
    ptxas = [ln for ln in lib.log.splitlines()
             if "ptxas" in ln or "spill" in ln or ln.startswith("==")]
    check(ptxas, "no ptxas lines in the nvcc log")
    for ln in ptxas:
        log(f"  {ln}")

    # The batches: random ACGT with keep bits, full-length reads, two
    # distinct batches so that consecutive timed steps miss the L2.
    spec = PipelineSpec(
        l=31, k=5, density=0.01, mode="hpcsimd",
        max_minimizers=int(L * 0.02) + 256,
    )
    general_spec = PipelineSpec(
        l=301, k=5, density=0.01, mode="hpcsimd", variant="nthash2"
    )
    u64_spec = PipelineSpec(l=31, k=5, density=0.01, mode="regular", hash_width=64)
    check(spec.fused and u64_spec.fused and not general_spec.fused, "routes")
    rng = np.random.default_rng(SEED)
    pool = [
        torch.from_numpy(with_keep_bits(rng.integers(0, 4, (B, L), dtype=np.uint8)))
        .to(dev)
        for _ in range(2)
    ]
    codes = pool[0]
    lengths = torch.full((B,), L, dtype=torch.int32, device=dev)
    limit = torch.full((B,), 1 << 30, dtype=torch.int32, device=dev)
    m_cap = spec.capacity_for(L)
    cap = spec.cap_per_tile(TILE)
    scan_args = (spec.l, spec.bound, spec.strict_threshold, spec.is_hpc, False)

    # 3. each kernel against its plain version, at the paths' shapes
    def max_abs_err(got, want):
        return max(
            float((g.to(torch.float64) - w.to(torch.float64)).abs().max())
            for g, w in zip(got, want)
        )

    def flat(rows):  # (start, end, hash) with a (hi, lo) hash flattened
        return [*rows[:2], *(rows[2] if isinstance(rows[2], tuple) else rows[2:])]

    errs = {}

    def record(name, what, err):
        log(f"{name} [{what}]: kernel vs plain max_abs_err={err} "
            "(tolerance 0: bit-exact)")
        check(err == 0, f"{name} [{what}] kernel differs from its plain version")
        errs[name] = max(errs.get(name, 0.0), err)

    k1 = fused_minimizer_scan(codes, lengths, limit, *scan_args, TILE, cap)
    k1p = fused_scan_plain(codes, lengths, limit, *scan_args, TILE, cap)
    record("fused_scan", "u32 hpcsimd l=31",
           max_abs_err([valid_slots(t, k1[3]) for t in k1[:3]] + [k1[3]], k1p))
    got_c = tile_carries(codes, lengths, spec.l, TILE, True)
    want_c = tile_carries_plain(codes, lengths, spec.l, TILE, True)
    record("fused_scan", "passes 1-2 (ranks, pending prefixes) vs tile_carries_plain",
           max_abs_err(got_c, want_c))
    del got_c, want_c
    n_raw_tiles = int(k1[3][:, :, 1].sum())
    check(n_raw_tiles > 0, "K1 selected no minimizer")
    check(bool((k1[3][:, :, 0] == k1[3][:, :, 1]).all()), "K1 tile overflow")
    kept = k1[3][:, :, 0].contiguous()
    k2 = slot_compact(*k1[:3], kept, m_cap)
    k2p = slot_compact_plain(*k1[:3], kept, m_cap)
    record("slot_compact", "u32, kept form", max_abs_err([*k2[0], k2[1]], [*k2p[0], k2p[1]]))
    k2c = slot_compact_counts(*k1[:3], k1[3], m_cap)
    k2cp = slot_compact_counts_plain(*k1[:3], k1[3], m_cap)
    record("slot_compact", "u32, K1's counts in place -> n_min, n_raw (the main path's form)",
           max_abs_err([*k2c[0], *k2c[1:]], [*k2cp[0], *k2cp[1:]]))
    min_hash = k2[0][2]
    n_main = k2c[1]  # the stream's counts, for K3's masked form
    k3 = assemble_kminmers_cuda(min_hash, spec.k)
    k3p = assemble_plain(min_hash, spec.k)
    record("assemble", "xorshift u32", max_abs_err([*k3[0], k3[1]], [*k3p[0], k3p[1]]))
    # Per-row counts 0, k-1, k, M, then random: every masking edge.
    g_n = torch.Generator(device=dev).manual_seed(SEED)
    n_var = torch.randint(0, m_cap + 1, (B,), generator=g_n, device=dev, dtype=torch.int32)
    n_var[:4] = torch.tensor([0, spec.k - 1, spec.k, m_cap], dtype=torch.int32)
    pos_main = (k2[0][0], k2[0][1])
    for what, n_rows in (("the stream's counts", n_main), ("counts 0, k-1, k, M, random", n_var)):
        got = assemble_masked_cuda(min_hash, spec.k, 32, None, n_rows, *pos_main)
        want = assemble_masked_plain(min_hash, spec.k, 32, None, n_rows, *pos_main)
        record("assemble", f"masked xorshift u32, {what}", max_abs_err(got, want))

    # K1 at the other widths (per tile cap = the tile: lossless), then K2
    # with the hi column and K3 on the width-64 stream.
    width_scans = {}
    for mode, w, v in (("regular", 16, "nthash1"), ("regular", 64, "nthash1"),
                       ("hpcsimd", 32, "nthash2")):
        ws = PipelineSpec(l=31, k=5, density=0.01, mode=mode, hash_width=w, variant=v)
        lim = limit if ws.is_hpc else torch.full_like(lengths, L - ws.l)
        args = (codes, lengths, lim, ws.l, ws.bound, ws.strict_threshold,
                ws.is_hpc, False, TILE, TILE, w, v)
        got, want = fused_minimizer_scan(*args), fused_scan_plain(*args)
        record("fused_scan", f"width {w} {v} {mode} l=31", max_abs_err(
            [valid_slots(t, got[3]) for t in flat(got[:3])] + [got[3]],
            flat(want[:3]) + [want[3]]))
        check(int(got[3][:, :, 1].sum()) > 0, f"K1 width {w} {v} selected nothing")
        width_scans[w, v] = (args, got)
    got64 = width_scans[64, "nthash1"][1]
    kept64 = got64[3][:, :, 0].contiguous()
    m64 = u64_spec.capacity_for(L)
    k2_64 = slot_compact(*got64[:3], kept64, m64)
    k2p_64 = slot_compact_plain(*got64[:3], kept64, m64)
    record("slot_compact", "with hash_hi", max_abs_err(
        flat(k2_64[0]) + [k2_64[1]], flat(k2p_64[0]) + [k2p_64[1]]))
    hi64, lo64 = k2_64[0][2]
    mix_inputs = {
        16: (torch.bitwise_and(min_hash, 0xFFFF), None),
        64: (lo64, hi64),
    }
    for w, (lo, hi) in mix_inputs.items():
        mix = "murmur u16" if w == 16 else "identity u64"
        got = assemble_kminmers_cuda(lo, spec.k, w, hi)
        want = assemble_plain(lo, spec.k, w, hi)
        record("assemble", mix, max_abs_err([*got[0], got[1]], [*want[0], want[1]]))
        pos = pos_main if w == 16 else k2_64[0][:2]
        got = assemble_masked_cuda(lo, spec.k, w, hi, n_var, *pos)
        want = assemble_masked_plain(lo, spec.k, w, hi, n_var, *pos)
        record("assemble", f"masked {mix}, counts 0, k-1, k, M, random",
               max_abs_err(got, want))

    # K4 (a): the dense packed HPC compaction, one column, m = L.
    keep = hpc_keep_mask(codes, lengths)
    j = torch.arange(L, dtype=torch.int32, device=dev)
    packed = (j[None, :] << 3) | (codes & 7).to(torch.int32)
    hpc_args = (keep, [packed], L, [(L << 3) | CODE_PAD])
    got, want = masked_compact(*hpc_args), compact(*hpc_args)
    record("masked_compact", "(a) dense HPC, m = L", max_abs_err(
        [*got[0], got[1]], [*want[0], want[1]]))
    log(f"  (a) kept {int(got[1].sum())} of {B * L} bases")
    # K4 (b): 3 columns at a 1% mask, m = capacity_for(L).
    nwin = L - spec.l + 1
    g = torch.Generator(device=dev).manual_seed(SEED)
    sel = torch.rand((B, nwin), generator=g, device=dev) < 0.01
    st = torch.arange(nwin, dtype=torch.int32, device=dev).expand(B, nwin).contiguous()
    hs = torch.randint(-(2**31), 2**31 - 1, (B, nwin), generator=g, device=dev,
                       dtype=torch.int32)
    min_args = (sel, [st, st + (spec.l - 1), hs], spec.capacity_for(L), [0, 0, 0])
    got, want = masked_compact(*min_args), compact(*min_args)
    record("masked_compact", "(b) 3 columns, 1% mask", max_abs_err(
        [*got[0], got[1]], [*want[0], want[1]]))
    n_sel_b = int(want[1].sum())
    # K4's HPC form, read from the xcodes: the general path's first stage.
    got, want = hpc_compact(codes, lengths), hpc_compress_packed(codes, lengths)
    record("masked_compact", "HPC form from the xcodes, m = L", max_abs_err(got, want))
    general_stream = got
    # The general scan in three configurations, on the streams the general
    # path gives it: the HPC form's packed column, or the xcodes.
    general_cases = {
        "hpcsimd nthash2 l=301": general_spec,
        "regular u64 l=400": PipelineSpec(l=400, k=5, density=0.01, mode="regular",
                                          hash_width=64),
        "regular u32 l=1 d=0.3": PipelineSpec(l=1, k=5, density=0.3, mode="regular"),
    }

    def general_args(gs):
        stream, eff = general_stream if gs.is_hpc else (codes, lengths)
        return (stream, eff, lengths, gs.l, gs.bound, gs.strict_threshold, gs.mode,
                gs.hash_width, gs.variant, gs.capacity_for(L))

    for what, gs in general_cases.items():
        got = general_minimizers(*general_args(gs))
        want = general_minimizers_plain(*general_args(gs))
        check((got[3] is None) == (want[3] is None), "hash_hi presence")
        record("general_scan", what, max_abs_err(
            [g for g in got if g is not None], [w for w in want if w is not None]))
        check(int(got[5].sum()) > 0, f"general scan {what} selected nothing")
        log(f"  general scan {what}: {int(got[5].sum())} minimizers selected, "
            f"m = {gs.capacity_for(L)}")
    # xcode at its callers' shapes: (raw, prev, lengths) by case.
    text = torch.from_numpy(text_rows(SEED + 4, B, L)).to(dev)
    rng_x = np.random.default_rng(SEED + 4)
    ragged_len = rng_x.integers(0, L + 1, B).astype(np.int32)
    ragged_len[:4] = [0, 1, 15, 17]
    ragged_prev = np.full(B, READ_START, dtype=np.int32)
    ragged_prev[4] = 65  # a row continuing after an 'A'
    ragged_prev[-1] = XCODE_ROW
    read_x = torch.from_numpy(text_rows(SEED + 5, 1, (1 << 25) + 1)).to(dev)
    xcode_cases = {
        f"[{B}, {L}] full rows": (text, torch.full((B,), READ_START, dtype=torch.int32,
                                                   device=dev), lengths),
        f"[{B}, {L}] ragged, a row of xcodes": (
            text, torch.from_numpy(ragged_prev).to(dev), torch.from_numpy(ragged_len).to(dev)),
        "[1, 2^25] long-read chunk, prev a real byte": (
            read_x[:, 1:].clone(), read_x[:, 0].to(torch.int32),
            torch.full((1,), 1 << 25, dtype=torch.int32, device=dev)),
        # the same chunk as a view one byte past an allocation: byte accesses
        "[1, 2^25] unaligned view, prev a real byte": (
            read_x[:, 1:], read_x[:, 0].to(torch.int32),
            torch.full((1,), 1 << 25, dtype=torch.int32, device=dev)),
    }
    for family in ("scalar", "simd"):
        for what, args in xcode_cases.items():
            record("xcode", f"{family} {what}", max_abs_err(
                [encode_xcodes_cuda(*args, family)], [encode_xcodes_plain(*args, family)]))
    del got, want, read_x
    torch.cuda.synchronize()

    counters = sorted({c for cs in COUNTERS.values() for c in cs})
    launches = {c: 0 for c in counters}

    # 4. the goldens, on the card, from the fixture's str; counters at 0
    seq = (REPO / "tests/data/ecoli.genome.100k.fa").read_text().split("\n")[1]
    build.launches.clear()
    for name in ("goldens_u32.json", "goldens_u64.json"):
        golden = json.loads((REPO / "tests/data" / name).read_text())
        recs = kminmers_list(
            seq, golden["l"], golden["k"], golden["density"], golden["mode"],
            device=dev, hash_width=golden["hash_width"],
        )
        check([r.hash for r in recs] == golden["hashes"], name)
        log(f"goldens: {len(recs)} u{golden['hash_width']} k-min-mer hashes "
            "equal the reference's")
    torch.cuda.synchronize()
    ran = {c: build.launches[c] for c in counters}
    log(f"goldens launches: {ran}")
    check(ran["xcode"] == 2, f"the goldens' str was encoded {ran['xcode']} times, not 2")
    for name in counters:
        launches[name] += ran[name]

    # 5. each path through the user entry point, counters at 0 just before
    # (spec, counters launched once each, counters never launched)
    general_only = ("hpc_compact", "general_scan", "masked_compact")
    path_kernels = {
        "main": (spec, ("fused_scan", "slot_compact", "assemble"), general_only),
        "general": (general_spec, ("hpc_compact", "general_scan", "assemble"),
                    ("fused_scan", "slot_compact", "masked_compact")),
        "u64": (u64_spec, ("fused_scan", "slot_compact", "assemble"), general_only),
    }
    for path, (ps, used, unused) in path_kernels.items():
        api._cached_pipeline(ps).capture(codes, lengths)  # so the run below replays
        build.launches.clear()
        out = kminmers_batch(codes, lengths, ps)
        torch.cuda.synchronize()
        ran = {c: build.launches[c] for c in counters}
        log(f"{path} path launches: {ran}")
        for name in used:
            check(ran[name] == 1, f"the {path} path launched {name} {ran[name]} times, not once")
            launches[name] += ran[name]
        for name in unused:
            check(ran[name] == 0, f"the {path} path launched {name}")
        plain = kminmer_pipeline_plain(codes, lengths, ps)
        torch.cuda.synchronize()
        for name, gv, wv in zip(out._fields, out, plain):
            check(gv.shape == wv.shape and gv.dtype == wv.dtype, f"{name} shape/dtype")
            check(torch.equal(gv, wv), f"{path} path field {name} differs from plain")
        mk = out.min_hash.shape[1] - ps.k + 1
        check(tuple(out.hash_lo.shape) == (B, mk), "k-min-mer shape")
        check(torch.equal(out.n_minimizers, out.n_minimizers_raw), "minimizers lost")
        if ps.hash_width == 64:
            check(int(out.min_hash_hi.abs().sum()) > 0, "no high hash words")
        n_km = int(out.n_kminmers.sum())
        check(n_km > 0, f"{path} path: no k-min-mers")
        log(f"{path} path [{B}, {L}] {ps.mode} w{ps.hash_width} {ps.variant} "
            f"l={ps.l}: all 12 KminmerBatch fields equal the plain pipeline on "
            f"the card; {n_km} k-min-mers, {int(out.n_minimizers.sum())} minimizers")

    # The overflow rescue on the card: capacities far below the count force
    # kminmers_batch to retry, on the fused and on the general route; it must
    # end lossless and equal its run on the CPU.
    small = pool[0][:4, : 1 << 16].contiguous()
    small_len = torch.full((4,), 1 << 16, dtype=torch.int32, device=dev)
    real_rescue = api.rescue_spec
    for route, rs in (
        ("fused", PipelineSpec(l=11, k=3, density=0.05, mode="hpcsimd", max_minimizers=64,
                               tile_cap=8)),
        ("general", PipelineSpec(l=301, k=3, density=0.05, mode="hpc", max_minimizers=64)),
    ):
        retries = []

        def counted_rescue(s_, needed=0, seen=retries):
            seen.append(needed)
            return real_rescue(s_, needed)

        api.rescue_spec = counted_rescue
        try:
            out = kminmers_batch(small, small_len, rs)
        finally:
            api.rescue_spec = real_rescue
        torch.cuda.synchronize()
        want = kminmers_batch(small.cpu(), small_len.cpu(), rs)
        check(len(retries) >= 1, f"the {route} rescue check never retried")
        check(torch.equal(out.n_minimizers, out.n_minimizers_raw),
              f"the {route} rescue lost minimizers")
        for name, gv, wv in zip(out._fields, out, want):
            check(torch.equal(gv.cpu(), wv), f"{route} rescue field {name} differs from the CPU")
        log(f"rescue on the {route} route [4, 2^16] {rs.mode} l={rs.l} M=64: "
            f"{len(retries)} retry, lossless ({int(out.n_minimizers.sum())} minimizers), "
            "all 12 fields equal the CPU run")

    # 6. timing (CUDA events, after warm-up)
    def gbps(ms):
        return B * L / (ms * 1e-3) / 1e9

    torch.cuda.reset_peak_memory_stats(dev)
    live = torch.cuda.memory_allocated(dev)  # the inputs and earlier results
    step_ms = event_ms(lambda i: kminmer_pipeline(pool[i % 2], lengths, spec), 20)
    peak_gib = (torch.cuda.max_memory_allocated(dev) - live) / 2**30
    plain_step_ms = event_ms(
        lambda i: kminmer_pipeline_plain(pool[i % 2], lengths, spec), 3, 1
    )
    log(f"main path step [{B}, {L}] hpcsimd on {card}: {step_ms:.4f} ms = "
        f"{gbps(step_ms):.4f} GB/s (plain pipeline {plain_step_ms:.4f} ms = "
        f"{gbps(plain_step_ms):.4f} GB/s); peak device memory of a step "
        f"{peak_gib:.3f} GiB above what was live")
    for path in ("general", "u64"):
        ps = path_kernels[path][0]
        t = event_ms(lambda i: kminmer_pipeline(pool[i % 2], lengths, ps), 10)
        tp = event_ms(lambda i: kminmer_pipeline_plain(pool[i % 2], lengths, ps), 3, 1)
        log(f"{path} path step [{B}, {L}] on {card}: {t:.4f} ms = {gbps(t):.4f} "
            f"GB/s (plain pipeline {tp:.4f} ms = {gbps(tp):.4f} GB/s)")

    k1_runs = [
        fused_minimizer_scan(c, lengths, limit, *scan_args, TILE, cap) for c in pool
    ]
    # The general scan's arguments on the general path, for each batch.
    general_main = [(*hpc_compact(c, lengths), *general_args(general_spec)[2:])
                    for c in pool]
    # K2 and K3 as the main path calls them: K2 reads K1's counts in place,
    # K3 writes the masked k-min-mer fields.
    def k2_main(i):
        return slot_compact_counts(*k1_runs[i % 2][:3], k1_runs[i % 2][3], m_cap)

    def k3_main(i):
        return assemble_masked_cuda(min_hash, spec.k, 32, None, n_main, *pos_main)

    ms = {
        "fused_scan": event_ms(
            lambda i: fused_minimizer_scan(
                pool[i % 2], lengths, limit, *scan_args, TILE, cap), 20),
        "slot_compact": event_ms(k2_main, 50),
        "assemble": event_ms(k3_main, 50),
        # K4 as the general path calls it: its HPC form.
        "masked_compact": event_ms(lambda i: hpc_compact(pool[i % 2], lengths), 20),
        "general_scan": event_ms(lambda i: general_minimizers(*general_main[i % 2]), 20),
    }
    plain_ms = {
        "fused_scan": event_ms(
            lambda i: fused_scan_plain(
                pool[i % 2], lengths, limit, *scan_args, TILE, cap), 3, 1),
        "slot_compact": event_ms(
            lambda i: slot_compact_counts_plain(
                *k1_runs[i % 2][:3], k1_runs[i % 2][3], m_cap), 10),
        "assemble": event_ms(
            lambda i: assemble_masked_plain(min_hash, spec.k, 32, None, n_main, *pos_main),
            10),
        "masked_compact": event_ms(lambda i: hpc_compress_packed(pool[i % 2], lengths), 3, 1),
        "general_scan": event_ms(
            lambda i: general_minimizers_plain(*general_main[i % 2]), 3, 1),
    }
    for name in ms:
        log(f"{name} on {card}: kernel {ms[name]:.4f} ms (CUDA events), plain "
            f"{plain_ms[name]:.4f} ms")
    # K1 per instance beside its bound; the bound of every kernel at the
    # shape its `ms` was timed.
    def k1_line(what, t, bnd):
        log(f"K1 {what} on {card}: {t:.4f} ms (bound {bnd[0]:.4f} ms by {bnd[1]})")

    bounds = {"fused_scan": k1_bound(codes, k1[3], 32)}
    k1_line("u32 hpcsimd l=31", ms["fused_scan"], bounds["fused_scan"])
    for (w, v), (args, got) in width_scans.items():
        mode = "hpcsimd" if args[6] else "regular"
        k1_line(f"width {w} {v} {mode} l=31",
                event_ms(lambda i, a=args: fused_minimizer_scan(*a), 20),
                k1_bound(args[0], got[3], w))

    def k2_bound(kept_t, m, fill):
        """K2's bound (``k2_bound_s``); without the fill, which that does not
        count, the survivors are written in place of the m slots."""
        surv = int(kept_t.sum())
        rows, nt_ = kept_t.shape
        if fill:
            return bound(k2_bound_s, rows, nt_, surv, m)
        return bound(bound_s, surv * 12 + rows * nt_ * 8 + surv * 12 + rows * 8, 3 * surv)

    bounds["slot_compact"] = k2_bound(kept, m_cap, True)
    # K3 masked, on the stream's counts (``k3_bound_s``).
    bounds["assemble"] = bound(k3_bound_s, B, n_main.tolist(), spec.k, min_hash.shape[1])
    # K4's least work: the mask (or xcodes) read once, each selected
    # element of each column read once, every output slot and the count
    # written once; a test and a rank (2 operations) an element.
    n_hpc = int(hpc_args[0].sum())
    k4_bounds = {
        "(a) dense HPC": bound(bound_s, B * L + n_hpc * 4 + B * L * 4 + B * 4, 2 * B * L),
        "(b) 3 columns, 1% mask": bound(
            bound_s, B * nwin + n_sel_b * 12 + B * min_args[2] * 12 + B * 4, 2 * B * nwin),
        # the xcodes and lengths read, the packed column and count written
        "HPC form": bound(bound_s, B * L + B * 4 + B * L * 4 + B * 4, 3 * B * L),
    }
    bounds["masked_compact"] = k4_bounds["HPC form"]
    # (b)'s bound counts 4 bytes a selected element; the card reads a whole
    # 32-byte sector for each, and at a 1% mask few sectors hold two.
    sel_flat = torch.nonzero(min_args[0].reshape(-1)).squeeze(1)
    sectors = int(torch.unique(sel_flat // 8).numel())
    log(f"K4 (b): {sectors} 32-byte sectors of each column hold a selected element; "
        "reading them, the mask and the output once takes "
        f"{(B * nwin + 3 * sectors * 32 + B * min_args[2] * 12 + B * 4) / HBM_BYTES_PER_S * 1e3:.4f}"
        " ms at the HBM rate")

    def general_bound(gs):
        """The general scan's least work on this run's inputs: of each row
        with lengths > l, the stream's first eff_len elements read once (4
        bytes a packed element, 1 a code; no window reads past them),
        lengths and eff_len read, every output slot (12 bytes, 16 at width
        64) and n_min, n_raw written; per window its two terms, two prefix
        XORs, the window's two XORs and rotations, the min and the compare
        (10 operations)."""
        stream, eff, lens, l_ = general_args(gs)[:4]
        live = lens > l_
        need = int(torch.where(live, eff.clamp(max=L), 0).sum())
        n_win = int(torch.where(
            live, (eff - l_ + 1 - int(gs.mode == "hpc")).clamp(0, L - l_ + 1), 0).sum())
        m_ = gs.capacity_for(L)
        return bound(bound_s, need * stream.element_size() + B * 8
                     + B * m_ * (16 if gs.hash_width == 64 else 12) + B * 8, 10 * n_win)

    bounds["general_scan"] = general_bound(general_spec)
    for name in bounds:
        log(f"bound of {name} on these inputs: {bounds[name][0]:.4f} ms by {bounds[name][1]}")

    # Device time under the profiler.  In key_averages() an aten:: row
    # repeats its kernels' time, so only the kernels' own events are summed.
    k2_keys = ("slot_compact_offsets", "slot_compact_copy")
    k3_keys = ("assemble_kernel",)

    def device_ms(fn, keys, reps=20):
        """(device ms, kernels, device ms by kernel) a call of fn, over the
        kernels whose names hold one of ``keys``, under the profiler after
        a warm-up call.  Where no profiler session recorded a device event,
        (CUDA-event ms, None, {}): the CUDA events time the launches too."""
        fn(0)
        torch.cuda.synchronize()
        p = profile(fn, reps, keys)
        if p is None:
            return event_ms(fn, reps), None, {}
        check(p.events, f"the profiler recorded no kernel named {keys}")
        by_kernel = {k: ms for k, (_, ms) in p.by_kernel.items()}
        return sum(by_kernel.values()), p.events, by_kernel

    def timed_by(n_k, by_kernel=None) -> str:
        """How device_ms timed a call."""
        if n_k is None:
            return f"CUDA events: {NOT_MEASURED}"
        return f"{n_k:.0f} kernels a call; profiler" + (
            ": " + ", ".join(f"{k} {v:.4f}" for k, v in by_kernel.items())
            if by_kernel else "")

    dev_ms = {
        "slot_compact main": (k2_main, k2_keys),
        "slot_compact with hash_hi": (
            lambda i: slot_compact(*got64[:3], kept64, m64), k2_keys),
        "assemble masked xorshift main": (k3_main, k3_keys),
        "assemble xorshift main, unmasked": (
            lambda i: assemble_kminmers_cuda(min_hash, spec.k), k3_keys),
        "assemble masked murmur u16": (lambda i: assemble_masked_cuda(
            mix_inputs[16][0], spec.k, 16, None, n_main, *pos_main), k3_keys),
        "assemble masked identity u64": (lambda i: assemble_masked_cuda(
            lo64, spec.k, 64, hi64, n_var, *k2_64[0][:2]), k3_keys),
    }
    for what, (fn, keys) in dev_ms.items():
        dev_ms[what] = device_ms(fn, keys)
        log(f"{what} on {card}: device {dev_ms[what][0]:.4f} ms a call "
            f"({timed_by(dev_ms[what][1])})")
    # The kernels' line reports K2's and K3's device time: CUDA events
    # around their back-to-back launches time the host at this size.
    ms["slot_compact"] = dev_ms["slot_compact main"][0]
    ms["assemble"] = dev_ms["assemble masked xorshift main"][0]

    # 10 steps of each path under the profiler: the busy time is the union
    # of the kernels' and copies' spans.
    for path in ("main", "general"):
        ps = path_kernels[path][0]
        p = profile(lambda i: kminmer_pipeline(pool[i % 2], lengths, ps), 10)
        if p is None:
            log(f"{path} path under the profiler on {card}: {NOT_MEASURED}")
            continue
        log(f"{path} path under the profiler on {card}: device busy {p.busy_ms:.4f} ms a step "
            f"of {p.wall_ms:.4f} ms wall (idle share {p.idle_share:.4f}); {p.kernels:.1f} device "
            f"kernels a step ({p.events:.1f} device events); device ms a step "
            + ", ".join(f"{k} {ms:.4f}" for k, (_, ms) in
                        sorted(p.by_kernel.items(), key=lambda kv: -kv[1][1])))

    # K4's two masked cases, its HPC form and the general scan: CUDA events
    # and device time under the profiler, beside the bound and the plain
    # version.  (what, kernel, plain, bound)
    k4_general = [
        ("masked_compact (a) dense HPC", lambda i: masked_compact(*hpc_args),
         lambda i: compact(*hpc_args), k4_bounds["(a) dense HPC"]),
        ("masked_compact (b) 3 columns, 1% mask", lambda i: masked_compact(*min_args),
         lambda i: compact(*min_args), k4_bounds["(b) 3 columns, 1% mask"]),
        ("masked_compact HPC form", lambda i: hpc_compact(pool[i % 2], lengths),
         lambda i: hpc_compress_packed(pool[i % 2], lengths), k4_bounds["HPC form"]),
    ]
    for what, gs in general_cases.items():
        k4_general.append((f"general_scan {what}",
                           lambda i, a=general_args(gs): general_minimizers(*a),
                           lambda i, a=general_args(gs): general_minimizers_plain(*a),
                           general_bound(gs)))
    k4_seen = {}
    for what, kern, plain, bnd in k4_general:
        t_ev = event_ms(kern, 20)
        t_dev, n_k, by_kernel = device_ms(kern, ("kernel",))
        t_plain = event_ms(plain, 3, 1)
        k4_seen[what] = t_dev
        log(f"{what} on {card}: device {t_dev:.4f} ms a call ({timed_by(n_k, by_kernel)}), "
            f"{t_ev:.4f} ms (CUDA events); bound {bnd[0]:.4f} ms by {bnd[1]} "
            f"({bnd[0] / t_dev:.3f} of the bound reached); plain {t_plain:.4f} ms")
    ms["masked_compact"] = k4_seen["masked_compact HPC form"]
    ms["general_scan"] = k4_seen["general_scan hpcsimd nthash2 l=301"]
    # xcode: its least work is 2 bytes a base (each raw byte read, each
    # xcode written once) and 4 integer operations a base (the lookup, the
    # compare, the OR, the length select).  Device time under the profiler:
    # a launch's host time is longer than its device time.
    for what in (f"[{B}, {L}] full rows", "[1, 2^25] long-read chunk, prev a real byte"):
        args = xcode_cases[what]
        n_x = args[0].numel()
        bnd = bound(bound_s, 2 * n_x + 8 * args[0].shape[0] + 256, 4 * n_x)
        t_dev, n_k, _ = device_ms(lambda i, a=args: encode_xcodes_cuda(*a, "simd"),
                                  ("xcode_kernel",))
        t_ev = event_ms(lambda i, a=args: encode_xcodes_cuda(*a, "simd"), 20)
        t_plain = event_ms(lambda i, a=args: encode_xcodes_plain(*a, "simd"), 3, 1)
        log(f"xcode {what} on {card}: device {t_dev:.4f} ms a call ({timed_by(n_k)}), "
            f"{t_ev:.4f} ms (CUDA events); bound {bnd[0]:.4f} ms by {bnd[1]} ({bnd[0] / t_dev:.3f} of the "
            f"bound reached); plain {t_plain:.4f} ms")
        ms["xcode"], plain_ms["xcode"], bounds["xcode"] = t_dev, t_plain, bnd
    extra = {
        "assemble xorshift u32, unmasked": (
            lambda i: assemble_kminmers_cuda(min_hash, spec.k),
            lambda i: assemble_plain(min_hash, spec.k)),
        "assemble murmur u16": (
            lambda i: assemble_kminmers_cuda(mix_inputs[16][0], spec.k, 16),
            lambda i: assemble_plain(mix_inputs[16][0], spec.k, 16)),
        "assemble identity u64": (
            lambda i: assemble_kminmers_cuda(lo64, spec.k, 64, hi64),
            lambda i: assemble_plain(lo64, spec.k, 64, hi64)),
        "slot_compact with hash_hi": (
            lambda i: slot_compact(*got64[:3], kept64, m64),
            lambda i: slot_compact_plain(*got64[:3], kept64, m64)),
    }
    for (w, v), (args, _) in width_scans.items():
        extra[f"fused_scan plain, width {w} {v}"] = (
            None, lambda i, a=args: fused_scan_plain(*a))
    for what, (kern, plain) in extra.items():
        kern_txt = "" if kern is None else f"kernel {event_ms(kern, 20):.4f} ms, "
        log(f"{what} on {card}: {kern_txt}plain {event_ms(plain, 3, 1):.4f} ms")

    # 7. K1 with a carry: chunk 2 of each read from the kernel's chunk-1 carry
    C = 1 << 22
    rng = np.random.default_rng(SEED + 1)
    two = torch.from_numpy(with_keep_bits(rng.integers(0, 4, (4, 2 * C), dtype=np.uint8)))
    chunk1, chunk2 = (two[:, i * C : (i + 1) * C].contiguous().to(dev) for i in (0, 1))
    clen = torch.full((4,), C, dtype=torch.int32, device=dev)
    carry_specs = {
        "u32 hpcsimd l=31": PipelineSpec(l=31, k=5, density=0.01, mode="hpcsimd"),
        "u64 regular l=31": PipelineSpec(l=31, k=5, density=0.01, mode="regular",
                                         hash_width=64),
        "nthash2 hpc l=201": PipelineSpec(l=201, k=5, density=0.01, mode="hpc",
                                          variant="nthash2"),
    }
    for what, cs in carry_specs.items():
        lim = torch.full_like(clen, (1 << 31) - 1 if cs.is_hpc else 2 * C - cs.l)
        sargs = (cs.l, cs.bound, cs.strict_threshold, cs.is_hpc, cs.mode == "hpc",
                 TILE, cs.cap_per_tile(TILE), cs.hash_width, cs.variant)
        first = fused_minimizer_scan(chunk1, clen, lim, *sargs, emit_carry=True)
        base = first[3][:, :, 2].sum(dim=1, dtype=torch.int32)
        carry = first[4] - (C << 3)
        got = fused_minimizer_scan(chunk2, clen, lim, *sargs, base0=base, carry0=carry,
                                   emit_carry=True)
        want = fused_scan_plain(chunk2, clen, lim, *sargs, base, carry, True)
        record("fused_scan", f"carry, chunk 2 of [4, 2 x {C}], {what}", max_abs_err(
            [valid_slots(t, got[3]) for t in flat(got[:3])] + [got[3], got[4]],
            flat(want[:3]) + [want[3], want[4]]))
        check(int(got[3][:, :, 1].sum()) > 0, f"K1 with carry {what} selected nothing")
        with_carry = event_ms(lambda i: fused_minimizer_scan(
            chunk2, clen, lim, *sargs, base0=base, carry0=carry, emit_carry=True), 10)
        fresh = event_ms(lambda i: fused_minimizer_scan(chunk2, clen, lim, *sargs), 10)
        log(f"fused_scan [4, {C}] {what} on {card}: with carry {with_carry:.4f} ms, "
            f"without {fresh:.4f} ms")
        k1_line(f"carry {what}", with_carry, k1_carry_bound(chunk2, got[3], cs.l, cs.hash_width))

    # 8. K5 and K6 against their plain version, at the script's two shapes
    tile = prof.tile_inputs()
    for rows in (prof.R, prof.BIG_R):
        for npay in prof.PAYLOADS:
            if rows == prof.R:
                xs = [torch.from_numpy(x).to(dev) for x in tile[npay][0]]
                keep_f = torch.from_numpy(tile[npay][1]).to(dev)
            else:
                xs, keep_f = prof.big_inputs(npay, dev)
            want = inrow_compact_plain(xs, keep_f)
            for name, fn in (("inrow_compact_ballot", inrow_compact_ballot),
                             ("inrow_compact_mma", inrow_compact_mma)):
                got = fn(xs, keep_f)
                check(prof.bits_equal(got, want), f"{name} bits [{rows}, 128] x {npay}")
                record(name, f"[{rows}, 128] x {npay} payload(s)", max_abs_err(got, want))
            del xs, keep_f, want

    # 9. the profiling script, counters at 0 just before
    build.launches.clear()
    prof_rows = prof.run(dev)
    torch.cuda.synchronize()
    for name in ("inrow_compact_ballot", "inrow_compact_mma"):
        check(build.launches[name] > 0, f"the profiling script never launched {name}")
        launches[name] += build.launches[name]
    log(f"profiling script launches: {dict(build.launches)}")
    for r in prof_rows:
        log(f"in-row compaction [{r['rows']}, 128] x {r['payloads']} on {card}: "
            f"K5 ballot {r['ballot_ms']:.4f} ms, K6 mma {r['mma_ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms")
    big4 = next(r for r in prof_rows if r["rows"] == prof.BIG_R and r["payloads"] == 4)
    for name, key in (("inrow_compact_ballot", "ballot_ms"), ("inrow_compact_mma", "mma_ms")):
        ms[name], plain_ms[name] = big4[key], big4["plain_ms"]
        # the keep mask and 4 payloads read, 4 payloads written, f32 each
        cells = prof.BIG_R * 128
        bounds[name] = bound(bound_s, cells * 4 * (1 + 4 + 4), 4 * cells)

    # 10. the long-read path, counters at 0 just before
    seq = long_read_codes()
    lr = dict(l=31, k=5, density=0.01, mode="hpcsimd")
    build.launches.clear()
    t0 = time.perf_counter()
    recs = kminmers_long(seq, chunk=1 << 25, device=dev, **lr)
    wall = time.perf_counter() - t0
    ran = {name: build.launches[name] for name in KERNELS}
    log(f"long-read path launches: {ran}")
    for name in ("fused_scan", "slot_compact", "assemble"):
        check(ran[name] > 0, f"the long-read path never launched {name}")
        launches[name] += ran[name]
    n_rec = len(recs["hash"])
    check(n_rec > N_LONG * 0.01 * 0.5, f"long read: only {n_rec} k-min-mers")
    check(recs["hash"].dtype == np.uint64 and recs["rev"].dtype == bool, "record dtypes")
    check(all(len(v) == n_rec for v in recs.values()), "record lengths")
    check(bool((np.diff(recs["start"]) > 0).all()) and int(recs["end"][-1]) < N_LONG,
          "long-read positions are not increasing within the read")
    log(f"long read {N_LONG} bases hpcsimd l=31 chunk 2^25 on {card}: {n_rec} k-min-mers "
        f"in {wall:.4f} s wall = {N_LONG / wall / 1e9:.4f} GB/s (host clock, staging and "
        "transfers included)")

    def same(a, b, what):
        for key in a:
            check(a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]),
                  f"{what}: field {key} differs")

    t0 = time.perf_counter()
    same(recs, kminmers_long(seq, chunk=1 << 23, device=dev, **lr), "chunk 2^23 vs 2^25")
    log(f"long read: chunk 2^23 gives the same {n_rec} records "
        f"({time.perf_counter() - t0:.4f} s wall)")
    P = 1 << 26
    prefix = kminmers_long(seq[:P], chunk=1 << 25, device=dev, **lr)
    out = kminmers_batch(
        torch.from_numpy(seq[None, :P].copy()).to(dev),
        torch.tensor([P], dtype=torch.int32, device=dev),
        PipelineSpec(**lr),
    )
    nk = int(out.n_kminmers[0])
    hi, lo = (t[0, :nk].cpu().numpy().view(np.uint32).astype(np.uint64)
              for t in (out.hash_hi, out.hash_lo))
    same(prefix, {
        "hash": (hi << np.uint64(32)) | lo,
        "start": out.start[0, :nk].cpu().numpy().astype(np.int64),
        "end": out.end[0, :nk].cpu().numpy().astype(np.int64),
        "offset": np.arange(nk, dtype=np.int64),
        "rev": out.rev[0, :nk].cpu().numpy(),
    }, "64 Mbp prefix vs kminmers_batch")
    log(f"long read: the 64 Mbp prefix gives the same {nk} records as kminmers_batch "
        "on one [1, 2^26] row")
    half = N_LONG // 2
    halves = [seq[:half], seq[half:].copy()]
    halves[1][0] |= 8  # a read's first base is always kept
    t0 = time.perf_counter()
    batch = kminmers_long_batch(halves, chunk=1 << 25, device=dev, **lr)
    batch_wall = time.perf_counter() - t0
    for i, h in enumerate(halves):
        same(batch[i], kminmers_long(h, chunk=1 << 25, device=dev, **lr),
             f"batched read {i} vs its own run")
    log(f"long read: 2 x {half} bases batched equal their own runs; batch "
        f"{batch_wall:.4f} s wall = {N_LONG / batch_wall / 1e9:.4f} GB/s")
    # The compiled chunk step (one replay a chunk) against the eager one,
    # record for record; the captures; warm walls of both in turns, and
    # one profiled call of each.
    lspec = PipelineSpec(**lr)
    keys = sorted(k[1][0][0] for k in long_read._compiled_chunk_step(lspec, 1 << 25).graphs)
    check(keys == [1, 2], f"long read: captured batch sizes at chunk 2^25: {keys}")

    def eager_step():
        return mock.patch.object(long_read, "_compiled_chunk_step", long_read._chunk_step)

    with eager_step():
        same(recs, kminmers_long(seq, chunk=1 << 25, device=dev, **lr),
             "compiled vs eager chunk step")
    turns = {"compiled": [], "eager": []}
    for way in ("compiled", "eager", "eager", "compiled"):
        with eager_step() if way == "eager" else contextlib.nullcontext():
            t0 = time.perf_counter()
            kminmers_long(seq, chunk=1 << 25, device=dev, **lr)
            turns[way].append(time.perf_counter() - t0)
    for way in turns:
        with eager_step() if way == "eager" else contextlib.nullcontext():
            p = profile(lambda i: kminmers_long(seq, chunk=1 << 25, device=dev, **lr))
        walls = ("the same records; warm walls "
                 + ", ".join(f"{w:.4f}" for w in turns[way]) + " s")
        if p is None:
            log(f"long read {way} chunk step on {card}: {walls}; {NOT_MEASURED}")
            continue
        dtod = p.by_kernel.get("Memcpy DtoD (Device -> Device)", (0, 0.0))
        log(f"long read {way} chunk step on {card}: {walls}; profiled wall "
            f"{p.wall_ms / 1e3:.4f} s, device busy {p.busy_ms / 1e3:.4f} s, idle share "
            f"{p.idle_share:.4f}; device-to-device copies {dtod[1]:.4f} ms in {dtod[0]:.0f}")
    # The same read as an ASCII str: staged as raw bytes, encoded by xcode
    # on the card once a chunk; the counters at 0 just before.
    text = prof_long_read.as_text(seq)
    build.launches.clear()
    text_recs = kminmers_long(text, chunk=1 << 25, device=dev, **lr)
    torch.cuda.synchronize()
    ran = {c: build.launches[c] for c in counters}
    log(f"long read from a str: launches {ran}")
    n_chunks = -(-N_LONG // (1 << 25))
    check(ran["xcode"] == n_chunks, f"the str read launched xcode {ran['xcode']} times, "
          f"not once a chunk ({n_chunks})")
    for name in counters:
        launches[name] += ran[name]
    same(recs, text_recs, "the read as a str vs as xcodes")
    del text_recs
    text_turns = {"xcodes": [], "str": []}
    for way in ("xcodes", "str", "str", "xcodes", "xcodes", "str"):
        with tracing.recording() as spans:
            t0 = time.perf_counter()
            long_read._records([seq if way == "xcodes" else text], lspec, 1 << 25, dev)
            wall = time.perf_counter() - t0
        text_turns[way].append((wall, tracing.self_seconds(spans).get("long.fill", 0.0)))
    for way, walls in text_turns.items():
        log(f"long read {N_LONG} bases as {way} on {card}: the same records; warm walls "
            + ", ".join(f"{w:.4f}" for w, _ in walls) + " s (in turns; the long-read path's "
            "_records), the producer's fill " + ", ".join(f"{f:.4f}" for _, f in walls) + " s")
    del text
    gm = prof_long_read.graph_memory(long_read, 1, dev)
    log(f"long read: a capture of the chunk step at [1, 2^25] holds {gm[1] - gm[0]:.1f} MiB "
        f"({gm[0]:.1f} -> {gm[1]:.1f} MiB reserved) on {card}")
    long_read._compiled_chunk_step.cache_clear()
    one = torch.from_numpy(seq[None, : 2 << 25].copy()).to(dev)
    full = torch.full((1,), 1 << 25, dtype=torch.int32, device=dev)
    hpc_lim = torch.full_like(full, (1 << 31) - 1)
    largs = (lspec.l, lspec.bound, True, True, False, TILE, lspec.cap_per_tile(TILE))
    first = fused_minimizer_scan(one[:, : 1 << 25].contiguous(), full, hpc_lim, *largs,
                                 emit_carry=True)
    base = first[3][:, :, 2].sum(dim=1, dtype=torch.int32)
    carry = first[4] - ((1 << 25) << 3)
    second = one[:, 1 << 25 :].contiguous()
    k1_chunk = event_ms(lambda i: fused_minimizer_scan(
        second, full, hpc_lim, *largs, base0=base, carry0=carry, emit_carry=True), 10)
    log(f"long read: K1 per 2^25-base chunk (with carry) on {card}: {k1_chunk:.4f} ms; "
        f"{-(-N_LONG // (1 << 25))} chunks = {k1_chunk * -(-N_LONG // (1 << 25)) / 1e3:.4f} s "
        "of K1")
    got_c = tile_carries(second, full, lspec.l, TILE, True, base, carry)
    want_c = tile_carries_plain(second, full, lspec.l, TILE, True, base, carry)
    record("fused_scan", "long read: passes 1-2 on chunk 2 of [1, 2^25] with carry",
           max_abs_err(got_c, want_c))
    del got_c, want_c

    # The long read's kernels against their plain versions, at its shapes:
    # K1 with a carry and K2 on a [1, 2^25] chunk, K3 on the read's whole
    # [1, M] minimizer stream.
    got = fused_minimizer_scan(second, full, hpc_lim, *largs, base0=base, carry0=carry,
                               emit_carry=True)
    want = fused_scan_plain(second, full, hpc_lim, *largs, 32, "nthash1", base, carry, True)
    record("fused_scan", "long read: chunk 2 of [1, 2^25] with carry", max_abs_err(
        [valid_slots(t, got[3]) for t in got[:3]] + [got[3], got[4]], [*want]))
    k1_line("long-read chunk", k1_chunk, k1_carry_bound(second, got[3], lspec.l, 32))
    del want
    lm_cap = lspec.capacity_for(1 << 25)
    kept_l = got[3][:, :, 0].contiguous()
    got2 = slot_compact(*got[:3], kept_l, lm_cap)
    want2 = slot_compact_plain(*got[:3], kept_l, lm_cap)
    record("slot_compact", f"long read: chunk 2 of [1, 2^25] into m = {lm_cap}, kept form",
           max_abs_err([*got2[0], got2[1]], [*want2[0], want2[1]]))
    check(int(got2[1][0]) > 0, "the long-read chunk kept no minimizer")
    # K2's counts form on the chunk, with its fill and without (the
    # long-read driver's form, whose slots past n_min are undefined).
    want_c = slot_compact_counts_plain(*got[:3], got[3], lm_cap)
    valid_l = torch.arange(lm_cap, device=dev)[None, :] < want_c[1][:, None]
    for fill in (True, False):
        what = "with its fill" if fill else "without its fill (the long-read driver's form)"
        got_c = slot_compact_counts(*got[:3], got[3], lm_cap, fill)
        cols = [c if fill else torch.where(valid_l, c, 0) for c in got_c[0]]
        record("slot_compact", f"long read: chunk 2 of [1, 2^25], counts form, {what}",
               max_abs_err([*cols, *got_c[1:]], [*want_c[0], *want_c[1:]]))
        t_dev = device_ms(
            lambda i, f=fill: slot_compact_counts(*got[:3], got[3], lm_cap, f), k2_keys)[0]
        t_ev = event_ms(lambda i, f=fill: slot_compact_counts(*got[:3], got[3], lm_cap, f), 20)
        bnd = k2_bound(kept_l, lm_cap, fill)
        log(f"K2 on the long-read chunk [1, 2^25] ({kept_l.shape[1]} tiles, m = {lm_cap}) "
            f"{what} on {card}: device {t_dev:.4f} ms (profiler), {t_ev:.4f} ms (CUDA "
            f"events); bound {bnd[0]:.4f} ms by {bnd[1]}")
    del got_c, want_c, cols, valid_l
    mh = minimizer_stream_long(seq, lspec, chunk=1 << 25, device=dev)[2]
    check(mh.shape[0] - (lspec.k - 1) == n_rec, "long-read stream length")
    mh_d = torch.from_numpy(mh.view(np.int32)[None, :].copy()).to(dev)
    got3 = assemble_kminmers_cuda(mh_d, lspec.k)
    want3 = assemble_plain(mh_d, lspec.k)
    record("assemble", f"long read: [1, {mh.shape[0]}] minimizer hashes",
           max_abs_err([*got3[0], got3[1]], [*want3[0], want3[1]]))
    # Phases 11 and 12 keep their files here; phase 12 maps the long read.
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    long_path = tmp / "long.npy"
    np.save(long_path, seq)
    del got, got2, want2, got3, want3, mh_d, seq, prefix, halves, batch
    torch.cuda.empty_cache()

    # 11. the file path, counters at 0 just before
    ran, file_path, file_recs = file_phase(dev, card, counters, tmp)
    for name, n in ran.items():
        launches[name] += n

    # 12. the multi-process layer, counters at 0 in every rank before its run
    torch.cuda.empty_cache()
    for name, n in parallel_phase(dev, card, recs, long_path, file_path, file_recs).items():
        launches[name] += n
    del recs, file_recs
    tmp_dir.cleanup()
    left = live_children()
    check(not left, f"processes left running after phase 12: {left}")
    log("no child process is left running")

    # 13. the burn-in against the oracle, counters at 0 just before
    t0 = time.perf_counter()
    for name, n in burnin_phase(dev).items():
        if name in launches:
            launches[name] += n
    log(f"phase 13: {time.perf_counter() - t0:.2f} s")
    graph_memory(dev, pool)

    # 14. the per-stage suite, counters at 0 just before its device cases
    for name, n in suite_phase(dev).items():
        if name in launches:
            launches[name] += n

    # 15. the compiled step, counters at 0 just before each use
    for name, n in graph_phase(dev, card, pool, lengths, path_kernels, small, small_len).items():
        if name in launches:
            launches[name] += n

    log(f"chip_smoke.py wall: {time.perf_counter() - t_script:.2f} s")
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": sum(launches[c] for c in COUNTERS[name]),
            "max_abs_err": errs[name],
            "ms": ms[name],
            "plain_ms": plain_ms[name],
            "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1],
            "library_ms": None,  # no one PyTorch call computes any of these
        }
        for name, (src, replaces) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
