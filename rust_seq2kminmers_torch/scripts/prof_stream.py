"""Profiles the file path on one NVIDIA GPU: a seeded FASTA of about 0.5 Gbp
through the streaming runner (``io/stream.py``).

    python -m rust_seq2kminmers_torch.scripts.prof_stream [--seed S]

The file is shaped like what rust-mdbg users sketch:
  * 24,000 HiFi-like reads, lengths uniform in 10-30 kb (~480 Mbp; pads
    16384 and 32768);
  * 50,000 short reads of 150 bases (pad 1024: ~49 batches of 1024 rows);
  * 4 contigs of 2-4 Mbp wrapped at 80 columns (the reader's multi-line
    path);
  * ACGT with 0.5% N and a few lowercase stretches.
The HiFi and short reads come in a shuffled order, the contigs last.

For the CLI's defaults (regular, l=31, k=5, d=0.01) and the main spec
(hpcsimd, l=31, k=5, d=0.01): one cold and two warm runs (wall, GB/s =
bases / wall, packing seconds, first result, batches, buckets), then one
warm run under ``torch.profiler``: the device's busy time is the union of
its kernels' and copies' intervals, the idle share is 1 - busy / wall, and
the device time by kernel.  Each run also splits the main thread's time:
waiting for the producer, reading batches back, stitching records.
``chip_smoke.py`` phase 11 runs the same and checks the records.  Prints the card's name and power limit first; needs
a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..io.stream import StreamingRunner
from ..ops.pipeline import PipelineSpec
from .common import NOT_MEASURED, card, profile

SEED = 11
HIFI = (24_000, 10_000, 30_000)  # count, shortest, longest
SHORT = (50_000, 150)  # count, length
CONTIGS = (4, 2_000_000, 4_000_000)  # count, shortest, longest
WRAP = 80  # the contigs' line width
N_SHARE = 0.005
LOWER_STRETCHES = (200, 100, 5000)  # count, shortest, longest
SPECS = {
    "CLI defaults (regular l=31 k=5 d=0.01)": PipelineSpec(l=31, k=5, density=0.01),
    "main spec (hpcsimd l=31 k=5 d=0.01)": PipelineSpec(l=31, k=5, density=0.01,
                                                        mode="hpcsimd"),
}
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclasses.dataclass
class Reads:
    bases: np.ndarray  # uint8 ASCII, every record's bases back to back
    starts: np.ndarray  # int64[n + 1]: record i is bases[starts[i]:starts[i + 1]]
    wrapped: np.ndarray  # bool[n]: written over lines of WRAP bases

    def __len__(self) -> int:
        return len(self.wrapped)

    def seq(self, i: int) -> np.ndarray:
        return self.bases[self.starts[i] : self.starts[i + 1]]


def make_reads(seed: int = SEED, scale: int = 1) -> Reads:
    """The file's records; ``scale`` divides every count and length (the
    tests use a small file)."""
    rng = np.random.default_rng(seed)
    n_hifi, lo, hi = HIFI[0] // scale, HIFI[1] // scale, HIFI[2] // scale
    mixed = np.concatenate([rng.integers(lo, hi + 1, n_hifi),
                            np.full(SHORT[0] // scale, SHORT[1])])
    rng.shuffle(mixed)
    contigs = rng.integers(CONTIGS[1] // scale, CONTIGS[2] // scale + 1, CONTIGS[0])
    lens = np.concatenate([mixed, contigs]).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)])
    total = int(starts[-1])
    bases = _ACGT[rng.integers(0, 4, total, dtype=np.uint8)]
    bases[rng.integers(0, total, int(total * N_SHARE))] = ord("N")
    n_low, lo, hi = LOWER_STRETCHES
    for s, n in zip(rng.integers(0, total, n_low), rng.integers(lo // scale, hi // scale + 1, n_low)):
        bases[s : s + n] |= 0x20  # lowercase
    wrapped = np.zeros(len(lens), dtype=bool)
    wrapped[len(mixed):] = True
    return Reads(bases, starts, wrapped)


def write_fasta(path, reads: Reads, count=None) -> int:
    """Write the first ``count`` records (all by default) -> bases written."""
    count = len(reads) if count is None else count
    newline = np.frombuffer(b"\n", dtype=np.uint8)
    with open(path, "wb") as f:
        for i in range(count):
            f.write(b">r%d\n" % i)
            s = reads.seq(i)
            if reads.wrapped[i]:
                full = len(s) // WRAP * WRAP
                lines = np.empty((full // WRAP, WRAP + 1), dtype=np.uint8)
                lines[:, :WRAP] = s[:full].reshape(-1, WRAP)
                lines[:, WRAP] = newline[0]
                f.write(memoryview(lines.reshape(-1)))
                s = s[full:]
                if not len(s):
                    continue
            f.write(memoryview(s))
            f.write(b"\n")
    return int(reads.starts[count])


def run(path, spec, device, profiled=False):
    """One streaming run -> (stats, the ordered records, profile): profile
    is None, or (wall s, device busy s, idle share, {kernel: device ms}),
    or () where no profiler session recorded a device event."""
    if not profiled:
        with StreamingRunner(path, spec, device=device) as r:
            stats = r.run()
            return stats, r.collect(), None
    done = []

    def traced():
        with StreamingRunner(path, spec, device=device) as r:
            done[:] = [r.run(), r.collect()]

    prof = profile(lambda i: traced())
    stats, recs = done
    if prof is None:
        return stats, recs, ()
    busy = prof.busy_ms / 1e3
    return stats, recs, (stats.wall_s, busy, 1 - busy / stats.wall_s,
                         {k: ms for k, (_, ms) in prof.by_kernel.items()})


def describe(stats) -> str:
    rest = stats.wall_s - stats.wait_s - stats.fetch_s - stats.stitch_s
    return (f"wall {stats.wall_s:.4f} s = {stats.total_bases / stats.wall_s / 1e9:.4f} GB/s "
            f"end to end, pack {stats.pack_s:.4f} s, first result {stats.first_result_s:.4f} s, "
            f"warm-up {stats.warm_s:.4f} s; main thread: waiting for the producer "
            f"{stats.wait_s:.4f} s, read-back {stats.fetch_s:.4f} s, stitch {stats.stitch_s:.4f} s, "
            f"copies, dispatch and the rest {rest:.4f} s; "
            f"{stats.batches} batches in {stats.buckets} buckets, "
            f"{stats.total_kminmers} k-min-mers from {stats.total_bases} bases")


def describe_profile(prof) -> str:
    if not prof:
        return NOT_MEASURED
    wall, busy, idle, by_kernel = prof
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return (f"profiled wall {wall:.4f} s, device busy {busy:.4f} s, idle share {idle:.4f}; "
            "device ms by kernel: " + ", ".join(f"{k} {v:.3f}" for k, v in top))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=SEED)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    name = card()
    print(name, flush=True)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "reads.fa"
        t0 = time.perf_counter()
        n = write_fasta(path, make_reads(args.seed))
        print(f"wrote {n} bases to a FASTA in {time.perf_counter() - t0:.2f} s", flush=True)
        for what, spec in SPECS.items():
            for i in range(3):
                stats = run(path, spec, dev)[0]
                print(f"{what} {'cold' if i == 0 else 'warm'} on {name}: {describe(stats)}",
                      flush=True)
            print(f"{what} on {name}: {describe_profile(run(path, spec, dev, True)[2])}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
