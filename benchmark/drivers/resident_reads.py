"""Calls of ``kminmers_batch`` on length-bucketed batches of reads that
already live on the card: the shapes the port's file path hands the device
(``io/stream.py:plan_buckets``: power-of-two pads, ``rows`` a batch, each
row a read padded past its length), without the file path's host side.
Each call is timed from the call to its outputs complete.

Traffic keys: ``rows`` (a batch's rows); ``buckets``, a list of {pad,
batches}: the pool, its batches used in turn in that order; ``lengths``
{mean, sd, min, max}: a read's length is drawn from a normal distribution,
rounded and clipped to [min, max], and only draws inside its pad's bin
(pad / 2, pad] are kept; ``check`` {sample_calls, rows_per_call}: calls
judged, drawn from the seed over the window, and rows of each, drawn from
the seed.  Every seed gets the same shapes.  Bases are
``generate.draw_pool``'s, one draw a pad; every byte at or past a read's
length is the program's ``XCODE_PAD``.

A step counts its reads' bases, the sum of the lengths, and not the
padding.  K1's least time is counted on the reads too
(``k1_bound_reads_s``); K2's and K3's from the call's outputs, as
``resident_batches`` counts them.  The sample is judged on the cell's
device by the plain PyTorch reference (``reference/kminmers_torch.py``),
each row cut to its own length; the control is the NumPy reference at the
next lower hash width.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from benchmark import generate, judge, roofline
from benchmark.reference import kminmers_torch as reference

DRAWS = 1 << 16  # lengths drawn a round
MAX_ROUNDS = 100


def draw_lengths(rng: np.random.Generator, n: int, lo: int, hi: int, dist: dict) -> np.ndarray:
    """int64[n] read lengths in the bin (lo, hi]: normal(mean, sd) draws,
    rounded and clipped to [min, max], those outside the bin dropped."""
    kept: List[np.ndarray] = []
    have = 0
    for _ in range(MAX_ROUNDS):
        x = np.clip(np.rint(rng.normal(dist["mean"], dist["sd"], DRAWS)), dist["min"],
                    dist["max"]).astype(np.int64)
        x = x[(x > lo) & (x <= hi)]
        kept.append(x)
        have += len(x)
        if have >= n:
            return np.concatenate(kept)[:n]
    raise ValueError(f"the bin ({lo}, {hi}] is too rare: {have} of {n} lengths after "
                     f"{MAX_ROUNDS * DRAWS} draws")


def k1_bound_reads_s(lengths: Sequence[int], survivors: int, stream: int, width: int) -> float:
    """K1 (the fused scan) on a batch of reads: each read's bases read once,
    with its length and limit (8 bytes a row); each survivor's (start, end,
    hash[, hash_hi]) and the three counts (12 bytes) of each tile that holds
    a read's bases written once.  Operations: the keep test a base (3), and
    12 a stream element, as ``roofline.k1_bound_s``; in the non-HPC modes
    every base is one.  The padding past a read is no work, so on rows that
    are all full this is ``roofline.k1_bound_s``."""
    bases = sum(lengths)
    tiles = sum(-(-n // roofline.K1_TILE) for n in lengths)
    nbytes = (bases + 8 * len(lengths) + survivors * (16 if width == 64 else 12)
              + tiles * 3 * 4)
    return roofline.bound_s(nbytes, 3 * bases + 12 * stream)


def draw_reads(seed: int, traffic: dict, device, pad_code: int) -> list:
    """The pool: (codes uint8[rows, pad], lengths int32[rows]) a batch, the
    buckets' batches in their order; ``pad_code`` at and past each length."""
    rng = generate.rng_of(seed)
    rows = traffic["rows"]
    pool = []
    for bucket in traffic["buckets"]:
        pad, n = bucket["pad"], bucket["batches"]
        lengths = draw_lengths(rng, n * rows, pad // 2, pad, traffic["lengths"])
        lengths = torch.from_numpy(lengths.reshape(n, rows)).to(device)
        codes = generate.draw_pool(int(rng.integers(0, 1 << 63)), n, rows, pad, device)
        codes.masked_fill_(torch.arange(pad, device=device) >= lengths[..., None], pad_code)
        pool += [(codes[j], lengths[j].to(torch.int32)) for j in range(n)]
    return pool


class Driver:
    def __init__(self, cell):
        self.cell = cell

    def prepare(self) -> None:
        from rust_seq2kminmers_torch import PipelineSpec
        from rust_seq2kminmers_torch.constants import XCODE_PAD

        t = self.cell.traffic
        if self.cell.config["spec"]["mode"] in ("hpc", "hpcsimd"):
            raise ValueError("K1's stream is counted as every base: the non-HPC modes only")
        self.batches = draw_reads(self.cell.seed, t, torch.device(self.cell.device), XCODE_PAD)
        self.bases = [int(lengths.sum()) for _, lengths in self.batches]
        self.spec = PipelineSpec(**judge.spec_args(self.cell.config))
        self.calls = 0
        self.rng = generate.rng_of(self.cell.seed + 1)
        self.sample = judge.Reservoir(self.rng, t["check"]["sample_calls"])
        # One call a batch captures its shape's graph and gives the counts
        # that the kernels' bounds are computed from.
        self.bounds = [self._bounds(i, self._call(i)) for i in range(len(self.batches))]

    def _call(self, i: int):
        from rust_seq2kminmers_torch.api import kminmers_batch

        out = kminmers_batch(*self.batches[i], self.spec)
        if self.cell.device == "cuda":
            torch.cuda.synchronize()
        return out

    def _bounds(self, i: int, out) -> dict:
        """The least seconds of K1, K2 and K3 on batch i."""
        codes, lengths = self.batches[i]
        rows, pad = codes.shape
        s = self.cell.config["spec"]
        survivors = int(out.n_minimizers_raw.sum())
        capacity = out.min_hash.shape[1]
        n_min = out.n_minimizers.cpu().tolist()
        return {
            "k1_bound_s": k1_bound_reads_s(lengths.cpu().tolist(), survivors, self.bases[i],
                                           s["hash_width"]),
            "k2_bound_s": roofline.k2_bound_s(rows, -(-pad // roofline.K1_TILE), survivors,
                                              capacity),
            "k3_bound_s": roofline.k3_bound_s(rows, n_min, s["k"], capacity),
        }

    def begin(self, run) -> None:
        self.run = run
        run.counters.update({name: 0.0 for name in self.bounds[0]})

    def step(self) -> int:
        i = self.calls % len(self.batches)
        self.calls += 1
        out = self._call(i)
        for name, s in self.bounds[i].items():
            self.run.counters[name] += s
        self.sample.offer(lambda: (i, out))
        return self.bases[i]

    def release(self) -> None:
        """Bring the sampled rows, each cut to its length, and their records
        to the host; free the pool and the outputs."""
        per_call = self.cell.traffic["check"]["rows_per_call"]
        self.judged = []
        for i, out in self.sample.items:
            codes, lengths = self.batches[i]
            rows = torch.from_numpy(self.rng.choice(codes.shape[0], per_call, replace=False))
            rows = rows.to(codes.device)
            n = out.n_kminmers[rows].cpu().numpy()
            hi, lo, start, end, rev = (f[rows].cpu().numpy() for f in (
                out.hash_hi, out.hash_lo, out.start, out.end, out.rev))
            hashes = (hi.view(np.uint32).astype(np.uint64) << np.uint64(32)) | \
                lo.view(np.uint32).astype(np.uint64)
            xcodes = codes[rows].cpu().numpy()
            for r, length in enumerate(lengths[rows].cpu().tolist()):
                got = {"hash": hashes[r, :n[r]], "start": start[r, :n[r]],
                       "end": end[r, :n[r]], "rev": rev[r, :n[r]]}
                self.judged.append((xcodes[r, :length], got))
        self.sample = self.batches = None
        if self.cell.device == "cuda":
            torch.cuda.empty_cache()

    def _reference(self) -> list:
        """The plain PyTorch reference's records of every judged row at its
        own length, computed on the cell's device, as the judge compares
        them (numpy, hashes uint64)."""
        s = self.cell.config["spec"]
        if s["variant"] != "nthash1":
            raise ValueError("the reference computes nthash1 only")
        lengths = [len(x) for x, _ in self.judged]
        codes = np.zeros((len(lengths), max(lengths)), dtype=np.uint8)
        for r, (x, _) in enumerate(self.judged):
            codes[r, :len(x)] = x
        dev = torch.device(self.cell.device)
        rows = reference.kminmers_rows(torch.from_numpy(codes).to(dev),
                                       torch.tensor(lengths, device=dev), s["l"], s["k"],
                                       s["density"], s["mode"], s["hash_width"], xcodes=True)
        return [{"hash": r["hash"].cpu().numpy().view(np.uint64),
                 "start": r["start"].cpu().numpy(), "end": r["end"].cpu().numpy(),
                 "rev": r["rev"].cpu().numpy()} for r in rows]

    def check(self) -> dict:
        want = self._reference()
        if self.cell.control:
            got = [judge.expected(x, self.cell.config, xcodes=True, control=True)
                   for x, _ in self.judged]
        else:
            got = [g for _, g in self.judged]
        bad = sum(judge.mismatched(g, w) for g, w in zip(got, want))
        return judge.checks(bad, sum(len(w["hash"]) for w in want))

    def close(self) -> None:
        self.batches = self.sample = None
