"""Calls of ``kminmers_batch`` on xcode batches that already live on the
card, as an API caller whose reads are on the device makes them: each call
is timed from the call to its outputs complete.

Traffic keys: ``batches`` (a pool used in turn), ``rows`` and ``length``
(every row full), ``check`` {sample_calls, rows_per_call}: calls judged,
drawn from the seed over the window, and rows of each, drawn from the
seed.  The pool is ``generate.draw_pool``'s: uniform ACGT drawn on the
device, a keep bit on each code that differs from the one before it.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import generate, judge, roofline

class Driver:
    def __init__(self, cell):
        self.cell = cell

    def prepare(self) -> None:
        from rust_seq2kminmers_torch import PipelineSpec

        t = self.cell.traffic
        dev = torch.device(self.cell.device)
        self.pool = generate.draw_pool(self.cell.seed, t["batches"], t["rows"], t["length"], dev)
        self.lengths = torch.full((t["rows"],), t["length"], dtype=torch.int32, device=dev)
        self.spec = PipelineSpec(**judge.spec_args(self.cell.config))
        self.calls = 0
        self.rng = generate.rng_of(self.cell.seed + 1)
        self.sample = judge.Reservoir(self.rng, t["check"]["sample_calls"])
        # One call a batch captures its graph and gives the counts that
        # the kernels' bounds are computed from.
        self.bounds = [self._bounds(i, self._call(i)) for i in range(t["batches"])]

    def _call(self, i: int):
        from rust_seq2kminmers_torch.api import kminmers_batch

        out = kminmers_batch(self.pool[i], self.lengths, self.spec)
        if self.cell.device == "cuda":
            torch.cuda.synchronize()
        return out

    def _bounds(self, i: int, out) -> dict:
        """The least seconds of K1, K2 and K3 on batch i."""
        rows, length = self.pool.shape[1:]
        tiles = -(-length // roofline.K1_TILE)
        stream = int(((self.pool[i] & generate.XCODE_KEEP) != 0).sum())
        survivors = int(out.n_minimizers_raw.sum())
        capacity = out.min_hash.shape[1]
        n_min = out.n_minimizers.cpu().tolist()
        s = self.cell.config["spec"]
        return {
            "k1_bound_s": roofline.k1_bound_s(rows, length, tiles, survivors, stream,
                                              s["hash_width"]),
            "k2_bound_s": roofline.k2_bound_s(rows, tiles, survivors, capacity),
            "k3_bound_s": roofline.k3_bound_s(rows, n_min, s["k"], capacity),
        }

    def begin(self, run) -> None:
        self.run = run
        run.counters.update({name: 0.0 for name in self.bounds[0]})

    def step(self) -> int:
        i = self.calls % len(self.bounds)
        self.calls += 1
        out = self._call(i)
        for name, s in self.bounds[i].items():
            self.run.counters[name] += s
        self.sample.offer(lambda: (i, out))
        return self.pool.shape[1] * self.pool.shape[2]

    def release(self) -> None:
        """Bring the sampled rows and their records to the host; free the
        pool and the outputs."""
        per_call = self.cell.traffic["check"]["rows_per_call"]
        self.judged = []
        for i, out in self.sample.items:
            for r in self.rng.choice(self.pool.shape[1], per_call, replace=False):
                n = int(out.n_kminmers[r])
                hi = out.hash_hi[r, :n].cpu().numpy().view(np.uint32).astype(np.uint64)
                lo = out.hash_lo[r, :n].cpu().numpy().view(np.uint32).astype(np.uint64)
                got = {
                    "hash": (hi << np.uint64(32)) | lo,
                    "start": out.start[r, :n].cpu().numpy(),
                    "end": out.end[r, :n].cpu().numpy(),
                    "rev": out.rev[r, :n].cpu().numpy(),
                }
                self.judged.append((self.pool[i, r].cpu().numpy(), got))
        self.sample = self.pool = None
        if self.cell.device == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        bad = compared = 0
        for xcodes, got in self.judged:
            want = judge.expected(xcodes, self.cell.config, xcodes=True)
            if self.cell.control:
                got = judge.expected(xcodes, self.cell.config, xcodes=True, control=True)
            bad += judge.mismatched(got, want)
            compared += len(want["hash"])
        return judge.checks(bad, compared)

    def close(self) -> None:
        self.pool = self.sample = None
