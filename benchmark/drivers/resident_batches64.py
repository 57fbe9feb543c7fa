"""``resident_batches`` at 64-bit minimizer hashes: the same pool and calls
of ``kminmers_batch``, with K2's and K3's bounds counted for the high
word those kernels move at width 64, and the sample judged by the plain
PyTorch reference (``reference/kminmers_torch.py``) on the cell's device.

Traffic keys: those of ``resident_batches``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import judge, roofline
from benchmark.drivers import resident_batches
from benchmark.reference import kminmers_torch as reference


def k2_bound64_s(rows: int, tiles: int, survivors: int, capacity: int) -> float:
    """K2 (slot compaction) with the high column: each survivor's 4 columns
    (16 bytes) and each tile's kept and raw counts read; the ``capacity``
    slots of 4 columns of every row (the fill included) and each row's two
    counts written."""
    nbytes = survivors * 16 + rows * tiles * 8 + rows * capacity * 16 + rows * 8
    return roofline.bound_s(nbytes, 3 * survivors)


def k3_bound64_s(rows: int, n_min: list, k: int, capacity: int) -> float:
    """K3 (assembly, masked) at width 64: each row's valid minimizer words
    (8 bytes, both halves) and its valid windows' starts and ends read; 17
    bytes a window slot and each row's count written.  Operations as
    ``roofline.k3_bound_s``."""
    words = sum(n_min)
    valid = sum(max(n - (k - 1), 0) for n in n_min)
    slots = capacity - k + 1
    nbytes = words * 8 + valid * 8 + rows * slots * 17 + rows * 8
    return roofline.bound_s(nbytes, 12 * words + 16 * valid)


class Driver(resident_batches.Driver):
    def _bounds(self, i: int, out) -> dict:
        bounds = super()._bounds(i, out)
        rows, length = self.pool.shape[1:]
        tiles = -(-length // roofline.K1_TILE)
        survivors = int(out.n_minimizers_raw.sum())
        capacity = out.min_hash.shape[1]
        n_min = out.n_minimizers.cpu().tolist()
        bounds["k2_bound64_s"] = k2_bound64_s(rows, tiles, survivors, capacity)
        bounds["k3_bound64_s"] = k3_bound64_s(rows, n_min, self.cell.config["spec"]["k"],
                                              capacity)
        return bounds

    def _reference(self, width: int) -> list:
        """The reference's records of every judged row, computed on the
        cell's device, as the judge compares them (numpy, hashes uint64)."""
        s = self.cell.config["spec"]
        if s["variant"] != "nthash1":
            raise ValueError("the reference computes nthash1 only")
        dev = torch.device(self.cell.device)
        codes = torch.from_numpy(np.stack([x for x, _ in self.judged])).to(dev)
        lengths = torch.full((codes.shape[0],), codes.shape[1], dtype=torch.int64, device=dev)
        rows = reference.kminmers_rows(codes, lengths, s["l"], s["k"], s["density"], s["mode"],
                                       width, xcodes=True)
        return [{"hash": r["hash"].cpu().numpy().view(np.uint64),
                 "start": r["start"].cpu().numpy(), "end": r["end"].cpu().numpy(),
                 "rev": r["rev"].cpu().numpy()} for r in rows]

    def check(self) -> dict:
        width = self.cell.config["spec"]["hash_width"]
        want = self._reference(width)
        if self.cell.control:
            got = self._reference(judge.LOWER_WIDTH[width])
        else:
            got = [g for _, g in self.judged]
        bad = sum(judge.mismatched(g, w) for g, w in zip(got, want))
        return judge.checks(bad, sum(len(w["hash"]) for w in want))

