"""``kminmers_batch`` on batches of ragged reads in regular mode, on the CPU
(the port's plain versions), against the benchmark's plain PyTorch
reference (``benchmark/reference/kminmers_torch.py``) with per-row lengths:
the shapes the length-bucketed file path and the reads cell hand the
pipeline, with rows that hold no window, full rows and rows that end just
past a K1 tile's edge."""

from __future__ import annotations

import pytest
import torch

from benchmark import generate
from benchmark.reference import kminmers_torch as reference
from rust_seq2kminmers_torch import PipelineSpec
from rust_seq2kminmers_torch.api import kminmers_batch
from rust_seq2kminmers_torch.constants import XCODE_PAD
from rust_seq2kminmers_torch.ops.cuda.fused_scan import TILE

L_, K = 31, 5
# (padded length, row lengths): a row of length <= l, one of l + 1, full
# rows, and rows that end at and just past a tile's edge.
SHAPES = {
    "8x4096": (4096, [4096, 31, 0, 32, 1000, 4095, 2500, 36]),
    "4x32768": (1 << 15, [1 << 15, TILE + 7, TILE, 20]),
}


def ragged(seed: int, pad: int, lengths) -> tuple:
    """Seeded uniform ACGT xcodes [rows, pad], XCODE_PAD past each length."""
    lengths = torch.tensor(lengths, dtype=torch.int32)
    codes = generate.draw_pool(seed, 1, len(lengths), pad, torch.device("cpu"))[0]
    codes[torch.arange(pad)[None, :] >= lengths[:, None]] = XCODE_PAD
    return codes, lengths


@pytest.mark.parametrize("density", [0.05, 0.01])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_ragged_regular_batch_equals_the_plain_reference(shape, density):
    pad, lengths = SHAPES[shape]
    codes, lengths = ragged(2**32 + pad, pad, lengths)
    spec = PipelineSpec(l=L_, k=K, density=density, mode="regular")
    out = kminmers_batch(codes, lengths, spec)
    want = reference.kminmers_rows(codes, lengths, L_, K, density, "regular", 32, xcodes=True)
    got_hash = (out.hash_hi.to(torch.int64) << 32) | (out.hash_lo.to(torch.int64) & 0xFFFFFFFF)
    fields = (out.hash_hi, out.hash_lo, out.start, out.end, out.rev)
    for r, w in enumerate(want):
        n = int(out.n_kminmers[r])
        assert n == len(w["hash"]), r
        assert torch.equal(got_hash[r, :n], w["hash"]), r
        assert torch.equal(out.start[r, :n].to(torch.int64), w["start"]), r
        assert torch.equal(out.end[r, :n].to(torch.int64), w["end"]), r
        assert torch.equal(out.rev[r, :n].to(torch.bool), w["rev"]), r
        assert all(not f[r, n:].any() for f in fields), r
        assert bool((out.end[r, :n] < lengths[r]).all()), r
        if lengths[r] <= L_:
            assert n == 0, r
    # The full rows and the rows past a tile's edge hold many records.
    assert int(out.n_kminmers.max()) > (400 if density == 0.05 else 50)
