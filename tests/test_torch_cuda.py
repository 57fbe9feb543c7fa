"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips (inside the ``cuda`` fixture) when
``torch.cuda.is_available()`` is false.  This file imports no jax, so
it also runs where jax is absent, without the repo's conftest:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

All outputs are integers: every comparison is bit-exact.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from rust_seq2kminmers_torch import kminmers_list
from rust_seq2kminmers_torch.constants import XCODE_PAD, with_keep_bits
from rust_seq2kminmers_torch.ops.assemble import assemble_kminmers
from rust_seq2kminmers_torch.ops.cuda import build
from rust_seq2kminmers_torch.ops.cuda.assemble_kernel import assemble_kminmers_cuda
from rust_seq2kminmers_torch.ops.cuda.fused_scan import (
    fused_minimizer_scan,
    fused_scan_plain,
    valid_slots,
)
from rust_seq2kminmers_torch.ops.cuda.slot_compact import (
    slot_compact,
    slot_compact_plain,
)
from rust_seq2kminmers_torch.ops.pipeline import (
    PipelineSpec,
    kminmer_pipeline,
    kminmer_pipeline_plain,
)

pytestmark = pytest.mark.cuda

FIXTURE = Path(__file__).parent / "data" / "ecoli.genome.100k.fa"
GOLDENS = Path(__file__).parent / "data" / "goldens_u32.json"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _batch(seed, B, L, runs=False):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 6, size=(B, L))
    if runs:  # long homopolymer runs: whole tiles keep nothing
        codes[:, L // 4 : L // 2] = 2
    codes = with_keep_bits(codes)
    lengths = rng.integers(L // 2, L + 1, size=B).astype(np.int32)
    lengths[0] = L
    for b in range(B):
        codes[b, lengths[b] :] = XCODE_PAD
    return torch.from_numpy(codes), torch.from_numpy(lengths)


def _scan_args(spec, lengths):
    if spec.is_hpc:
        limit = torch.where(lengths > spec.l, 1 << 30, -1)
    else:
        limit = torch.where(lengths > spec.l, lengths - spec.l, -1)
    return (
        limit.to(torch.int32), spec.l, spec.bound, spec.strict_threshold,
        spec.is_hpc, spec.mode == "hpc",
    )


@pytest.mark.parametrize("mode", ["regular", "simd", "hpc", "hpcsimd"])
@pytest.mark.parametrize("l", [2, 31, 255])
@pytest.mark.parametrize("tile,cap", [(4096, None), (3000, 64), (1024, 1)])
def test_fused_scan_kernel(cuda, mode, l, tile, cap):
    codes, lengths = _batch(l, B=5, L=20000, runs=True)
    spec = PipelineSpec(l=l, k=3, density=0.05, mode=mode)
    args = (codes.to(cuda), lengths.to(cuda), *_scan_args(spec, lengths.to(cuda)))
    got = fused_minimizer_scan(*args, tile=tile, cap=cap)
    want = fused_scan_plain(*args, tile, tile if cap is None else cap)
    torch.cuda.synchronize()
    assert torch.equal(got[3], want[3])
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(valid_slots(g, got[3]), w)


@pytest.mark.parametrize("mode", ["regular", "hpc", "hpcsimd"])
def test_fused_scan_kernel_edges(cuda, mode):
    """Reads of length 0, exactly l, l+1 and past the padded length, a
    padded length below one step of 1024 bases, and tiles of 16 bases."""
    codes, _ = _batch(4, B=4, L=700)
    lengths = torch.tensor([0, 31, 32, 5000], dtype=torch.int32)
    spec = PipelineSpec(l=31, k=3, density=0.5, mode=mode)
    args = (codes.to(cuda), lengths.to(cuda), *_scan_args(spec, lengths.to(cuda)))
    for tile, cap in ((16, 3), (1024, 1024)):
        got = fused_minimizer_scan(*args, tile=tile, cap=cap)
        want = fused_scan_plain(*args, tile, cap)
        torch.cuda.synchronize()
        assert torch.equal(got[3], want[3])
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(valid_slots(g, got[3]), w)


@pytest.mark.parametrize("m,tile", [(1, 2048), (500, 2048), (100000, 2048), (3000, 16)])
def test_slot_compact_kernel(cuda, m, tile):
    """tile=16 gives 3125 tiles a read: the kernel scans the counts in
    several chunks of 1024."""
    codes, lengths = _batch(3, B=4, L=50000)
    spec = PipelineSpec(l=11, k=3, density=0.05, mode="hpcsimd")
    args = (codes.to(cuda), lengths.to(cuda), *_scan_args(spec, lengths.to(cuda)))
    st, en, hs, counts = fused_minimizer_scan(*args, tile=tile, cap=min(256, tile))
    kept = counts[:, :, 0].contiguous()
    got = slot_compact(st, en, hs, kept, m)
    want = slot_compact_plain(st, en, hs, kept, m)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("k", [1, 2, 5, 8, 70])
@pytest.mark.parametrize("M", [70, 300, 40000])
def test_assemble_kernel(cuda, k, M):
    rng = np.random.default_rng(k)
    h = rng.integers(0, 2**32, size=(3, M), dtype=np.uint64)
    h[:, ::3] = 2**32 - 1 - h[:, ::3] % 1000
    x = torch.from_numpy(h.astype(np.uint32).view(np.int32)).to(cuda)
    (hi, lo), rev = assemble_kminmers_cuda(x, k)
    (whi, wlo), wrev = assemble_kminmers(x, k)
    torch.cuda.synchronize()
    assert torch.equal(hi, whi) and torch.equal(lo, wlo) and torch.equal(rev, wrev)


@pytest.mark.parametrize("mode", ["regular", "simd", "hpc", "hpcsimd"])
def test_pipeline_kernels_match_plain(cuda, mode):
    codes, lengths = _batch(9, B=4, L=1 << 17, runs=True)
    spec = PipelineSpec(l=31, k=5, density=0.01, mode=mode)
    codes, lengths = codes.to(cuda), lengths.to(cuda)
    before = dict(build.launches)
    got = kminmer_pipeline(codes, lengths, spec)
    want = kminmer_pipeline_plain(codes, lengths, spec)
    torch.cuda.synchronize()
    for name in ("fused_scan", "slot_compact", "assemble"):
        assert build.launches[name] == before.get(name, 0) + 1, name
    for name, g, w in zip(got._fields, got, want):
        assert torch.equal(g, w), name


def test_goldens_on_card(cuda):
    g = json.loads(GOLDENS.read_text())
    seq = FIXTURE.read_text().split("\n")[1]
    recs = kminmers_list(seq, g["l"], g["k"], g["density"], g["mode"], device=cuda)
    assert [r.hash for r in recs] == g["hashes"]


def test_wrappers_reject_bad_tensors(cuda):
    codes, lengths = _batch(1, B=2, L=4096)
    codes, lengths = codes.to(cuda), lengths.to(cuda)
    spec = PipelineSpec(l=11, k=3, density=0.05, mode="regular")
    limit = _scan_args(spec, lengths)[0]
    with pytest.raises(ValueError, match="contiguous"):
        fused_minimizer_scan(codes[:, ::2], lengths, limit, 11, 1, True, False, False)
    with pytest.raises(ValueError, match="device"):
        fused_minimizer_scan(codes, lengths.cpu(), limit, 11, 1, True, False, False)
    with pytest.raises(TypeError):
        assemble_kminmers_cuda(codes.to(torch.int64), 3)
