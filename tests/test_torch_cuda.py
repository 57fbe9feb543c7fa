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

from rust_seq2kminmers_torch import api, kminmers_list, kminmers_long, kminmers_long_batch
from rust_seq2kminmers_torch.api import kminmers_batch
from rust_seq2kminmers_torch.constants import XCODE_PAD, encode_xcodes, with_keep_bits
from rust_seq2kminmers_torch.ops.assemble import (
    assemble_kminmers,
    assemble_masked_plain,
    assemble_plain,
)
from rust_seq2kminmers_torch.ops.compact import compact
from rust_seq2kminmers_torch.ops.cuda import build
from rust_seq2kminmers_torch.ops.cuda.assemble_kernel import (
    assemble_kminmers_cuda,
    assemble_masked_cuda,
)
from rust_seq2kminmers_torch.ops.cuda.fused_scan import (
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
from rust_seq2kminmers_torch.ops import long_read
from rust_seq2kminmers_torch.ops.cuda.general_scan import (
    general_minimizers,
    general_minimizers_plain,
)
from rust_seq2kminmers_torch.ops.cuda.masked_compact import hpc_compact, masked_compact
from rust_seq2kminmers_torch.ops.hpc import hpc_compress_packed
from rust_seq2kminmers_torch.ops.cuda.slot_compact import (
    slot_compact,
    slot_compact_counts,
    slot_compact_counts_plain,
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
GOLDENS_U64 = Path(__file__).parent / "data" / "goldens_u64.json"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _batch(seed, B, L, runs=False, distinct=False):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 6, size=(B, L))
    if distinct:  # no base equals the one before it: the hpc modes keep every base
        codes = np.cumsum(rng.integers(1, 4, size=(B, L)), axis=1) % 4
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


def _hash_cols(rows):
    """(start, end, hash) with the hash's (hi, lo) pair flattened."""
    st, en, hs = rows
    return [st, en, *(hs if isinstance(hs, tuple) else (hs,))]


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


# Pass 3 takes a run of 16 bases a thread and 96 threads a step (width 64
# in a kernel of its own); each case puts one of its edges in every tile:
# (mode, l, hash_width, variant, L, tile, cap, density, data: "random",
# "homopolymer" (a stretch of one base) or "distinct" (no base equal to the
# one before)).  Rows 1 and 2 end at a tile's edge and 3 bases past one,
# inside a run.
RUN_CASES = {
    # rows not 16-byte aligned (L % 16 != 0), runs across the tile ends,
    # the ragged last tile and every read's length
    "unaligned-regular": ("regular", 31, 32, "nthash1", 20007, 1000, None, 0.05, "random"),
    "unaligned-hpcsimd": ("hpcsimd", 31, 32, "nthash1", 40009, 16384, None, 0.05, "random"),
    "unaligned-hpc-u16": ("hpc", 31, 16, "nthash1", 33333, 3000, None, 0.05, "random"),
    "unaligned-regular-u64": ("regular", 31, 64, "nthash1", 20007, 1000, None, 0.05, "random"),
    "unaligned-hpc-u64": ("hpc", 31, 64, "nthash1", 33333, 3000, None, 0.05, "random"),
    # homopolymer stretches of 10,000 bases: steps that keep nothing
    "homopolymer-hpc-u64": ("hpc", 31, 64, "nthash1", 40000, 16384, None, 0.05, "homopolymer"),
    "homopolymer-nthash2": ("hpcsimd", 31, 32, "nthash2", 40000, 4096, None, 0.05, "homopolymer"),
    # l = 255 with every base kept: PF(f - 1) from 16 threads back, and
    # from the step before across the ring's wrap
    "l255-regular-u32": ("regular", 255, 32, "nthash1", 60000, 16384, None, 0.05, "random"),
    "l255-regular-u64": ("regular", 255, 64, "nthash1", 60000, 16384, None, 0.05, "random"),
    # hpc_end at l = 255 with every base kept: a full step of 1536 ranks
    # and the 256 before it, the most the ring holds at once
    "l255-hpc-end-u64": ("hpc", 255, 64, "nthash1", 60000, 16384, None, 0.05, "distinct"),
    "l255-hpc-end-u32": ("hpc", 255, 32, "nthash1", 60000, 16384, None, 0.05, "distinct"),
    # hpc_end at the least l
    "l2-hpc-end-u32": ("hpc", 2, 32, "nthash1", 30000, 16384, None, 0.05, "random"),
    "l2-hpc-end-nthash2": ("hpc", 2, 32, "nthash2", 30000, 16384, None, 0.05, "homopolymer"),
    "l2-hpc-end-u64": ("hpc", 2, 64, "nthash1", 30000, 16384, None, 0.05, "random"),
    "l2-regular-u64": ("regular", 2, 64, "nthash1", 30000, 4096, None, 0.05, "random"),
    # cap = 1 with survivors in many threads of one step
    "cap1-regular": ("regular", 31, 32, "nthash1", 30000, 16384, 1, 0.5, "random"),
    "cap1-hpc": ("hpc", 14, 64, "nthash1", 30000, 16384, 1, 0.5, "random"),
    "cap1-regular-u64": ("regular", 31, 64, "nthash1", 30000, 16384, 1, 0.5, "random"),
}


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_fused_scan_kernel_runs(cuda, case):
    mode, l, hash_width, variant, L, tile, cap, density, data = RUN_CASES[case]
    codes, lengths = _batch(L + l, B=5, L=L, runs=data == "homopolymer",
                            distinct=data == "distinct")
    edge = tile * max(1, (L // 2) // tile)  # a tile's edge inside the row
    for row, end in ((1, edge), (2, edge + 3)):
        lengths[row] = min(end, L)
        codes[row, end:] = XCODE_PAD
    spec = PipelineSpec(l=l, k=3, density=density, mode=mode, hash_width=hash_width,
                        variant=variant)
    args = (codes.to(cuda), lengths.to(cuda), *_scan_args(spec, lengths.to(cuda)), tile,
            tile if cap is None else cap, hash_width, variant)
    got = fused_minimizer_scan(*args)
    want = fused_scan_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[3], want[3])
    if cap == 1:  # tiles overflowed
        assert int(got[3][:, :, 1].sum()) > int(got[3][:, :, 0].sum())
    for g, w in zip(_hash_cols(got[:3]), _hash_cols(want[:3])):
        assert torch.equal(valid_slots(g, got[3]), w)


@pytest.mark.parametrize(
    "mode,hash_width,variant",
    [("regular", 16, "nthash1"), ("hpc", 16, "nthash1"), ("hpcsimd", 32, "nthash2"),
     ("hpc", 32, "nthash2"), ("regular", 64, "nthash1"), ("hpc", 64, "nthash1")],
)
@pytest.mark.parametrize("l", [2, 31, 255])
def test_fused_scan_kernel_carry_chain(cuda, mode, hash_width, variant, l):
    """Three chunks of a row, each resumed from the carry of the one before:
    the kernel's chain against the plain version's, chunk by chunk."""
    C = 20000
    codes, lengths = _batch(3 * l + hash_width, B=4, L=3 * C, runs=True)
    codes, lengths = codes.to(cuda), lengths.to(cuda)
    spec = PipelineSpec(l=l, k=3, density=0.05, mode=mode, hash_width=hash_width,
                        variant=variant)
    limit, *rest = _scan_args(spec, lengths)
    chains = {}
    for name, scan in (("kernel", fused_minimizer_scan), ("plain", fused_scan_plain)):
        base, carry, outs = None, None, []
        for i in range(3):
            args = (codes[:, i * C:(i + 1) * C].contiguous(),
                    (lengths - i * C).clamp(0, C).to(torch.int32), limit, *rest, 4096, 256,
                    hash_width, variant, base, carry, True)
            out = scan(*args)
            outs.append(out)
            kept = out[3][:, :, 2].sum(dim=1, dtype=torch.int32)
            base = kept if base is None else base + kept
            carry = out[4] - (C << 3)
        chains[name] = outs
    torch.cuda.synchronize()
    base = torch.zeros(4, dtype=torch.int64, device=cuda)
    for got, want in zip(chains["kernel"], chains["plain"]):
        assert torch.equal(got[3], want[3])
        for g, w in zip(_hash_cols(got[:3]), _hash_cols(want[:3])):
            assert torch.equal(valid_slots(g, got[3]), w)
        base += got[3][:, :, 2].sum(dim=1)
        for b in range(4):  # the carry's real elements: the last min(base, l)
            n = min(int(base[b]), l)
            assert torch.equal(got[4][b, l - n:], want[4][b, l - n:])


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


@pytest.mark.parametrize(
    "mode,hash_width,variant",
    [("regular", 32, "nthash1"), ("simd", 32, "nthash1"), ("hpc", 32, "nthash1"),
     ("hpcsimd", 32, "nthash1"), ("regular", 64, "nthash1"), ("hpc", 16, "nthash1"),
     ("hpcsimd", 32, "nthash2")],
    ids=["regular", "simd", "hpc", "hpcsimd", "regular-64", "hpc-16", "hpcsimd-nthash2"],
)
def test_pipeline_kernels_match_plain(cuda, mode, hash_width, variant):
    codes, lengths = _batch(9, B=4, L=1 << 17, runs=True)
    spec = PipelineSpec(
        l=31, k=5, density=0.01, mode=mode, hash_width=hash_width, variant=variant
    )
    codes, lengths = codes.to(cuda), lengths.to(cuda)
    before = dict(build.launches)
    got = kminmer_pipeline(codes, lengths, spec)
    want = kminmer_pipeline_plain(codes, lengths, spec)
    torch.cuda.synchronize()
    for name in ("fused_scan", "slot_compact", "assemble"):
        assert build.launches[name] == before.get(name, 0) + 1, name
    for name in ("masked_compact", "hpc_compact", "general_scan"):
        assert build.launches[name] == before.get(name, 0), name
    for name, g, w in zip(got._fields, got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("path", [GOLDENS, GOLDENS_U64], ids=["u32", "u64"])
def test_goldens_on_card(cuda, path):
    g = json.loads(path.read_text())
    seq = FIXTURE.read_text().split("\n")[1]
    recs = kminmers_list(
        seq, g["l"], g["k"], g["density"], g["mode"], device=cuda,
        hash_width=g["hash_width"],
    )
    assert [r.hash for r in recs] == g["hashes"]


@pytest.mark.parametrize(
    "mode,hash_width,variant",
    [("regular", 16, "nthash1"), ("hpc", 16, "nthash1"), ("regular", 64, "nthash1"),
     ("hpc", 64, "nthash1"), ("simd", 32, "nthash2"), ("hpcsimd", 32, "nthash2"),
     ("hpc", 32, "nthash2")],
)
@pytest.mark.parametrize("l", [2, 31, 255])
def test_fused_scan_kernel_widths(cuda, mode, hash_width, variant, l):
    codes, lengths = _batch(l + hash_width, B=5, L=20000, runs=True)
    spec = PipelineSpec(
        l=l, k=3, density=0.05, mode=mode, hash_width=hash_width, variant=variant
    )
    args = (codes.to(cuda), lengths.to(cuda), *_scan_args(spec, lengths.to(cuda)))
    for tile, cap in ((4096, 4096), (3000, 64)):
        got = fused_minimizer_scan(*args, tile, cap, hash_width, variant)
        want = fused_scan_plain(*args, tile, cap, hash_width, variant)
        torch.cuda.synchronize()
        assert torch.equal(got[3], want[3])
        assert isinstance(got[2], tuple) == (hash_width == 64)
        for g, w in zip(_hash_cols(got[:3]), _hash_cols(want[:3])):
            assert torch.equal(valid_slots(g, got[3]), w)


def test_slot_compact_kernel_hash_hi(cuda):
    codes, lengths = _batch(5, B=4, L=50000)
    spec = PipelineSpec(l=11, k=3, density=0.05, mode="hpc", hash_width=64)
    args = (codes.to(cuda), lengths.to(cuda), *_scan_args(spec, lengths.to(cuda)))
    st, en, hs, counts = fused_minimizer_scan(*args, 2048, 256, 64)
    kept = counts[:, :, 0].contiguous()
    for m in (1, 500, 100000):
        got = slot_compact(st, en, hs, kept, m)
        want = slot_compact_plain(st, en, hs, kept, m)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1])
        for g, w in zip(_hash_cols(got[0]), _hash_cols(want[0])):
            assert torch.equal(g, w)


@pytest.mark.parametrize("hash_width", [16, 32, 64])
@pytest.mark.parametrize("k", [1, 5, 70])
def test_assemble_kernel_mixes(cuda, hash_width, k):
    rng = np.random.default_rng(k + hash_width)
    h = rng.integers(0, 2**32, size=(2, 2, 5000), dtype=np.uint64).astype(np.uint32)
    h[:, :, ::3] = 2**32 - 1 - h[:, :, ::3] % 1000
    lo, hi = (torch.from_numpy(x.view(np.int32)).to(cuda) for x in h)
    hi = hi if hash_width == 64 else None
    (ghi, glo), grev = assemble_kminmers_cuda(lo, k, hash_width, hi)
    (whi, wlo), wrev = assemble_plain(lo, k, hash_width, hi)
    torch.cuda.synchronize()
    assert torch.equal(ghi, whi) and torch.equal(glo, wlo) and torch.equal(grev, wrev)


def _survivor_rows(cuda, seed, B, nt, cap, wide):
    """Random survivor rows [B, nt, cap] and K1-shaped counts [B, nt, 3]:
    a fifth of the tiles keep nothing, a seventh claim more than cap."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(-(2**31), 2**31, (4 if wide else 3, B, nt, cap), dtype=np.int64)
    cols = torch.from_numpy(cols.astype(np.int32)).to(cuda)
    kept = rng.integers(0, cap + 1, (B, nt))
    kept[:, ::5] = 0
    kept[:, 1::7] = cap + 3
    raw = kept + rng.integers(0, 3, (B, nt))
    counts = np.stack([kept, raw, rng.integers(0, 1 << 14, (B, nt))], axis=2)
    hsh = (cols[3], cols[2]) if wide else cols[2]
    return cols[0], cols[1], hsh, torch.from_numpy(counts.astype(np.int32)).to(cuda)


@pytest.mark.parametrize(
    "B,nt,cap,m,wide,fill",
    [(32, 64, 640, 21227, False, True), (32, 64, 640, 21227, True, True),
     (1, 2048, 640, 1342305, False, True), (1, 2048, 640, 1342305, False, False),
     (1, 2048, 640, 1342305, True, False), (3, 1, 128, 50, False, True),
     (3, 1, 128, 1000, True, False), (0, 5, 128, 100, False, True),
     (4, 50, 256, 1001, False, True), (4, 50, 256, 1001, True, False),
     (2, 3125, 16, 3000, False, True)],
    ids=["main", "main-hi", "long-chunk", "long-chunk-nofill", "long-chunk-hi-nofill",
         "one-tile", "one-tile-hi-nofill", "B0", "m-below-total", "m-below-total-hi-nofill",
         "3125-tiles"],
)
def test_slot_compact_counts_kernel(cuda, B, nt, cap, m, wide, fill):
    """K2's counts form (counts read at stride 3, n_min and n_raw written)
    against its plain version, bit for bit: the main-path shape, a
    long-read chunk's 2048 tiles, one tile, B = 0, m below the total, the
    hi column; without the fill only the valid prefixes are defined.  Then
    the kept form on the same rows, one launch a call each."""
    st, en, hs, counts = _survivor_rows(cuda, nt + m, B, nt, cap, wide)
    out = torch.full((2, B), -7, dtype=torch.int32, device=cuda)
    before = build.launches["slot_compact"]
    got = slot_compact_counts(st, en, hs, counts, m, fill, n_min=out[0], n_raw=out[1])
    want = slot_compact_counts_plain(st, en, hs, counts, m)
    torch.cuda.synchronize()
    assert build.launches["slot_compact"] == before + (B > 0)
    assert got[1].data_ptr() == out[0].data_ptr() and got[2].data_ptr() == out[1].data_ptr()
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    valid = torch.arange(m, device=cuda)[None, :] < want[1][:, None]
    for g, w in zip(_hash_cols(got[0]), _hash_cols(want[0])):
        assert torch.equal(g if fill else torch.where(valid, g, 0), w)
    got_k = slot_compact(st, en, hs, counts[:, :, 0].contiguous(), m)
    want_k = slot_compact_plain(st, en, hs, counts[:, :, 0].contiguous(), m)
    torch.cuda.synchronize()
    assert build.launches["slot_compact"] == before + 2 * (B > 0)
    assert torch.equal(got_k[1], want_k[1])
    for g, w in zip(_hash_cols(got_k[0]), _hash_cols(want_k[0])):
        assert torch.equal(g, w)


@pytest.mark.parametrize("hash_width", [16, 32, 64])
@pytest.mark.parametrize("B,M,k", [(32, 21227, 5), (4, 5, 5), (5, 70, 70), (7, 1000, 1),
                                   (7, 999, 2), (9, 333, 8), (3, 40000, 70)])
def test_assemble_masked_kernel(cuda, hash_width, B, M, k):
    """K3's masked form against its plain version, bit for bit: odd M (the
    main path's 21,227), M = k, per-row n_min of 0, k - 1, k, M, past M and
    random, at widths 16, 32 and 64; one launch a call."""
    rng = np.random.default_rng(B + M + k + hash_width)
    h = rng.integers(0, 2**32, size=(2, B, M), dtype=np.uint64)
    h[:, :, ::3] = 2**32 - 1 - h[:, :, ::3] % 1000
    lo, hi = (torch.from_numpy(x.astype(np.uint32).view(np.int32)).to(cuda) for x in h)
    hi = hi if hash_width == 64 else None
    st, en = (torch.from_numpy(x).to(cuda)
              for x in rng.integers(0, 2**31, (2, B, M), dtype=np.int64).astype(np.int32))
    n_min = np.resize([0, k - 1, k, M, M + 5], B)
    n_min[5:] = rng.integers(0, M + 1, max(B - 5, 0))
    n_min = torch.from_numpy(n_min.astype(np.int32)).to(cuda)
    before = build.launches["assemble"]
    got = assemble_masked_cuda(lo, k, hash_width, hi, n_min, st, en)
    want = assemble_masked_plain(lo, k, hash_width, hi, n_min, st, en)
    torch.cuda.synchronize()
    assert build.launches["assemble"] == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize(
    "B,N,m,density",
    [(3, 100000, 100000, 0.0), (3, 100000, 100000, 1.0), (3, 100000, 1, 0.5),
     (2, 1, 1, 1.0), (2, 1, 5, 0.0), (0, 1000, 10, 0.5), (2, 0, 3, 0.5),
     (4, 70001, 700, 0.01), (4, 70001, 50000, 0.6), (5, 4099, 1000, 0.7),
     (3, 8209, 9000, 0.9), (7, 17, 17, 0.5), (2, 15, 3, 1.0), (2, 40962, 41000, 0.3)],
)
def test_masked_compact_kernel(cuda, B, N, m, density):
    """All-false, all-true, m = 1, N = 1, B = 0, N = 0, overflow past m,
    several tiles a row, N no multiple of 16 (rows at every alignment, a
    thread's last 16 elements cut short), m below the count and m past N;
    int32 and uint8 columns, bit for bit with the plain version, fills
    included."""
    rng = np.random.default_rng(N + m)
    mask = torch.from_numpy(rng.random((B, N)) < density).to(cuda)
    cols = [
        torch.from_numpy(rng.integers(-(2**31), 2**31, (B, N), dtype=np.int64))
        .to(torch.int32).to(cuda),
        torch.from_numpy(rng.integers(0, 256, (B, N), dtype=np.uint8)).to(cuda),
        torch.arange(N, dtype=torch.int32, device=cuda).expand(B, N).contiguous(),
    ]
    fills = [-5, 250, N]
    before = build.launches["masked_compact"]
    got, n = masked_compact(mask, cols, m, fills)
    want, wn = compact(mask, cols, m, fills)
    torch.cuda.synchronize()
    assert build.launches["masked_compact"] == before + (B > 0)
    assert torch.equal(n, wn)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("B,L", [(4, 1 << 17), (3, 4099), (1, 17), (5, 40001)])
def test_hpc_compress_kernel(cuda, B, L):
    """K4's HPC form against its plain version, hpc_compress_packed:
    packed column, pads and count; reads of length 0, past L and ragged;
    rows at every alignment.  One launch a call."""
    codes, lengths = _batch(6 + L, B=B, L=L, runs=True)
    lengths[B - 1] = 0 if B > 1 else L + 5
    codes, lengths = codes.to(cuda), lengths.to(cuda)
    before = build.launches["hpc_compact"]
    got = hpc_compact(codes, lengths)
    want = hpc_compress_packed(codes, lengths)
    torch.cuda.synchronize()
    assert build.launches["hpc_compact"] == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _general_inputs(cuda, spec, B, L, seed):
    """The general scan's inputs as the pipeline makes them: K4's HPC form
    in the hpc modes; ragged reads, a read of exactly l bases, one of 0."""
    codes, lengths = _batch(seed, B=B, L=L, runs=True)
    if B > 2:
        lengths[1] = min(spec.l, L)
        lengths[2] = 0
    codes, lengths = codes.to(cuda), lengths.to(cuda)
    if spec.is_hpc:
        stream, eff_len = hpc_compact(codes, lengths)
    else:
        stream, eff_len = codes, lengths
    return stream, eff_len, lengths


GENERAL_SCAN_CASES = [
    (mode, l, w, v)
    for mode in ("regular", "simd", "hpc", "hpcsimd")
    for l in (1, 256, 301, 5000)
    for w, v in ((32, "nthash1"), (16, "nthash1"), (64, "nthash1"), (32, "nthash2"))
    if w == 32 or mode in ("regular", "hpc")
]


@pytest.mark.parametrize("mode,l,hash_width,variant", GENERAL_SCAN_CASES)
def test_general_scan_kernel(cuda, mode, l, hash_width, variant):
    """The general scan against its plain version, bit for bit: every mode
    and width, l = 1, 256, 301 and past the 4096-window tile, short reads,
    a capacity below the count (stream overflow) and one past it."""
    spec = PipelineSpec(l=l, k=5, density=0.3 if l == 1 else 0.02, mode=mode,
                        hash_width=hash_width, variant=variant)
    stream, eff_len, lengths = _general_inputs(cuda, spec, 5, 50000, l + hash_width)
    args = (stream, eff_len, lengths, l, spec.bound, spec.strict_threshold, mode,
            hash_width, variant)
    for m in (spec.capacity_for(50000), 37):
        before = build.launches["general_scan"]
        got = general_minimizers(*args, m)
        want = general_minimizers_plain(*args, m)
        torch.cuda.synchronize()
        assert build.launches["general_scan"] == before + 1
        for g, w in zip(got, want):
            assert (g is None and w is None) or (g.dtype == w.dtype and torch.equal(g, w))
        assert int(got[5][0]) > 37 and int(got[5][1]) == 0 == int(got[5][2])


@pytest.mark.parametrize("mode,hash_width", [("regular", 32), ("hpc", 32), ("hpcsimd", 32),
                                             ("regular", 64), ("hpc", 16)])
@pytest.mark.parametrize("l", [1, 300, 4100])
def test_general_scan_kernel_ragged_rows(cuda, mode, hash_width, l):
    """Rows of 40,001 elements, so the rows of xcodes and of the packed
    stream start at every alignment, and the last tile is cut short."""
    spec = PipelineSpec(l=l, k=5, density=0.3 if l == 1 else 0.05, mode=mode,
                        hash_width=hash_width)
    stream, eff_len, lengths = _general_inputs(cuda, spec, 4, 40001, l + 7)
    args = (stream, eff_len, lengths, l, spec.bound, spec.strict_threshold, mode,
            hash_width, "nthash1", spec.capacity_for(40001))
    got, want = general_minimizers(*args), general_minimizers_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)
    assert int(got[5][0]) > 0


@pytest.mark.parametrize("mode", ["regular", "hpc", "hpcsimd"])
@pytest.mark.parametrize("l", [1, 300])
def test_general_scan_kernel_edges(cuda, mode, l):
    """B = 1 with L = l + 1 (one window), a read longer than its padded
    row, m = 1, and a row whose windows all pass the bound (d = 1)."""
    for density, L, n in ((1.0, l + 1, l + 1), (1.0, l + 1, l + 9), (0.5, 3 * l + 7, 2 * l)):
        spec = PipelineSpec(l=l, k=1, density=density, mode=mode)
        codes, _ = _batch(L, B=1, L=L)
        lengths = torch.tensor([n], dtype=torch.int32, device=cuda)
        codes = codes.to(cuda)
        stream, eff_len = hpc_compact(codes, lengths) if spec.is_hpc else (codes, lengths)
        for m in (1, L):
            args = (stream, eff_len, lengths, l, spec.bound, spec.strict_threshold, mode,
                    32, "nthash1", m)
            got, want = general_minimizers(*args), general_minimizers_plain(*args)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert (g is None and w is None) or torch.equal(g, w)


@pytest.mark.parametrize(
    "mode,l,hash_width,variant",
    [("regular", 1, 32, "nthash1"), ("hpc", 1, 16, "nthash1"),
     ("hpcsimd", 301, 32, "nthash2"), ("hpc", 256, 64, "nthash1"),
     ("simd", 300, 32, "nthash2"), ("regular", 400, 64, "nthash1")],
)
def test_general_pipeline_kernels_match_plain(cuda, mode, l, hash_width, variant):
    """The general path launches K4's HPC form (hpc modes only), the
    general scan and K3, never K1, K2 or K4's masked form, and equals the
    plain pipeline in all 12 fields."""
    codes, lengths = _batch(l, B=4, L=1 << 16, runs=True)
    spec = PipelineSpec(
        l=l, k=5, density=0.3 if l == 1 else 0.01, mode=mode,
        hash_width=hash_width, variant=variant,
    )
    codes, lengths = codes.to(cuda), lengths.to(cuda)
    before = dict(build.launches)
    got = kminmer_pipeline(codes, lengths, spec)
    want = kminmer_pipeline_plain(codes, lengths, spec)
    torch.cuda.synchronize()
    ran = {name: build.launches[name] - before.get(name, 0) for name in build.launches}
    assert ran.get("hpc_compact", 0) == (1 if spec.is_hpc else 0)
    assert ran.get("general_scan") == 1 and ran.get("assemble") == 1
    assert not ran.get("fused_scan") and not ran.get("slot_compact")
    assert not ran.get("masked_compact")
    assert int(got.n_kminmers.sum()) > 0
    for name, g, w in zip(got._fields, got, want):
        assert torch.equal(g, w), name


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
    with pytest.raises(ValueError, match="contiguous"):
        masked_compact(codes[:, ::2] > 3, [codes.to(torch.int32)[:, ::2]], 10, [0])
    with pytest.raises(ValueError, match="device"):
        masked_compact(codes > 3, [codes.cpu()], 10, [0])


@pytest.mark.parametrize(
    "mode,hash_width,variant",
    [("regular", 32, "nthash1"), ("hpc", 32, "nthash1"), ("hpcsimd", 32, "nthash1"),
     ("regular", 64, "nthash1"), ("hpc", 16, "nthash1"), ("hpc", 32, "nthash2")],
)
@pytest.mark.parametrize("l", [2, 31, 255])
def test_fused_scan_kernel_carry(cuda, mode, hash_width, variant, l):
    """Chunk 1 by the kernel, then chunk 2 from its rebased carry by the
    kernel and the plain version: outputs, counts and carry-out agree.  A
    run over the whole of chunk 2 passes the carry through in hpc modes,
    and a short first chunk leaves base < l."""
    C = 20000
    codes, lengths = _batch(l + hash_width, B=5, L=2 * C, runs=True)
    codes[1, C:] = codes[1, C] & 7  # one run over the whole second chunk
    codes[2, 100:C] = codes[2, 100] & 7  # chunk 1 keeps about 100 bases
    codes, lengths = codes.to(cuda), lengths.to(cuda)
    spec = PipelineSpec(
        l=l, k=3, density=0.05, mode=mode, hash_width=hash_width, variant=variant
    )
    limit = _scan_args(spec, lengths)[0]
    rest = _scan_args(spec, lengths)[1:]
    first = fused_minimizer_scan(
        codes[:, :C].contiguous(), lengths.clamp(max=C), limit, *rest, 4096, 256,
        hash_width, variant, emit_carry=True,
    )
    base = first[3][:, :, 2].sum(dim=1, dtype=torch.int32)
    carry = first[4] - (C << 3)
    args = (codes[:, C:].contiguous(), (lengths - C).clamp(0, C).to(torch.int32), limit,
            *rest, 4096, 256, hash_width, variant)
    got = fused_minimizer_scan(*args, base0=base, carry0=carry, emit_carry=True)
    want = fused_scan_plain(*args, base, carry, True)
    torch.cuda.synchronize()
    assert torch.equal(got[3], want[3])
    assert int(got[3][:, :, 1].sum()) > 0
    for g, w in zip(_hash_cols(got[:3]), _hash_cols(want[:3])):
        assert torch.equal(valid_slots(g, got[3]), w)
    real = torch.clamp(base + got[3][:, :, 2].sum(dim=1), max=l)
    for b in range(5):
        n = int(real[b])
        assert torch.equal(got[4][b, l - n :], want[4][b, l - n :])


@pytest.mark.parametrize("npay", [1, 2, 4])
@pytest.mark.parametrize("R,keep_share", [(512, 0.75), (1, 0.5), (1000, 0.0), (4099, 1.0)])
def test_inrow_compact_kernels(cuda, R, keep_share, npay):
    """K5 and K6 bit for bit with the plain version, NaN and negative-zero
    payloads included, rows not a multiple of the block's."""
    g = torch.Generator(device=cuda).manual_seed(R + npay)
    keep = (torch.rand((R, 128), generator=g, device=cuda) < keep_share).float()
    xs = [torch.randint(-(2**31), 2**31 - 1, (R, 128), generator=g, device=cuda,
                        dtype=torch.int32).view(torch.float32) for _ in range(npay)]
    want = inrow_compact_plain(xs, keep)
    for name, fn in (("inrow_compact_ballot", inrow_compact_ballot),
                     ("inrow_compact_mma", inrow_compact_mma)):
        before = build.launches[name]
        got = fn(xs, keep)
        torch.cuda.synchronize()
        assert build.launches[name] == before + 1
        for o, w in zip(got, want):
            assert torch.equal(o.view(torch.int32), w.contiguous().view(torch.int32)), name


@pytest.mark.parametrize("mode,hash_width", [("hpcsimd", 32), ("hpc", 64), ("regular", 16)])
def test_kminmers_long_on_card(cuda, mode, hash_width):
    """kminmers_long on the card launches K1, K2 and K3 and equals its run
    on the CPU (the plain versions), at three chunk sizes, with a batch."""
    rng = np.random.default_rng(11)
    seqs = ["".join(rng.choice(list("ACGTTTTTN"), size=n)) for n in (300000, 70001, 20)]
    kw = dict(l=31, k=5, density=0.02, mode=mode, hash_width=hash_width)
    want = [kminmers_long(s, chunk=1 << 16, device="cpu", **kw) for s in seqs]
    long_read._compiled_chunk_step.cache_clear()
    before = dict(build.launches)
    got = kminmers_long(seqs[0], chunk=1 << 16, device=cuda, **kw)
    ran = {name: build.launches[name] - before.get(name, 0) for name in build.launches}
    # 5 chunks, each one replay of the chunk step's graph, after the
    # capture's warm-up (one more K1 and K2); K3 once.
    assert ran["fused_scan"] == 6 and ran["slot_compact"] == 6 and ran["assemble"] == 1
    for key in want[0]:
        assert np.array_equal(got[key], want[0][key]), key
    for chunk in (1 << 10, 1 << 20):
        batch = kminmers_long_batch(seqs, chunk=chunk, device=cuda, **kw)
        for g, w in zip(batch, want):
            for key in w:
                assert np.array_equal(g[key], w[key]), (chunk, key)
    assert len(want[0]["hash"]) > 1000 and len(want[2]["hash"]) == 0


# ---- the overflow rescue on the card ------------------------------------------


def _count_rescues(monkeypatch, module):
    """Record each rescue_spec call that ``module`` makes."""
    calls, real = [], api.rescue_spec

    def rescue_spec(spec, needed=0):
        calls.append(needed)
        return real(spec, needed)

    monkeypatch.setattr(module, "rescue_spec", rescue_spec)
    return calls


@pytest.mark.parametrize(
    "mode,l,tile_cap,family",
    [("hpcsimd", 11, 8, "simd"), ("hpc", 301, None, "scalar")],
    ids=["fused", "general"],
)
def test_overflow_rescue_on_card(cuda, monkeypatch, mode, l, tile_cap, family):
    """The twins of the CPU rescue tests (test_torch_pipeline.py and
    test_torch_general.py): tiny tile and stream capacities overflow on the
    card, kminmers_batch retries through the kernels, ends lossless, and
    equals its run on the CPU in all 12 fields."""
    seq = FIXTURE.read_text().split("\n")[1][:20000]
    codes = np.full((1, 32768), XCODE_PAD, dtype=np.uint8)
    codes[0, : len(seq)] = encode_xcodes(seq, family)
    lengths = torch.tensor([len(seq)], dtype=torch.int32)
    spec = PipelineSpec(l=l, k=3, density=0.05, mode=mode, max_minimizers=64,
                        tile_cap=tile_cap)
    first = kminmer_pipeline(torch.from_numpy(codes).to(cuda), lengths.to(cuda), spec)
    assert int(first.n_minimizers[0]) < int(first.n_minimizers_raw[0])
    calls = _count_rescues(monkeypatch, api)
    api._cached_pipeline.cache_clear()  # so that every run below captures its graph
    before = dict(build.launches)
    out = kminmers_batch(torch.from_numpy(codes).to(cuda), lengths.to(cuda), spec)
    ran = {name: build.launches[name] - before.get(name, 0) for name in build.launches}
    # Each run, the first and each retry, is its graph's capture: the
    # capture's warm-up launches once and answers the run; the capture
    # itself launches nothing.
    assert len(calls) >= 1 and ran["assemble"] == len(calls) + 1
    key = "fused_scan" if spec.fused else "general_scan"
    assert ran[key] == len(calls) + 1
    assert torch.equal(out.n_minimizers, out.n_minimizers_raw)
    want = kminmers_batch(torch.from_numpy(codes), lengths, spec)
    for name, g, w in zip(out._fields, out, want):
        assert torch.equal(g.cpu(), w), name
    assert int(out.n_kminmers[0]) > 64


def test_long_read_rescue_on_card(cuda, monkeypatch):
    """The twin of test_torch_long_read.py's rescue test: 128 survivor
    slots a tile at d = 0.9 overflow every chunk on the card; phase C
    reruns them and the stream equals the CPU run's."""
    seq = "ACGT" * 1500
    codes = encode_xcodes(seq, "scalar")
    spec = PipelineSpec(l=5, k=2, density=0.9, mode="regular", tile_cap=128)
    calls = _count_rescues(monkeypatch, long_read)
    long_read._compiled_chunk_step.cache_clear()
    got = long_read.minimizer_stream_long(codes, spec, chunk=1024, device=cuda)
    assert len(calls) == 1 and calls[0] > 128
    # Both steps, the spec's and the rescue's, ran as captured graphs.
    for s in (spec, api.rescue_spec(spec, calls[0])):
        assert len(long_read._compiled_chunk_step(s, 1024).graphs) == 1
    want = long_read.minimizer_stream_long(codes, spec, chunk=1024, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


# ---- the long read's compiled chunk step ---------------------------------------


def _long_rows(seed, lengths):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list("ACGTTTTTN"), size=n)) for n in lengths]


@pytest.mark.parametrize("mode,hash_width,l", [
    ("regular", 32, 11), ("simd", 32, 11), ("hpc", 32, 11), ("hpcsimd", 32, 11),
    ("regular", 16, 31), ("regular", 64, 31),
])
def test_compiled_long_read_equals_eager(cuda, monkeypatch, mode, hash_width, l):
    """The long read with its compiled chunk step (one replay a chunk)
    equals the eager chunk step bit for bit, at chunk 2^16, on a batch of
    unequal reads."""
    seqs = _long_rows(13, (300000, 70001, 20))
    kw = dict(l=l, k=5, density=0.02, mode=mode, hash_width=hash_width, chunk=1 << 16)
    long_read._compiled_chunk_step.cache_clear()
    build.launches.clear()
    got = kminmers_long_batch(seqs, device=cuda, **kw)
    spec = PipelineSpec(**{k: v for k, v in kw.items() if k != "chunk"})
    (step,) = long_read._compiled_chunk_step(spec, 1 << 16).graphs.values()
    # The capture's warm-up launches once; each of the 5 chunks replays.
    assert build.launches["fused_scan"] == 6 and dict(step.launches)["fused_scan"] == 1
    monkeypatch.setattr(long_read, "_compiled_chunk_step", long_read._chunk_step)
    want = kminmers_long_batch(seqs, device=cuda, **kw)
    for g, w in zip(got, want):
        for key in w:
            assert g[key].dtype == w[key].dtype and np.array_equal(g[key], w[key]), key
    assert len(want[0]["hash"]) > 1000 and len(want[2]["hash"]) == 0


def test_long_read_one_capture_per_key(cuda):
    """Two calls with reads of different lengths at the same (B, chunk)
    make one capture; the second call only replays, once a chunk."""
    kw = dict(l=31, k=5, density=0.02, mode="hpcsimd", chunk=1 << 16)
    spec = PipelineSpec(l=31, k=5, density=0.02, mode="hpcsimd")
    long_read._compiled_chunk_step.cache_clear()
    kminmers_long(_long_rows(14, (250000,))[0], device=cuda, **kw)
    build.launches.clear()
    kminmers_long(_long_rows(15, (100000,))[0], device=cuda, **kw)
    assert len(long_read._compiled_chunk_step(spec, 1 << 16).graphs) == 1
    assert build.launches["fused_scan"] == 2 and build.launches["slot_compact"] == 2


def test_capture_beside_live_producer(cuda):
    """A capture made on the dispatching thread while the staging
    producer is alive does not fail: the producer makes no CUDA call."""
    import threading

    spec = PipelineSpec(l=31, k=5, density=0.02, mode="hpcsimd")
    chunk = 1 << 16
    rows = [encode_xcodes(s, "simd") for s in _long_rows(16, (5 * chunk,))]
    staging = long_read._Staging(rows, chunk, cuda)
    fresh = graph.CompiledStep(long_read._chunk_step(spec, chunk))
    limit = torch.full((1,), long_read.HPC_LIMIT, dtype=torch.int32, device=cuda)
    before = set(threading.enumerate())
    seen = []

    def dispatch(ci, codes):
        if ci == 0:
            seen.append([t for t in set(threading.enumerate()) - before if t.is_alive()])
            long_read._capture(fresh, 1, chunk, spec.l, limit)
        seen.append(ci)

    staging.run(range(5), dispatch)
    torch.cuda.synchronize()
    assert len(seen[0]) == 1 and seen[1:] == list(range(5))
    assert len(fresh.graphs) == 1 and not seen[0][0].is_alive()


# ---- K1's tile-parallel passes ------------------------------------------------

TILE_CASES = [  # mode, l, hash_width, variant, tile, carry
    ("hpcsimd", 31, 32, "nthash1", 16384, False),
    ("hpc", 31, 32, "nthash1", 1024, True),
    ("hpcsimd", 255, 32, "nthash1", 128, True),
    ("regular", 2, 32, "nthash1", 3000, False),
    ("simd", 31, 32, "nthash1", 1024, True),
    ("hpc", 255, 64, "nthash1", 1024, True),
    ("regular", 255, 64, "nthash1", 16384, False),
    ("regular", 31, 16, "nthash1", 16, True),
    ("hpcsimd", 200, 32, "nthash2", 4096, True),
]


def _tile_inputs(cuda, spec, carry):
    """Five reads of ragged lengths with runs over whole tiles; with
    ``carry``, chunk 2 of a two-chunk row, resumed from the plain scan of
    chunk 1, where read 2's chunk 1 keeps ~100 elements (base0 < l in hpc
    modes at l > 100) and its chunk 2 opens with a run the carry passes
    through.  -> (codes, lengths, limit, base0, carry0) on the card."""
    C = 40000
    codes, lengths = _batch(spec.l + spec.hash_width, B=5, L=2 * C if carry else C, runs=True)
    codes[1, C // 8 : C // 2] = codes[1, C // 8] & 7  # a run over whole tiles
    codes[3, 10:] = XCODE_PAD  # a read of length <= l
    lengths[3] = min(int(lengths[3]), spec.l)
    codes[2, 100 : C + 3000] = codes[2, 100] & 7
    codes, lengths = codes.to(cuda), lengths.to(cuda)
    limit = _scan_args(spec, lengths)[0]
    if not carry:
        return codes, lengths, limit, None, None
    first = fused_scan_plain(
        codes[:, :C].contiguous(), lengths.clamp(max=C), *_scan_args(spec, lengths),
        C, C, spec.hash_width, spec.variant, emit_carry=True,
    )
    base0 = first[3][:, :, 2].sum(dim=1, dtype=torch.int32)
    if spec.is_hpc and spec.l > 100:
        assert int(base0[2]) < spec.l
    return (codes[:, C:].contiguous(), (lengths - C).clamp(0, C).to(torch.int32), limit,
            base0, first[4] - (C << 3))


@pytest.mark.parametrize("mode,l,hash_width,variant,tile,carry", TILE_CASES)
def test_tile_carries_kernel(cuda, mode, l, hash_width, variant, tile, carry):
    """Passes 1-2 (tile summaries, then ranks and pending prefixes) against
    tile_carries_plain, with and without a carry."""
    spec = PipelineSpec(l=l, k=3, density=0.05, mode=mode, hash_width=hash_width,
                        variant=variant)
    codes, lengths, _, base0, carry0 = _tile_inputs(cuda, spec, carry)
    before = build.launches["tile_carries"]
    got = tile_carries(codes, lengths, l, tile, spec.is_hpc, base0, carry0)
    want = tile_carries_plain(codes, lengths, l, tile, spec.is_hpc, base0, carry0)
    torch.cuda.synchronize()
    assert build.launches["tile_carries"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("mode,l,hash_width,variant,tile,carry", TILE_CASES)
def test_fused_scan_kernel_tiles(cuda, mode, l, hash_width, variant, tile, carry):
    """The whole K1 (three launches) against fused_scan_plain: valid slots,
    counts and carry-out, bit for bit."""
    spec = PipelineSpec(l=l, k=3, density=0.05, mode=mode, hash_width=hash_width,
                        variant=variant)
    codes, lengths, limit, base0, carry0 = _tile_inputs(cuda, spec, carry)
    args = (codes, lengths, limit, *_scan_args(spec, lengths)[1:], tile,
            min(tile, 512), hash_width, variant, base0, carry0, True)
    got = fused_minimizer_scan(*args)
    want = fused_scan_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    assert int(got[3][:, :, 1].sum()) > 0
    for g, w in zip(_hash_cols(got[:3]), _hash_cols(want[:3])):
        assert torch.equal(valid_slots(g, got[3]), w)


def test_fused_scan_kernel_many_tiles(cuda):
    """12,500 tiles a read (tile 16): pass 2 keeps the ranks in device
    memory and builds every prefix of a read in one block."""
    spec = PipelineSpec(l=31, k=3, density=0.05, mode="hpc")
    codes, lengths = _batch(12, B=2, L=200000, runs=True)
    codes, lengths = codes.to(cuda), lengths.to(cuda)
    got = tile_carries(codes, lengths, spec.l, 16, True)
    want = tile_carries_plain(codes, lengths, spec.l, 16, True)
    assert got[1].shape == (2, 12501, 31)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    args = (codes, lengths, *_scan_args(spec, lengths), 16, 16)
    got = fused_minimizer_scan(*args, emit_carry=True)
    want = fused_scan_plain(*args, emit_carry=True)
    torch.cuda.synchronize()
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(valid_slots(g, got[3]), w)


def test_fused_scan_kernel_long_row(cuda):
    """A fresh [1, 2^25] row: 2048 tiles of one read, passes 1-2 and the
    whole scan against their plain versions."""
    n = 1 << 25
    rng = np.random.default_rng(25)
    codes = torch.from_numpy(with_keep_bits(rng.integers(0, 4, (1, n), dtype=np.uint8)))
    codes = codes.to(cuda)
    lengths = torch.full((1,), n, dtype=torch.int32, device=cuda)
    spec = PipelineSpec(l=31, k=5, density=0.01, mode="hpcsimd")
    got = tile_carries(codes, lengths, spec.l, 16384, True)
    want = tile_carries_plain(codes, lengths, spec.l, 16384, True)
    assert got[0].shape == (1, 2049)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    del want
    args = (codes, lengths, *_scan_args(spec, lengths), 16384, spec.cap_per_tile(16384))
    got = fused_minimizer_scan(*args, emit_carry=True)
    want = fused_scan_plain(*args, emit_carry=True)
    torch.cuda.synchronize()
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(valid_slots(g, got[3]), w)


# ---- the file path on the card ------------------------------------------------

from rust_seq2kminmers_torch import __main__ as cli  # noqa: E402
from rust_seq2kminmers_torch.io import stream  # noqa: E402
from rust_seq2kminmers_torch.kminmer import kminmers_vec  # noqa: E402


@pytest.fixture(scope="module")
def mixed_fasta(tmp_path_factory):
    """Reads of 0-3900 bases in three buckets, wrapped at 70 columns."""
    rng = np.random.default_rng(7)
    seqs = ["".join(rng.choice(list("ACGTNacgt"), size=int(n), p=[0.22] * 4 + [0.04] + [0.02] * 4))
            for n in rng.choice([0, 8, 60, 400, 1100, 1900, 2500, 3900], size=60)]
    p = tmp_path_factory.mktemp("stream") / "mixed.fa"
    p.write_text("".join(f">r{i}\n" + "".join(s[j : j + 70] + "\n" for j in range(0, len(s), 70))
                         for i, s in enumerate(seqs)))
    return p


def _streamed(path, spec, device, target_cells=1 << 14):
    with stream.StreamingRunner(path, spec, target_cells=target_cells, device=device) as r:
        stats = r.run()
        return stats, r.collect()


@pytest.mark.parametrize("mode,l,hash_width,variant", [
    ("regular", 31, 32, "nthash1"), ("simd", 9, 32, "nthash1"), ("hpc", 11, 32, "nthash1"),
    ("hpcsimd", 31, 32, "nthash1"), ("hpc", 301, 32, "nthash1"), ("regular", 400, 64, "nthash1"),
])
def test_stream_on_card_equals_cpu(cuda, mixed_fasta, mode, l, hash_width, variant):
    spec = PipelineSpec(l=l, k=4, density=0.05, mode=mode, hash_width=hash_width, variant=variant)
    build.launches.clear()
    stats, got = _streamed(mixed_fasta, spec, cuda)
    used = ("fused_scan", "slot_compact") if spec.fused else ("general_scan",)
    for name in used + ("assemble",):
        assert build.launches[name] >= stats.batches, name
    cpu_stats, want = _streamed(mixed_fasta, spec, "cpu")
    assert stats.batches == cpu_stats.batches > stats.buckets >= 3
    for c in want:
        assert got[c].dtype == want[c].dtype
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)
    assert stats.total_kminmers == len(got["hash"]) > 0


def test_stream_rescue_on_card(cuda, mixed_fasta, monkeypatch):
    """max_minimizers=8 overflows the streamed batches: each reruns through
    the rescue on the card and ends equal to the CPU run."""
    calls = _count_rescues(monkeypatch, api)
    spec = PipelineSpec(l=9, k=3, density=0.2, mode="regular", max_minimizers=8)
    _, got = _streamed(mixed_fasta, spec, cuda)
    assert calls
    monkeypatch.undo()
    _, want = _streamed(mixed_fasta, spec, "cpu")
    for c in want:
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)


def test_cli_on_card(cuda, capsys):
    assert cli.main([str(FIXTURE), "4"]) == 0
    out = capsys.readouterr().out
    assert "1942 k-min-mers from 99925 bases" in out
    assert f"device {torch.cuda.get_device_name(cuda)}" in out


@pytest.mark.parametrize("mode,hash_width", [("regular", 32), ("simd", 32), ("hpc", 32),
                                             ("hpcsimd", 32), ("regular", 16), ("hpc", 64)])
def test_kminmers_vec_on_card(cuda, mode, hash_width):
    seq = FIXTURE.read_text().split("\n")[1]
    got = kminmers_vec(seq, 31, 5, 0.01, mode, hash_width, device=cuda)
    want = kminmers_vec(seq, 31, 5, 0.01, mode, hash_width, device="cpu")
    assert len(got) > 100
    assert [(v.mers, v.start, v.end, v.offset, v.rev) for v in got] == [
        (v.mers, v.start, v.end, v.offset, v.rev) for v in want]


# ---- the compiled step: captured CUDA graphs ----------------------------------

from rust_seq2kminmers_torch import bench_suite  # noqa: E402
from rust_seq2kminmers_torch.ops import pipeline  # noqa: E402
from rust_seq2kminmers_torch.ops.cuda import graph  # noqa: E402
from rust_seq2kminmers_torch.ops.cuda.graph import CapturedStep  # noqa: E402

GRAPH_SPECS = {
    "main": PipelineSpec(l=31, k=5, density=0.01, mode="hpcsimd"),
    "general": PipelineSpec(l=301, k=5, density=0.01, mode="hpcsimd", variant="nthash2"),
    "u64": PipelineSpec(l=31, k=5, density=0.01, mode="regular", hash_width=64),
}


def _graph_inputs(cuda, B=4, L=1 << 16):
    """Two batches of random ACGT, XCODE_PAD past ragged lengths."""
    rng = np.random.default_rng(11)
    lengths = (L - rng.integers(0, L // 4, B)).astype(np.int32)
    batches = []
    for _ in range(2):
        codes = with_keep_bits(rng.integers(0, 4, (B, L), dtype=np.uint8))
        for b in range(B):
            codes[b, lengths[b]:] = XCODE_PAD
        batches.append(torch.from_numpy(codes).to(cuda))
    return batches, torch.from_numpy(lengths).to(cuda)


def _same_batch(got, want):
    for name, g, w in zip(want._fields, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.equal(g, w), name


@pytest.mark.parametrize("path", list(GRAPH_SPECS))
def test_graph_equals_eager(cuda, path):
    """Every call of make_pipeline's fn, before and after its key is
    captured, equals eager kminmer_pipeline in all 12 fields; one graph."""
    spec = GRAPH_SPECS[path]
    batches, lengths = _graph_inputs(cuda)
    fn = pipeline.make_pipeline(spec)
    for i in range(4):
        got = fn(batches[i % 2], lengths)
        _same_batch(got, kminmer_pipeline(batches[i % 2], lengths, spec))
    assert int(got.n_kminmers.sum()) > 0 and len(fn.graphs) == 1


def test_graph_outputs_survive_later_calls(cuda):
    """A batch the graph returned is not touched by later replays, and a
    call reads its inputs when it is called."""
    spec = GRAPH_SPECS["main"]
    batches, lengths = _graph_inputs(cuda)
    fn = pipeline.make_pipeline(spec)
    fn.capture(batches[0], lengths)
    first = fn(batches[0], lengths)
    kept = [t.clone() for t in first]
    x = batches[0].clone()
    second = fn(x, lengths)
    x.copy_(batches[1])  # after the call: the call has read x already
    third = fn(batches[1], lengths)
    torch.cuda.synchronize()
    for name, g, w in zip(first._fields, first, kept):
        assert torch.equal(g, w), name
    _same_batch(second, kminmer_pipeline(batches[0], lengths, spec))
    _same_batch(third, kminmer_pipeline(batches[1], lengths, spec))
    assert not torch.equal(first.hash_lo, third.hash_lo)


def test_graph_counts_replays(cuda):
    """The capture's warm-up launches once; the capture itself launches
    nothing, and each replay adds what the capture recorded."""
    batches, lengths = _graph_inputs(cuda)
    fn = pipeline.make_pipeline(GRAPH_SPECS["main"])
    build.launches.clear()
    fn.capture(batches[0], lengths)
    once = {"fused_scan": 1, "slot_compact": 1, "assemble": 1}
    assert dict(build.launches) == once
    (step,) = fn.graphs.values()
    assert dict(step.launches) == once
    build.launches.clear()
    for i in range(3):
        fn(batches[i % 2], lengths)
    assert dict(build.launches) == {k: 3 * n for k, n in once.items()}


def test_rescue_after_precompile_captures_nothing(cuda, monkeypatch):
    """After precompile_rescue (and the spec's own graph), a tile overflow
    is rescued by replays alone: no capture, one retry, lossless, equal to
    the CPU run."""
    seq = FIXTURE.read_text().split("\n")[1][:20000]
    codes = np.full((1, 32768), XCODE_PAD, dtype=np.uint8)
    codes[0, : len(seq)] = encode_xcodes(seq, "simd")
    codes_d = torch.from_numpy(codes).to(cuda)
    lengths = torch.tensor([len(seq)], dtype=torch.int32)
    spec = PipelineSpec(l=11, k=3, density=0.05, mode="hpcsimd", max_minimizers=4096,
                        tile_cap=8)
    api.precompile_rescue(spec, codes.shape, cuda)
    api._cached_pipeline(spec).capture(codes_d, lengths.to(cuda))

    def no_capture(*args):
        raise AssertionError("a capture after precompile_rescue")

    monkeypatch.setattr(graph, "CapturedStep", no_capture)
    calls = _count_rescues(monkeypatch, api)
    out = kminmers_batch(codes_d, lengths.to(cuda), spec)
    assert calls == [int(out.n_minimizers_raw.max())] and api.rescue_spec(spec) == \
        api.rescue_spec(spec, calls[0])
    assert torch.equal(out.n_minimizers, out.n_minimizers_raw)
    monkeypatch.undo()
    want = kminmers_batch(torch.from_numpy(codes), lengths, spec)
    for name, g, w in zip(out._fields, out, want):
        assert torch.equal(g.cpu(), w), name


def test_failed_capture_raises(cuda):
    """A step that cannot be captured (a host sync inside) raises; the
    launch counters and the card are left as they were."""
    x = torch.arange(1024, device=cuda)
    before = dict(build.launches)
    with pytest.raises(RuntimeError):
        CapturedStep(lambda t: (t + int(t.sum()),), (x,), cuda)
    torch.cuda.synchronize()
    assert dict(build.launches) == before
    assert int((x + 1).sum()) == 1024 * 1025 // 2


def test_suite_unit_graph_sums(cuda):
    """The suite's unit, one captured graph over the resident pool, sums
    what the same steps sum eagerly."""
    B, L = 2, 1 << 15
    pool = bench_suite.make_pool(B, L, cuda, 3)
    lengths = torch.full((B,), L, dtype=torch.int32, device=cuda)
    spec = PipelineSpec(l=31, k=5, density=0.01, mode="hpcsimd")

    def step(codes):
        out = kminmer_pipeline(codes, lengths, spec)
        return bench_suite.checksum(out), out.n_kminmers.sum()

    _, sums = bench_suite.timed_units(step, pool, 5)
    want = [sum(int(step(pool[i % 3])[j]) for i in range(5)) for j in range(2)]
    assert sums == want and sums[1] > 0


# ---- the compiled multi-device steps in NCCL worlds ----------------------------

from rust_seq2kminmers_torch.parallel import driver, seqshard  # noqa: E402
from rust_seq2kminmers_torch.parallel.launch import run_world  # noqa: E402
from rust_seq2kminmers_torch.parallel.mesh import batch_sharding, make_mesh  # noqa: E402


def _differences(got, want, what) -> list:
    """The positions where two tuples of tensors differ."""
    assert len(got) == len(want), what
    return [f"{what}: field {i}" for i, (g, w) in enumerate(zip(got, want))
            if not (g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w))]


def _nccl_rank(device, L, rows):
    """In an NCCL world, one GPU a rank: the compiled DP step against
    dp_step on this rank's rows (padded to L << rank, so that the ranks
    capture different keys), over three calls on two batches and a forced
    rescue; the compiled sharded step against seq_step on one read over
    every rank, twice -> the fields that differ, and the graphs captured."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    batches, lengths = _graph_inputs(device, rows, L << rank)
    mesh = make_mesh()
    group = mesh.get_group("data")
    bad, steps = [], []
    for spec in (GRAPH_SPECS["main"], PipelineSpec(l=11, k=3, density=0.05, mode="hpcsimd",
                                                   max_minimizers=4096, tile_cap=8)):
        step = driver.make_dp_pipeline(spec, mesh, device)
        steps.append(step)
        for i in range(3):
            got = step(batches[i % 2], lengths)
            want = driver.dp_step(batches[i % 2], lengths, spec, group)
            bad += _differences((*got.batch, *got[1:]), (*want.batch, *want[1:]),
                                f"DP call {i} {spec.tile_cap}")
        # lost counts the ranks where a read lost minimizers: all of them here
        if int(got.lost) != world * (spec.tile_cap == 8):
            bad.append(f"lost {int(got.lost)}")
    seq_mesh = make_mesh(1, world)
    codes, n = _graph_inputs(device, 1, world << 16)[0][0], torch.full(
        (1,), (world << 16) - 77, dtype=torch.int32, device=device)
    _, cols = batch_sharding(seq_mesh, 1, world << 16, seq_sharded=True)
    local = codes[:, cols].contiguous()
    spec = GRAPH_SPECS["main"]
    sstep = seqshard.make_seq_pipeline(spec, seq_mesh, device)
    steps.append(sstep)
    for i in range(2):
        bad += _differences(sstep(local, n),
                            seqshard.seq_step(local, n, spec, seq_mesh.get_group("seq")),
                            f"sharded call {i}")
    return bad, [len(st.compiled.graphs) for st in steps]


@pytest.fixture
def two_cuda(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: NCCL takes one GPU a rank")
    return cuda


def test_compiled_parallel_steps_world_of_one(cuda):
    """In an NCCL world of one, make_dp_pipeline and make_seq_pipeline
    return captured steps that equal dp_step and seq_step in every field."""
    (bad, graphs), = run_world(_nccl_rank, 1, "nccl", cuda, 1 << 16, 4)
    assert bad == [] and graphs == [1, 1, 1]


def test_compiled_parallel_steps_world_of_two(two_cuda):
    """Two NCCL ranks that pad their rows differently (and so capture at
    different calls) and rescue together: no hang, every field equal."""
    out = run_world(_nccl_rank, 2, "nccl", two_cuda, 1 << 15, 4)
    assert [bad for bad, _ in out] == [[], []] and [g for _, g in out] == [[1, 1, 1]] * 2


# ---- xcode encoding on the card ----------------------------------------------------

from rust_seq2kminmers_torch import constants  # noqa: E402
from rust_seq2kminmers_torch.io import native_ext  # noqa: E402
from rust_seq2kminmers_torch.ops.cuda.xcode import encode_xcodes_cuda  # noqa: E402
from rust_seq2kminmers_torch.ops.xcode import (  # noqa: E402
    READ_START,
    XCODE_ROW,
    encode_xcodes_plain,
)


def _text_rows(seed, B, C):
    """uint8[B, C] of every byte value, with runs, lowercase and N."""
    rng = np.random.default_rng(seed)
    alphabet = np.concatenate([np.frombuffer(b"ACGTNacgtn", dtype=np.uint8),
                               np.arange(256, dtype=np.uint8)])
    pick = rng.choice(alphabet, B * C)
    return np.repeat(pick, rng.integers(1, 6, B * C))[: B * C].reshape(B, C)


@pytest.mark.parametrize("family", ["scalar", "simd"])
@pytest.mark.parametrize("B,C,ragged", [
    (32, 1 << 20, False), (32, 1 << 20, True), (1, 1 << 25, False), (7, 4099, True),
    (3, 16, True),
])
def test_xcode_kernel(cuda, family, B, C, ragged):
    """The kernel equals its plain version bit for bit: full rows; ragged
    lengths (0, 1, 15, 17 and random, with a row of xcodes passed through
    and a row continuing from a real byte before it); a [1, 2^25] chunk
    whose prev is a real byte; C not a multiple of 16 (byte accesses)."""
    rng = np.random.default_rng(C + B)
    raw = torch.from_numpy(_text_rows(B, B, C)).to(cuda)
    lengths = np.full(B, C)
    prev = np.full(B, READ_START)
    if ragged:
        lengths = rng.integers(0, C + 1, B)
        lengths[: min(B, 4)] = [0, 1, 15, 17][: min(B, 4)]
        prev[B - 1] = XCODE_ROW
    if B == 1 or ragged:
        prev[0] = int(rng.integers(0, 256))
    prev_t = torch.from_numpy(prev.astype(np.int32)).to(cuda)
    len_t = torch.from_numpy(np.minimum(lengths, C).astype(np.int32)).to(cuda)
    before = build.launches["xcode"]
    got = encode_xcodes_cuda(raw, prev_t, len_t, family)
    assert build.launches["xcode"] == before + 1
    want = encode_xcodes_plain(raw, prev_t, len_t, family)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_text_never_encoded_on_the_host_on_card(cuda, monkeypatch):
    """A long read given as a str, and kminmers_list given a str, are
    encoded by the kernel: with every host encoder refusing, the records
    (and the minimizer streams) equal the same reads given as xcodes, and
    xcode launched once a chunk (kminmers_long) and once (kminmers_list)."""
    rng = np.random.default_rng(21)
    seqs = ["".join(rng.choice(list("ACGTTTTTNa"), size=n)) for n in (300000, 70001)]
    xcodes = [constants.encode_xcodes(s, "simd") for s in seqs]
    kw = dict(l=31, k=5, density=0.02, mode="hpcsimd", chunk=1 << 16)
    want = kminmers_long_batch(xcodes, device=cuda, **kw)
    want_list = kminmers_list(seqs[1], 31, 5, 0.02, "hpcsimd", device=cuda)

    def refuse(*args, **kwargs):
        raise AssertionError("a host xcode encoder was called")

    for target, name in ((constants, "encode_xcodes"), (constants, "_encode_xcodes_numpy"),
                         (native_ext, "xcode")):
        monkeypatch.setattr(target, name, refuse)
    build.launches.clear()
    got = kminmers_long_batch(seqs, device=cuda, **kw)
    mixed = kminmers_long_batch([seqs[0], xcodes[1]], device=cuda, **kw)
    assert build.launches["xcode"] == 2 * 5  # 5 chunks of 2^16, each encoded once
    for g, m, w in zip(got, mixed, want):
        for key in w:
            assert np.array_equal(g[key], w[key]) and np.array_equal(m[key], w[key]), key
    assert len(want[0]["hash"]) > 1000
    build.launches.clear()
    assert kminmers_list(seqs[1], 31, 5, 0.02, "hpcsimd", device=cuda) == want_list
    assert build.launches["xcode"] == 1 and len(want_list) > 100
    spec = PipelineSpec(l=31, k=5, density=0.02, mode="hpcsimd")
    got_s = long_read.minimizer_stream_long_batch(seqs, spec, chunk=1 << 16, device=cuda)
    want_s = long_read.minimizer_stream_long_batch(xcodes, spec, chunk=1 << 16, device=cuda)
    for g, w in zip(got_s, want_s):
        assert all(np.array_equal(a, b) for a, b in zip(g, w))


def test_kminmers_batch_hpc_u64_equals_the_plain_reference(cuda):
    """``kminmers_batch`` at the spec of the benchmark's u64 configuration
    (hpc, l=31, k=5, d=0.01, 64-bit minimizer hashes) on one [32, 2^20]
    batch of uniform ACGT xcodes, every row full, equals the benchmark's
    plain PyTorch reference on every row, record for record."""
    from benchmark import generate
    from benchmark.reference import kminmers_torch as reference

    B, L = 32, 1 << 20
    codes = generate.draw_pool(2**33 + 18, 1, B, L, cuda)[0]
    lengths = torch.full((B,), L, dtype=torch.int32, device=cuda)
    spec = PipelineSpec(l=31, k=5, density=0.01, mode="hpc", hash_width=64)
    out = kminmers_batch(codes, lengths, spec)
    want = reference.kminmers_rows(codes, lengths, 31, 5, 0.01, "hpc", 64, xcodes=True)
    got_hash = (out.hash_hi.to(torch.int64) << 32) | (out.hash_lo.to(torch.int64) & 0xFFFFFFFF)
    for r, w in enumerate(want):
        n = int(out.n_kminmers[r])
        assert n == len(w["hash"]) > 7000, r
        assert torch.equal(got_hash[r, :n], w["hash"]), r
        assert torch.equal(out.start[r, :n].to(torch.int64), w["start"]), r
        assert torch.equal(out.end[r, :n].to(torch.int64), w["end"]), r
        assert torch.equal(out.rev[r, :n].to(torch.bool), w["rev"]), r


def test_kminmers_batch_ragged_regular_reads_equal_the_plain_reference(cuda):
    """``kminmers_batch`` at the spec of the benchmark's CLI configuration
    (regular, l=31, k=5, d=0.01, u32 minimizer hashes) on one [1024, 16384]
    batch of the reads cell's traffic (lengths in (8192, 16384], XCODE_PAD
    past each) equals the benchmark's plain PyTorch reference on every
    row at its own length, record for record."""
    from benchmark.drivers import resident_reads
    from benchmark.reference import kminmers_torch as reference

    traffic = json.loads((Path(__file__).parents[1] / "benchmark" / "traffic" /
                          "reads.json").read_text())
    traffic["buckets"] = [{"pad": 1 << 14, "batches": 1}]
    codes, lengths = resident_reads.draw_reads(2**33 + 23, traffic, cuda, XCODE_PAD)[0]
    assert codes.shape == (1024, 1 << 14) and int(lengths.min()) < int(lengths.max())
    spec = PipelineSpec(l=31, k=5, density=0.01, mode="regular")
    out = kminmers_batch(codes, lengths, spec)
    want = reference.kminmers_rows(codes, lengths, 31, 5, 0.01, "regular", 32, xcodes=True)
    got_hash = (out.hash_hi.to(torch.int64) << 32) | (out.hash_lo.to(torch.int64) & 0xFFFFFFFF)
    n_all = out.n_kminmers.cpu().tolist()
    for r, w in enumerate(want):
        n = n_all[r]
        assert n == len(w["hash"]) > 40, r
        assert torch.equal(got_hash[r, :n], w["hash"]), r
        assert torch.equal(out.start[r, :n].to(torch.int64), w["start"]), r
        assert torch.equal(out.end[r, :n].to(torch.int64), w["end"]), r
        assert torch.equal(out.rev[r, :n].to(torch.bool), w["rev"]), r
    assert sum(n_all) > 1024 * 100
