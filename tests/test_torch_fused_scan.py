"""K1's plain version (rust_seq2kminmers_torch/ops/cuda/fused_scan.py)
against the reference package's fused Pallas kernel in interpret mode,
at B=3, L=2048, block_rows=8.  The two pack survivors into tiles of
different sizes, so they are compared per read as the concatenated
(start, end, hash) stream plus the summed counts; all values are
integers, so equality is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_seq2kminmers_torch.convert import carry_from_jax, carry_to_jax
from rust_seq2kminmers_torch.ops import hpc as port_hpc
from rust_seq2kminmers_torch.ops import nthash as port_nthash
from rust_seq2kminmers_torch.ops.cuda import fused_scan as port
from rust_seq2kminmers_tpu.constants import XCODE_PAD, encode_xcodes
from rust_seq2kminmers_tpu.ops import hpc as jax_hpc
from rust_seq2kminmers_tpu.ops import nthash as jax_nthash
from rust_seq2kminmers_tpu.ops.pallas.fused_scan import (
    fused_minimizer_scan,
    slots_for_density,
)
from rust_seq2kminmers_tpu.ops.pipeline import PipelineSpec, default_rows_out

MODES = ["regular", "simd", "hpc", "hpcsimd"]
TILE = 1024


def _batch(seed, B=3, L=2048, alphabet="AACCGGTTAAAANacgQ"):
    rng = np.random.default_rng(seed)
    codes = np.full((B, L), XCODE_PAD, dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    for b in range(B):
        n = int(rng.integers(L // 2, L - 1))
        s = "".join(rng.choice(list(alphabet), size=n))
        codes[b, :n] = encode_xcodes(s, "scalar")
        lengths[b] = n
    return codes, lengths


def _limit(lengths, spec):
    if spec.is_hpc:
        return np.where(lengths > spec.l, 1 << 30, -1).astype(np.int32)
    return np.where(lengths > spec.l, lengths - spec.l, -1).astype(np.int32)


def _jax_scan(codes, lengths, spec, nslots=None, rows_out=0):
    st, en, hs, cnt = fused_minimizer_scan(
        jnp.asarray(codes),
        jnp.asarray(lengths),
        jnp.asarray(_limit(lengths, spec)),
        spec.l,
        spec.bound,
        spec.strict_threshold,
        spec.is_hpc,
        spec.mode == "hpc",
        nslots=nslots or slots_for_density(spec.density),
        block_rows=8,
        interpret=True,
        rows_out=rows_out or default_rows_out(spec.density, 8),
    )
    st, en, hs, cnt = (np.asarray(a) for a in (st, en, hs, cnt))
    B, nt = cnt.shape[:2]
    per = st.shape[1] // nt * st.shape[2]
    rows = [a.reshape(B, nt, per) for a in (st, en, hs)]
    return rows, cnt


def _port_scan(codes, lengths, spec, cap=None):
    out = port.fused_minimizer_scan(
        torch.from_numpy(codes),
        torch.from_numpy(lengths),
        torch.from_numpy(_limit(lengths, spec)),
        spec.l,
        spec.bound,
        spec.strict_threshold,
        spec.is_hpc,
        spec.mode == "hpc",
        tile=TILE,
        cap=cap,
    )
    *rows, cnt = (t.numpy() for t in out)
    return rows, cnt


def _streams(rows, cnt):
    """Per read: the concatenated kept (start, end, u32 hash) survivors."""
    st, en, hs = rows
    out = []
    for b in range(cnt.shape[0]):
        got = []
        for t in range(cnt.shape[1]):
            n = int(cnt[b, t, 0])
            got += zip(
                st[b, t, :n].tolist(),
                en[b, t, :n].tolist(),
                hs[b, t, :n].view(np.uint32).tolist(),
            )
        out.append(got)
    return out


def _assert_same(codes, lengths, spec, cap=None):
    jrows, jcnt = _jax_scan(codes, lengths, spec)
    prows, pcnt = _port_scan(codes, lengths, spec, cap)
    np.testing.assert_array_equal(pcnt.sum(axis=1), jcnt.sum(axis=1))
    np.testing.assert_array_equal(pcnt[..., 0], pcnt[..., 1])  # nothing lost
    assert _streams(prows, pcnt) == _streams(jrows, jcnt)
    return pcnt


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("l", [5, 31])
def test_fused_scan_matches_reference(mode, l):
    codes, lengths = _batch(seed=l)
    spec = PipelineSpec(l=l, k=2, density=0.05, mode=mode)
    cnt = _assert_same(codes, lengths, spec)
    assert cnt[..., 1].sum() > 0


@pytest.mark.parametrize("mode", ["hpc", "hpcsimd"])
def test_fused_scan_run_spanning_tiles(mode):
    """A homopolymer run across a tile boundary stays one run, and a tile
    inside a run keeps no element at all."""
    rng = np.random.default_rng(7)

    def rand(n):
        return "".join(rng.choice(list("ACGT"), size=n))

    # an 'A' run across the first tile boundary; a 'C' run from 2000 to
    # 3100 covers tile 2 = [2048, 3072)
    s = rand(TILE - 50) + "A" * 120 + rand(906) + "C" * 1100 + rand(696)
    L = 4096
    codes = np.full((1, L), XCODE_PAD, dtype=np.uint8)
    codes[0, : len(s)] = encode_xcodes(s, "scalar")
    lengths = np.array([len(s)], dtype=np.int32)
    spec = PipelineSpec(l=5, k=2, density=0.2, mode=mode)
    cnt = _assert_same(codes, lengths, spec)
    assert cnt[0, 2, 2] == 0  # tile 2 keeps no base


@pytest.mark.parametrize("mode", MODES)
def test_fused_scan_ragged_last_tile(mode):
    """A padded length that is no multiple of the tile: the port's last
    tile is short, where the reference pads its last block.  Streams and
    raw counts agree; the port's stream count is the padded length
    itself in the modes that hash every position."""
    codes, lengths = _batch(seed=17, L=1500)
    spec = PipelineSpec(l=11, k=2, density=0.1, mode=mode)
    jrows, jcnt = _jax_scan(codes, lengths, spec)
    prows, pcnt = _port_scan(codes, lengths, spec)
    assert pcnt.shape[1] == 2
    np.testing.assert_array_equal(pcnt[..., 1].sum(1), jcnt[..., 1].sum(1))
    assert _streams(prows, pcnt) == _streams(jrows, jcnt)
    if spec.is_hpc:
        np.testing.assert_array_equal(pcnt[..., 2].sum(1), jcnt[..., 2].sum(1))
    else:
        assert (pcnt[..., 2].sum(1) == 1500).all()


def test_fused_scan_short_and_gated_reads():
    """Reads with length <= l emit nothing; length l+1 gives two windows
    at density 1."""
    rng = np.random.default_rng(3)
    l, L = 31, 2048
    codes = np.full((3, L), XCODE_PAD, dtype=np.uint8)
    lengths = np.array([l, l - 5, l + 1], dtype=np.int32)
    for b in range(3):
        s = "".join(rng.choice(list("ACGT"), size=int(lengths[b])))
        codes[b, : lengths[b]] = encode_xcodes(s, "scalar")
    for mode in MODES:
        spec = PipelineSpec(l=l, k=2, density=1.0, mode=mode)
        cnt = _assert_same(codes, lengths, spec)
        assert cnt[0, :, 1].sum() == 0 and cnt[1, :, 1].sum() == 0


def test_fused_scan_overflow_detected():
    """A tiny per-tile capacity (and tiny TPU slots and rows) loses
    survivors on both sides: the raw and stream counts still agree, and
    kept < raw shows the loss.  The two drop different survivors, so the
    streams are not compared."""
    codes, lengths = _batch(seed=11)
    spec = PipelineSpec(l=5, k=2, density=0.5, mode="hpcsimd")
    _, jcnt = _jax_scan(codes, lengths, spec, nslots=8, rows_out=1)
    _, pcnt = _port_scan(codes, lengths, spec, cap=16)
    np.testing.assert_array_equal(
        pcnt[..., 1:].sum(axis=1), jcnt[..., 1:].sum(axis=1)
    )
    assert (pcnt[..., 0].sum(axis=1) < pcnt[..., 1].sum(axis=1)).all()
    assert (jcnt[..., 0].sum(axis=1) < jcnt[..., 1].sum(axis=1)).all()
    assert (pcnt[..., 0] <= 16).all()


def test_hash_and_keep_stages_match_reference():
    """The plain stages K1 is built from: sliding canonical NtHash1-32,
    the sliding window XOR, the HPC keep mask and the device keep-bit
    stamp, against the reference package's XLA versions."""
    codes, lengths = _batch(seed=13, B=2, L=1500)
    for l in (1, 2, 31, 200):
        got = port_nthash.sliding_nthash32(torch.from_numpy(codes & 7), l)
        want = jax_nthash.sliding_nthash32(jnp.asarray(codes & 7), l)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        port_hpc.hpc_keep_mask(torch.from_numpy(codes), torch.from_numpy(lengths)),
        np.asarray(jax_hpc.hpc_keep_mask(jnp.asarray(codes), jnp.asarray(lengths))),
    )
    plain = np.random.default_rng(2).integers(0, 4, size=(3, 700)).astype(np.uint8)
    np.testing.assert_array_equal(
        port_hpc.with_keep_bits_device(torch.from_numpy(plain)).numpy(),
        np.asarray(jax_hpc.with_keep_bits_device(jnp.asarray(plain))),
    )


def test_fused_scan_default_cap_is_lossless_at_density():
    """The density-derived per-tile capacity keeps every survivor of a
    typical read at the main-path density."""
    codes, lengths = _batch(seed=5, B=2, L=8192, alphabet="ACGT")
    spec = PipelineSpec(l=31, k=5, density=0.01, mode="hpcsimd")
    cap = port.default_tile_cap(spec.density, TILE)
    assert cap < TILE
    _assert_same(codes, lengths, spec, cap=cap)


# ---- K1's carry: a read scanned in two chunks --------------------------------

CHUNK = 2048


def _carry_reads(seed):
    """Three reads of two chunks each: random bases; a homopolymer run over
    the whole second chunk (in the hpc modes its carry passes through);
    a first chunk that keeps fewer than 200 bases (base < l at l = 200)."""
    rng = np.random.default_rng(seed)

    def rand(n, alphabet="ACGTN"):
        return "".join(rng.choice(list(alphabet), size=n))

    seqs = [
        rand(2 * CHUNK - 100, "AACCGGTTAAAANacgQ"),
        rand(1500) + "A" * 2800,
        rand(150) + "C" * 1900 + rand(1800),
    ]
    codes = np.full((3, 2 * CHUNK), XCODE_PAD, dtype=np.uint8)
    lengths = np.zeros(3, dtype=np.int64)
    for b, s in enumerate(seqs):
        s = s[: 2 * CHUNK]
        codes[b, : len(s)] = encode_xcodes(s, "scalar")
        lengths[b] = len(s)
    return codes, lengths


def _jax_chunk(codes, lengths, spec, ci, base0, pend0):
    local = np.clip(lengths - ci * CHUNK, 0, CHUNK).astype(np.int32)
    st, en, hs, cnt, pend = fused_minimizer_scan(
        jnp.asarray(codes[:, ci * CHUNK : (ci + 1) * CHUNK]),
        jnp.asarray(local),
        jnp.asarray(_limit(lengths, spec)),
        spec.l, spec.bound, spec.strict_threshold, spec.is_hpc,
        spec.mode == "hpc",
        nslots=slots_for_density(spec.density),
        block_rows=8,
        interpret=True,
        rows_out=default_rows_out(spec.density, 8),
        base0=None if base0 is None else jnp.asarray(base0),
        pend0=None if pend0 is None else jnp.asarray(pend0),
        emit_carry=True,
        hash_width=spec.hash_width,
    )
    st, en, cnt, pend = (np.asarray(a) for a in (st, en, cnt, pend))
    hs = np.asarray(hs[1] if spec.hash_width == 64 else hs)
    B, nt = cnt.shape[:2]
    per = st.shape[1] // nt * st.shape[2]
    rows = [a.reshape(B, nt, per) for a in (st, en, hs)]
    return rows, cnt, pend


@pytest.mark.parametrize("mode,l,hash_width", [
    ("regular", 31, 32), ("hpc", 31, 32), ("hpcsimd", 200, 32), ("hpc", 200, 64),
])
def test_fused_scan_carry_matches_reference(mode, l, hash_width):
    """Chunk 1 runs fresh in the reference; its carry, rebased, starts
    chunk 2 in both packages.  Chunk 2's survivor streams, count sums and
    the real part of the carry-out (its last min(base, l) elements) agree;
    the carry is two TPU rows at l = 200.  And the reference, resumed from
    the port's own chunk-1 carry, gives the same chunk 2."""
    codes, lengths = _carry_reads(l + hash_width)
    spec = PipelineSpec(l=l, k=2, density=0.1, mode=mode, hash_width=hash_width)
    _, cnt1, pend1 = _jax_chunk(codes, lengths, spec, 0, None, None)
    base1 = cnt1[..., 2].sum(axis=1).astype(np.int32)
    pend1 = pend1 - (CHUNK << 3)
    jrows, jcnt, jpend = _jax_chunk(codes, lengths, spec, 1, base1, pend1)

    base0, carry0 = carry_from_jax(base1, pend1, l)
    local = np.clip(lengths - CHUNK, 0, CHUNK).astype(np.int32)
    *prows, pcnt, pcarry = port.fused_minimizer_scan(
        torch.from_numpy(codes[:, CHUNK:].copy()),
        torch.from_numpy(local),
        torch.from_numpy(_limit(lengths, spec)),
        spec.l, spec.bound, spec.strict_threshold, spec.is_hpc, spec.mode == "hpc",
        tile=TILE, hash_width=hash_width, base0=base0, carry0=carry0,
        emit_carry=True,
    )
    prows[2] = prows[2][1] if hash_width == 64 else prows[2]
    prows, pcnt = [t.numpy() for t in prows], pcnt.numpy()
    np.testing.assert_array_equal(pcnt.sum(axis=1), jcnt.sum(axis=1))
    assert _streams(prows, pcnt) == _streams(jrows, jcnt)
    assert cnt1[..., 1].sum() > 0 and jcnt[..., 1].sum() > 0
    base2 = base1 + pcnt[..., 2].sum(axis=1)
    want = carry_from_jax(base2, jpend, l)[1].numpy()
    for b in range(3):
        real = min(int(base2[b]), l)
        np.testing.assert_array_equal(pcarry[b, l - real :].numpy(), want[b, l - real :])
    if spec.is_hpc:
        assert pcnt[1, :, 2].sum() <= 1  # the run's chunk keeps (almost) nothing
        assert base1[2] < l or l == 31  # at l = 200, read 2 starts chunk 2 at base < l

    # The other way: the port runs chunk 1 fresh, and the reference resumes
    # chunk 2 from the port's carry, converted by carry_to_jax.
    *_, pcnt1, pcarry1 = port.fused_minimizer_scan(
        torch.from_numpy(codes[:, :CHUNK].copy()),
        torch.from_numpy(np.clip(lengths, 0, CHUNK).astype(np.int32)),
        torch.from_numpy(_limit(lengths, spec)),
        spec.l, spec.bound, spec.strict_threshold, spec.is_hpc, spec.mode == "hpc",
        tile=TILE, hash_width=hash_width, emit_carry=True,
    )
    pbase1 = pcnt1[..., 2].sum(dim=1, dtype=torch.int32)
    np.testing.assert_array_equal(pbase1.numpy(), base1)
    base0_j, pend0_j = carry_to_jax(pbase1, pcarry1 - (CHUNK << 3))
    xrows, xcnt, _ = _jax_chunk(codes, lengths, spec, 1, base0_j, pend0_j)
    np.testing.assert_array_equal(xcnt.sum(axis=1), jcnt.sum(axis=1))
    assert _streams(xrows, xcnt) == _streams(jrows, jcnt)


def test_carry_conversion_round_trips():
    """carry_to_jax then carry_from_jax is the identity, and the reverse
    keeps the last l elements of the reference's 8 x 128 layout."""
    rng = np.random.default_rng(1)
    for l in (2, 31, 200, 255):
        base = torch.from_numpy(rng.integers(0, 2**31 - 1, 4).astype(np.int32))
        carry = torch.from_numpy(
            rng.integers(-(2**31), 2**31 - 1, (4, l)).astype(np.int32)
        )
        base0, pend0 = carry_to_jax(base, carry)
        assert pend0.shape == (4, 8, 128) and pend0.dtype == np.int32
        assert not pend0.reshape(4, -1)[:, : 1024 - l].any()
        b2, c2 = carry_from_jax(base0, pend0, l)
        assert torch.equal(b2, base) and torch.equal(c2, carry)
        pend = rng.integers(-(2**31), 2**31 - 1, (4, 8, 128)).astype(np.int32)
        back = carry_to_jax(*carry_from_jax(base0, pend, l))[1].reshape(4, -1)
        np.testing.assert_array_equal(back[:, 1024 - l :], pend.reshape(4, -1)[:, 1024 - l :])


# ---- K1's tiles: passes 1-2 as per-tile carries ------------------------------


def _seq_codes(seqs, L):
    codes = np.full((len(seqs), L), XCODE_PAD, dtype=np.uint8)
    lengths = np.zeros(len(seqs), dtype=np.int32)
    for b, s in enumerate(seqs):
        codes[b, : len(s)] = encode_xcodes(s[:L], "scalar")
        lengths[b] = min(len(s), L)
    return codes, lengths


def _tile_case(name):
    """-> (codes, lengths, spec, tile, base0, carry0): one row scanned
    whole and tile by tile.  base0 / carry0 are None for a fresh read."""
    rng = np.random.default_rng(sum(map(ord, name)))

    def rand(n, alphabet="ACGTN"):
        return "".join(rng.choice(list(alphabet), size=n))

    base0 = carry0 = None
    if name == "tile1024":
        codes, lengths = _batch(seed=41, L=4096)
        return codes, lengths, PipelineSpec(l=31, k=2, density=0.05, mode="hpcsimd"), 1024, None, None
    if name == "homopolymer":  # an 'A' run over tiles 3-6 of 256 bases
        codes, lengths = _seq_codes([rand(700) + "A" * 1200 + rand(2100), rand(4000)], 4096)
        spec = PipelineSpec(l=31, k=2, density=0.1, mode="hpc")
        return codes, lengths, spec, 256, None, None
    if name == "carry":
        # Chunk 1 keeps ~100 elements (base0 < l = 200); chunk 2 opens with
        # the same run over its first two tiles, so their pending prefixes
        # and the third's come from the carry.
        C = 2048
        seqs = [rand(100) + "C" * (C - 100 + 600) + rand(C - 700), rand(2 * C - 50)]
        full, lengths = _seq_codes(seqs, 2 * C)
        spec = PipelineSpec(l=200, k=2, density=0.1, mode="hpcsimd")
        *_, carry = port.fused_scan_plain(
            torch.from_numpy(full[:, :C].copy()), torch.from_numpy(np.minimum(lengths, C)),
            torch.from_numpy(_limit(lengths, spec)), spec.l, spec.bound,
            spec.strict_threshold, True, False, C, C, emit_carry=True,
        )
        keep = port_hpc.hpc_keep_mask(torch.from_numpy(full[:, :C].copy()),
                                      torch.from_numpy(np.minimum(lengths, C)))
        base0 = keep.sum(dim=1, dtype=torch.int32).numpy()
        assert base0[0] < spec.l
        carry0 = (carry - (C << 3)).numpy()
        return full[:, C:].copy(), (lengths - C).astype(np.int32), spec, 256, base0, carry0
    if name == "ragged":  # reads ending mid-tile, and of length <= l
        codes, lengths = _seq_codes([rand(31), rand(26), rand(1500), rand(700)], 2048)
        return codes, lengths, PipelineSpec(l=31, k=2, density=0.5, mode="hpc"), 512, None, None
    if name == "regular_limit":  # limit = length - l, a tile that divides nothing
        codes, lengths = _batch(seed=43, B=3, L=2048)
        return codes, lengths, PipelineSpec(l=31, k=2, density=0.1, mode="regular"), 300, None, None
    if name == "l2":
        codes, lengths = _batch(seed=44, L=2048)
        return codes, lengths, PipelineSpec(l=2, k=2, density=0.1, mode="hpcsimd"), 100, None, None
    if name == "l255":  # tiles shorter than l: a prefix spans several tiles
        codes, lengths = _batch(seed=45, L=4096)
        return codes, lengths, PipelineSpec(l=255, k=2, density=0.1, mode="hpc"), 128, None, None
    width, variant, mode = {"w16": (16, "nthash1", "regular"), "w64": (64, "nthash1", "hpc"),
                            "nthash2": (32, "nthash2", "hpcsimd")}[name]
    codes, lengths = _batch(seed=width, L=2048)
    spec = PipelineSpec(l=31, k=2, density=0.1, mode=mode, hash_width=width, variant=variant)
    return codes, lengths, spec, 700 if width == 64 else 512, None, None


def _jax_streams(codes, lengths, spec, base0, carry0):
    """The reference's survivor streams (start, end, hash bits) per read and
    its summed (raw, stream) counts, resumed from the port's carry."""
    jb = jp = None
    if base0 is not None:
        jb, jp = carry_to_jax(torch.from_numpy(base0), torch.from_numpy(carry0))
    st, en, hs, cnt = fused_minimizer_scan(
        jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(_limit(lengths, spec)),
        spec.l, spec.bound, spec.strict_threshold, spec.is_hpc, spec.mode == "hpc",
        nslots=slots_for_density(spec.density), block_rows=8, interpret=True,
        rows_out=default_rows_out(spec.density, 8), variant=spec.variant,
        hash_width=spec.hash_width,
        base0=None if jb is None else jnp.asarray(jb),
        pend0=None if jp is None else jnp.asarray(jp),
    )
    cnt = np.asarray(cnt)
    cols = [st, en, *(hs if spec.hash_width == 64 else (hs,))]
    B, nt = cnt.shape[:2]
    rows = [np.asarray(c).reshape(B, nt, -1) for c in cols]
    return _tile_streams(rows, cnt), cnt[..., 1:].sum(axis=1)


def _tile_streams(rows, cnt):
    """Per read: the concatenated kept survivors, one tuple per survivor."""
    out = []
    for b in range(cnt.shape[0]):
        got = []
        for t in range(cnt.shape[1]):
            n = int(cnt[b, t, 0])
            got += zip(*(r[b, t, :n].tolist() for r in rows))
        out.append(got)
    return out


TILE_CASES = ["tile1024", "homopolymer", "carry", "ragged", "regular_limit", "l2", "l255",
              "w16", "w64", "nthash2"]


@pytest.mark.parametrize("case", TILE_CASES)
def test_tile_carries_decompose_the_scan(case):
    """Passes 1-2's plain version gives each tile its first rank and
    pending prefix; the plain scan of each tile alone from that carry
    (positions shifted by t * tile) equals the whole row's scan, slots,
    counts and carry-out, and the whole row equals the reference."""
    codes, lengths, spec, tile, base0, carry0 = _tile_case(case)
    B, L = codes.shape
    nt = -(-L // tile)
    c, n, lim = (torch.from_numpy(a) for a in (codes, lengths, _limit(lengths, spec)))
    b0 = None if base0 is None else torch.from_numpy(base0)
    k0 = None if carry0 is None else torch.from_numpy(carry0)
    wv = (spec.hash_width, spec.variant)
    sargs = (lim, spec.l, spec.bound, spec.strict_threshold, spec.is_hpc, spec.mode == "hpc")
    base, pending = port.tile_carries(c, n, spec.l, tile, spec.is_hpc, b0, k0)
    assert base.shape == (B, nt + 1) and pending.shape == (B, nt + 1, spec.l)
    assert base.dtype == pending.dtype == torch.int32
    *whole, wcnt, wcarry = port.fused_scan_plain(c, n, *sargs, tile, tile, *wv, b0, k0, True)
    whole = [whole[0], whole[1], *(whole[2] if spec.hash_width == 64 else (whole[2],))]
    start0 = torch.zeros(B, dtype=torch.int32) if b0 is None else b0
    assert torch.equal(base[:, 0], start0)
    assert torch.equal(base[:, 1:] - base[:, :-1], wcnt[:, :, 2])
    assert torch.equal(pending[:, nt], wcarry)
    for t in range(nt):
        lo, hi = t * tile, min(L, (t + 1) * tile)
        *part, pcnt, pcarry = port.fused_scan_plain(
            c[:, lo:hi].contiguous(), (n - lo).clamp(0, hi - lo).to(torch.int32), *sargs,
            tile, tile, *wv, base[:, t].contiguous(), pending[:, t] - (lo << 3), True,
        )
        part = [part[0] + lo, part[1] + lo, *(part[2] if spec.hash_width == 64 else (part[2],))]
        assert torch.equal(pcnt[:, 0], wcnt[:, t])
        for got, want in zip(part, whole):
            assert torch.equal(port.valid_slots(got, pcnt)[:, 0], want[:, t])
        assert torch.equal(pcarry + (lo << 3), pending[:, t + 1])
    rows = [w.numpy() for w in whole]
    if spec.hash_width == 64:
        rows = rows[:2] + [rows[2], rows[3]]  # (hi, lo), as the reference
    jstreams, jsums = _jax_streams(codes, lengths, spec, base0, carry0)
    assert _tile_streams(rows, wcnt.numpy()) == jstreams
    np.testing.assert_array_equal(wcnt[..., 1:].sum(dim=1).numpy(), jsums)
    assert int(wcnt[..., 1].sum()) > 0
    if case == "homopolymer":
        assert (wcnt[0, 3:7, 2] == 0).all()
    if case == "carry":
        assert (wcnt[0, :2, 2] == 0).all() and torch.equal(pending[0, 2], k0[0])
    if case == "ragged":
        assert int(wcnt[:2, :, 1].sum()) == 0
