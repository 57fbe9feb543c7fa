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
