"""The general scan's algebra and plain version on the CPU.

``csrc/general_scan.cu`` hashes whole rows tile by tile: each chunk of C
positions XORs its rotated terms, a scan within the tile gives each
chunk's prefix there and the tile's XOR, an exclusive XOR scan of the
tiles gives P at each tile's start, and a window is P(i + l) ^ P(i), where
each prefix starts from the chunk below it (its tile's prefix and the
chunk's within the tile) and adds the terms from that chunk's start.  l
may span many tiles.  A plain copy of that decomposition
(``_tiled_window_xor``) is held to the port's ``canonical_nthash`` and to
the reference package's ``sliding_nthash*`` at every width, for l below,
at and past a small tile.  Then ``general_minimizers_plain`` (the kernel's
plain version), after K4's HPC form on the CPU, against the reference's
general path, output by output.  All values are integers and compared
exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_seq2kminmers_torch.constants import (
    XCODE_PAD,
    encode_xcodes,
    family_of_mode,
    seed_tables,
    seed_tables_nthash2_31,
)
from rust_seq2kminmers_torch.convert import spec_from_jax
from rust_seq2kminmers_torch.ops.cuda.general_scan import (
    general_minimizers,
    general_minimizers_plain,
)
from rust_seq2kminmers_torch.ops.cuda.masked_compact import hpc_compact
from rust_seq2kminmers_torch.ops.nthash import _rol16, _rol31, canonical_nthash, seed_lookup
from rust_seq2kminmers_torch.ops.u64 import rol32, rol64, ult64
from rust_seq2kminmers_tpu.ops import nthash as jax_nthash
from rust_seq2kminmers_tpu.ops.pipeline import PipelineSpec as JaxSpec
from rust_seq2kminmers_tpu.ops.pipeline import kminmer_pipeline as jax_pipeline

T = 64  # a small tile: l = 1 and 63 stay inside one, 65 and 197 cross tiles
C = 16  # positions a chunk, as a kernel thread owns them
WIDTHS = [(16, "nthash1"), (32, "nthash1"), (64, "nthash1"), (32, "nthash2")]


def _xor_scan(x):
    """Inclusive XOR scan along the last dim, by doubling."""
    s = 1
    while s < x.shape[-1]:
        y = x.clone()
        y[..., s:] ^= x[..., :-s]
        x, s = y, 2 * s
    return x


def _tiled_window_xor(terms, l, tile, chunk=C):
    """The kernel's decomposition: terms int64[B, L] -> the XOR of every
    window of l terms, [B, L - l + 1].  Terms past L are 0."""
    B, L = terms.shape
    nt = -(-L // tile)
    padded = (nt + l // tile + 3) * tile  # whole tiles past every i + l
    a = torch.nn.functional.pad(terms, (0, padded - L))  # zeros past L
    ex_in = _xor_scan(a.view(B, -1, chunk))  # within each chunk ...
    cx = ex_in[..., -1]  # ... its XOR,
    ex_in = (ex_in ^ a.view(B, -1, chunk)).view(B, -1)  # and XOR[chunk start, p)
    per_tile = cx[:, : nt * tile // chunk].view(B, nt, -1)
    cin = (_xor_scan(per_tile) ^ per_tile).view(B, -1)  # pass 1: chunk prefix in its tile
    tp = torch.cat([torch.zeros_like(cx[:, :1]),  # pass 2: P(t T), t = 0 .. nt
                    _xor_scan(_xor_scan(per_tile)[..., -1])], dim=1)

    def p_chunk(p):  # P at chunk starts p: the tile's and the chunk's prefix
        t = (p // tile).clamp(max=nt - 1)
        inside = tp[:, t] ^ cin[:, (p // chunk).clamp(max=cin.shape[1] - 1)]
        return torch.where(p < nt * tile, inside, tp[:, nt : nt + 1])

    i = torch.arange(L - l + 1)
    j0 = i // chunk * chunk  # the thread's first window
    c = (j0 + l) // chunk * chunk  # the chunk holding j0 + l
    pa = p_chunk(j0) ^ ex_in[:, i]
    # XOR[c, i + l): i + l - c < 2 chunks, so at most the chunk c whole.
    crossed = (i + l) // chunk != c // chunk
    pb = p_chunk(c) ^ ex_in[:, i + l] ^ torch.where(crossed, cx[:, c // chunk], 0)
    return pa ^ pb


def _tiled_nthash(codes, l, hash_width, variant, tile):
    """(fh, rh) of every window from the tiled decomposition."""
    if variant == "nthash2":
        tables, rol = seed_tables_nthash2_31(), _rol31
    else:
        tables = seed_tables(hash_width)
        rol = {16: _rol16, 32: rol32, 64: rol64}[hash_width]
    j = torch.arange(codes.shape[1])
    af = rol(seed_lookup(tables[0], codes), -j)
    ar = rol(seed_lookup(tables[1], codes), j)
    i = torch.arange(codes.shape[1] - l + 1)
    fh = rol(_tiled_window_xor(af, l, tile), l - 1 + i)
    rh = rol(_tiled_window_xor(ar, l, tile), -i)
    return fh, rh


def _jax_sliding(codes, l, hash_width, variant):
    """The reference's (fh, rh) as int64 (u64 as bit patterns)."""
    c = jnp.asarray(codes)
    if variant == "nthash2":
        fh, rh = jax_nthash.sliding_nthash2_31(c, l)
    elif hash_width == 64:
        pairs = jax_nthash.sliding_nthash64(c, l)
        return [
            ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
             | np.asarray(lo).astype(np.uint64)).view(np.int64)
            for hi, lo in pairs
        ]
    elif hash_width == 16:
        fh, rh = jax_nthash.sliding_nthash16(c, l)
    else:
        fh, rh = jax_nthash.sliding_nthash32(c, l)
    return [np.asarray(x).astype(np.int64) for x in (fh, rh)]


@pytest.mark.parametrize("hash_width,variant", WIDTHS)
@pytest.mark.parametrize("l", [1, 256, 301, T - 1, T, T + 1, 3 * T + 5])
def test_tiled_prefix_xor_equals_sliding_hash(hash_width, variant, l):
    """Rows of 70,001 codes (ranks past 2^16, a ragged last tile), every
    code 0-7 (7 has seed 0): the tiled windows equal the reference's
    sliding hashes and the port's canonical_nthash, window for window."""
    codes = np.random.default_rng(l + hash_width).integers(0, 8, (2, 70001), dtype=np.uint8)
    fh, rh = _tiled_nthash(torch.from_numpy(codes), l, hash_width, variant, T)
    want_f, want_r = _jax_sliding(codes, l, hash_width, variant)
    np.testing.assert_array_equal(fh.numpy(), want_f)
    np.testing.assert_array_equal(rh.numpy(), want_r)
    h = torch.where(ult64(rh, fh), rh, fh) if hash_width == 64 else torch.minimum(fh, rh)
    assert torch.equal(h, canonical_nthash(torch.from_numpy(codes), l, hash_width, variant))


def _batch(seed, mode, short, B=3, L=2048):
    """Ragged reads with homopolymer runs; read 2 has ``short`` bases."""
    rng = np.random.default_rng(seed)
    codes = np.full((B, L), XCODE_PAD, dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    for b in range(B):
        n = int(rng.integers(L // 2, L - 1)) if b < 2 else short
        s = "".join(rng.choice(list("AAACCGGTTTNacgQ"), size=n))
        codes[b, :n] = encode_xcodes(s, family_of_mode(mode))
        lengths[b] = n
    return codes, lengths


GENERAL_CASES = [
    (mode, l, w, v)
    for mode in ("regular", "simd", "hpc", "hpcsimd")
    for l in (1, 301)
    for w, v in WIDTHS
    if w == 32 or mode in ("regular", "hpc")
]


@pytest.mark.parametrize("mode,l,hash_width,variant", GENERAL_CASES)
def test_general_minimizers_plain_matches_reference(mode, l, hash_width, variant):
    """K4's HPC form (hpc modes) and then general_minimizers_plain, as the
    pipeline calls them, give the reference general path's six minimizer
    outputs: starts, ends, hashes (low and high words), n_min and n_raw.
    A capacity below the selected count drops the same minimizers; a read
    of exactly l bases has no window."""
    codes, lengths = _batch(l + hash_width + len(mode), mode, short=l)
    jspec = JaxSpec(l=l, k=3, density=0.6 if l == 1 else 0.05, mode=mode,
                    max_minimizers=200, hash_width=hash_width, variant=variant)
    want = jax.jit(lambda c, n: jax_pipeline(c, n, jspec))(
        jnp.asarray(codes), jnp.asarray(lengths))
    spec = spec_from_jax(jspec)
    c, n = torch.from_numpy(codes), torch.from_numpy(lengths)
    stream, eff_len = hpc_compact(c, n) if spec.is_hpc else (c, n)
    got = general_minimizers(
        stream, eff_len, n, l, spec.bound, spec.strict_threshold, mode, hash_width,
        variant, spec.capacity_for(codes.shape[1]),
    )
    plain = general_minimizers_plain(
        stream, eff_len, n, l, spec.bound, spec.strict_threshold, mode, hash_width,
        variant, spec.capacity_for(codes.shape[1]),
    )
    hi = got[3] if hash_width == 64 else torch.zeros_like(got[2])
    names = ("min_start", "min_end", "min_hash", "min_hash_hi", "n_minimizers",
             "n_minimizers_raw")
    for name, g in zip(names, (*got[:3], hi, *got[4:])):
        ref = np.asarray(getattr(want, name))
        np.testing.assert_array_equal(g.numpy(), ref.view(np.int32), err_msg=name)
    for g, p in zip(got, plain):
        assert (g is None and p is None) or torch.equal(g, p)
    assert int(got[5][0]) > 0 and int(got[5][2]) == 0
    assert (got[5] > got[4]).any() or l == 301


def test_general_minimizers_rejects_bad_input():
    codes, lengths = (torch.from_numpy(x) for x in _batch(1, "regular", 5, L=512))
    args = (lengths, lengths, 31, 100, False)
    with pytest.raises(TypeError):  # the hpc modes take the packed int32 stream
        general_minimizers(codes, *args, "hpc", 32, "nthash1", 64)
    with pytest.raises(ValueError, match="mode"):
        general_minimizers(codes, *args, "foo", 32, "nthash1", 64)
    with pytest.raises(ValueError, match="l="):
        general_minimizers(codes, lengths, lengths, 512, 100, False, "regular", 32,
                           "nthash1", 64)
    with pytest.raises(ValueError, match="bound"):
        general_minimizers(codes, lengths, lengths, 31, 1 << 32, False, "regular", 32,
                           "nthash1", 64)
    with pytest.raises(ValueError, match="m="):
        general_minimizers(codes, *args, "regular", 32, "nthash1", 0)
