"""Plain NumPy k-min-mers: the benchmark's reference semantics.

Written from the definitions of rust-seq2kminmers (Ekim, Berger and
Chikhi's k-min-mer sketch) and held to the crate's golden hashes by
``benchmark/tests``.  It imports numpy only: nothing of the measured
program, of jax or of the JAX package.  Everything is recomputed from the
sequence's bytes (or from xcodes the benchmark made).

The steps, for one sequence:

1. Each byte maps to a 3-bit code by the mode's table: the scalar modes
   (regular, hpc) know uppercase ACGTN only and hash every other byte,
   lowercase included, as OTHER; the SIMD modes (simd, hpcsimd) look up
   the byte's low nibble, so case folds and every non-base maps to N.
2. The HPC modes keep the first byte of every run of equal raw bytes;
   positions stay those of the original sequence.
3. Every window of l kept codes gets the canonical NtHash1 at the hash
   width w: the forward hash XORs each base's seed rotated left by its
   distance from the window's end, the reverse hash XORs the
   complement's seed rotated by its distance from the start, and the
   canonical hash is the smaller.  Seeds are the low w bits of NtHash's
   64-bit seeds.
4. A window is a minimizer when its hash passes the density bound:
   ``<=`` the f64 bound trunc(d * (2^w - 1)) in the scalar modes, ``<``
   the bound recomputed through f32 in the SIMD modes.  The scalar HPC
   mode never emits its last window.
5. Minimizer hashes mix to 64 bits (u16 murmur with rotates, u32
   xorshift, u64 identity), and every k consecutive minimizers give one
   k-min-mer: the same canonical rotate-XOR hash at width 64 over the
   mixed hashes, rev when the reverse hash is the smaller.

A record's start is its first minimizer's start and its end is its last
minimizer's end, where a minimizer spans positions [i, i + l - 1]
(regular, simd), [run i, last byte of run i + l - 1] (hpc) or [run i,
run i + l - 1] (hpcsimd), runs named by their first byte.
"""

from __future__ import annotations

import numpy as np

MODES = ("regular", "hpc", "simd", "hpcsimd")

# NtHash's 64-bit seeds of A, C, G and T.
_SEED64 = {
    "A": 0x3C8BFBB395C60474,
    "C": 0x3193C18562A02B4C,
    "G": 0x20323ED082572324,
    "T": 0x295549F54BE24456,
}
_COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A"}
# Codes 0-3 are A, C, G, T; 4 is N (seed 0), 5 OTHER (seed 1), 6 the
# padding past a row's length (seed 0), 7 unused.
_N, _OTHER = 4, 5
_XCODE_KEEP = 8


def _byte_tables():
    scalar = np.full(256, _OTHER, dtype=np.uint8)
    for code, base in enumerate("ACGTN"):
        scalar[ord(base)] = code
    # The SIMD table reads the low nibble alone: A 0x1, C 0x3, G 0x7, T 0x4.
    nibble = np.full(16, _N, dtype=np.uint8)
    for code, base in enumerate("ACGT"):
        nibble[ord(base) & 0x0F] = code
    return scalar, nibble[np.arange(256) & 0x0F]


_SCALAR_TABLE, _SIMD_TABLE = _byte_tables()


def seeds(width: int, reverse: bool) -> np.ndarray:
    """The 8 codes' seeds at a hash width, as uint64 (reverse: the
    complement's seed)."""
    mask = (1 << width) - 1
    out = np.zeros(8, dtype=np.uint64)
    for code, base in enumerate("ACGT"):
        out[code] = _SEED64[_COMPLEMENT[base] if reverse else base] & mask
    out[_OTHER] = 1
    return out


def _rotl(x: np.ndarray, r: int, width: int) -> np.ndarray:
    r %= width
    mask = np.uint64((1 << width) - 1)
    if r == 0:
        return x & mask
    return ((x << np.uint64(r)) | (x >> np.uint64(width - r))) & mask


def bound(density: float, width: int, simd: bool) -> int:
    """The density bound: trunc(d * (2^w - 1)) in f64, clamped, for the
    scalar modes; in the SIMD modes (width 32 only) that bound is turned
    back into a density and multiplied out again in f32, where
    2^32 - 1 rounds to 2^32, then truncated and saturated."""
    hmax = (1 << width) - 1
    scalar = min(hmax, max(0, int(np.float64(density) * np.float64(hmax))))
    if not simd:
        return scalar
    ratio = np.float32(np.float64(scalar) / np.float64(hmax))
    prod = float(ratio * np.float32(hmax))
    return 0 if prod <= 0.0 else min(hmax, int(prod))


def window_hashes(codes: np.ndarray, l: int, width: int) -> np.ndarray:
    """Canonical NtHash1 of every window of l codes, by its definition:
    one XOR a position of the window."""
    nw = len(codes) - l + 1
    dt = np.uint32 if width <= 32 else np.uint64
    fwd = np.zeros(nw, dtype=dt)
    rev = np.zeros(nw, dtype=dt)
    sf, sr = seeds(width, False), seeds(width, True)
    for t in range(l):
        window = codes[t : t + nw]
        fwd ^= _rotl(sf, l - 1 - t, width).astype(dt)[window]
        rev ^= _rotl(sr, t, width).astype(dt)[window]
    return np.minimum(fwd, rev).astype(np.uint64)


def mix(h: np.ndarray, width: int) -> np.ndarray:
    """A minimizer hash of width 16, 32 or 64 mixed to 64 bits."""
    x = h.astype(np.uint64)
    if width == 64:
        return x
    if width == 32:
        x ^= x << np.uint64(13)
        x ^= x >> np.uint64(7)
        x ^= x << np.uint64(17)
        return x
    with np.errstate(over="ignore"):
        x ^= _rotl(x, 33, 64)
        x *= np.uint64(0xFF51AFD7ED558CCD)
        x ^= _rotl(x, 33, 64)
        x *= np.uint64(0xC4CEB9FE1A85EC53)
        x ^= _rotl(x, 33, 64)
    return x


def _empty() -> dict:
    return {
        "hash": np.zeros(0, dtype=np.uint64),
        "start": np.zeros(0, dtype=np.int64),
        "end": np.zeros(0, dtype=np.int64),
        "rev": np.zeros(0, dtype=bool),
    }


def minimizers(seq: np.ndarray, l: int, density: float, mode: str, width: int = 32,
               xcodes: bool = False):
    """-> (start, end, hash) arrays of the density-selected minimizers.
    ``seq`` is a uint8 array of raw bytes, or with ``xcodes`` of
    ``(keep << 3) | code`` values whose keep bit marks a byte that differs
    from the one before it."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    simd = mode in ("simd", "hpcsimd")
    seq = np.asarray(seq, dtype=np.uint8)
    n = len(seq)
    if xcodes:
        codes = seq & np.uint8(7)
        keep = (seq & np.uint8(_XCODE_KEEP)) != 0
    else:
        codes = (_SIMD_TABLE if simd else _SCALAR_TABLE)[seq]
        keep = np.ones(n, dtype=bool)
        keep[1:] = seq[1:] != seq[:-1]
    none = np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64), np.zeros(0, np.uint64)
    if n <= l:  # the crate builds no window unless the read is longer than l
        return none
    if mode in ("hpc", "hpcsimd"):
        if n:
            keep[0] = True
        pos = np.flatnonzero(keep)
        codes = codes[pos]
    else:
        pos = np.arange(n, dtype=np.int64)
    if len(codes) < l:
        return none
    h = window_hashes(codes, l, width)
    if mode == "hpc":
        h = h[: len(codes) - l]  # the last HPC window is never emitted
    b = np.uint64(bound(density, width, simd))
    sel = np.flatnonzero(h < b if simd else h <= b)
    start = pos[sel]
    if mode == "hpc":
        end = pos[sel + l] - 1
    elif mode == "hpcsimd":
        end = pos[sel + l - 1]
    else:
        end = start + (l - 1)
    return start.astype(np.int64), end.astype(np.int64), h[sel]


def kminmers(seq: np.ndarray, l: int, k: int, density: float, mode: str,
             width: int = 32, xcodes: bool = False) -> dict:
    """All k-min-mers of one sequence, in order, as {hash uint64, start,
    end int64, rev bool} arrays; record i has offset i."""
    start, end, h = minimizers(seq, l, density, mode, width, xcodes)
    n = len(h) - k + 1
    if n <= 0:
        return _empty()
    m = mix(h, width)
    fwd = np.zeros(n, dtype=np.uint64)
    rev = np.zeros(n, dtype=np.uint64)
    for t in range(k):
        fwd ^= _rotl(m[t : t + n], k - 1 - t, 64)
        rev ^= _rotl(m[t : t + n], t, 64)
    return {
        "hash": np.minimum(fwd, rev),
        "start": start[:n].copy(),
        "end": end[k - 1 :].copy(),
        "rev": rev < fwd,
    }
