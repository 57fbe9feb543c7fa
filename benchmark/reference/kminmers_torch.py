"""Plain PyTorch k-min-mers of the scalar modes at hash widths 32 and 64:
the reference that judges the cells whose minimizer hashes are 64-bit.

Written from the definitions of rust-seq2kminmers (Ekim, Berger and
Chikhi's k-min-mer sketch), for modes ``regular`` and ``hpc``.  It uses
plain ``torch`` integer operations on whatever device its input is on and
imports nothing of the measured program, of jax or of the JAX package.
The crate's rolling updates are replaced by their definitions, one XOR a
position of each window; the results are the same.  Rows are computed in
blocks of ``block_rows`` so that a sample of [rows, 2^20] bases fits.

The steps, for each row of codes and its length n:

1. Each byte maps to a 3-bit code by the scalar table (uppercase ACGT
   0-3, N 4, every other byte, lowercase included, 5) or, for xcodes,
   is ``(keep << 3) | code``.  A read with n <= l has no record.
2. ``hpc`` keeps the first byte of every run of equal raw bytes (for
   xcodes, the byte whose keep bit is set, and always the first);
   positions stay those of the original sequence.
3. Every window of l kept codes gets the canonical NtHash1 at width w:
   the forward hash XORs each base's seed rotated left by its distance
   from the window's end, the reverse hash XORs the complement's seed
   rotated by its distance from the start; the canonical hash is the
   smaller.  Seeds are the low w bits of NtHash's 64-bit seeds; N's is 0
   and every other non-base's is 1, forward and reverse.
4. A window is a minimizer when its hash is ``<=`` trunc(d * (2^w - 1)),
   computed in f64 and clamped.  ``hpc`` never emits its last window.
5. Minimizer hashes mix to 64 bits (width 32: xorshift 13, 7, 17 on the
   zero-extended value; width 64: identity), and every k consecutive
   minimizers give one k-min-mer: the canonical rotate-XOR hash at width
   64 over the mixed hashes, ``rev`` when the reverse hash is the smaller.
6. A record's start is its first minimizer's start and its end is its
   last minimizer's end: position i + l - 1 (``regular``) or the last
   byte of kept run i + l - 1 (``hpc``).

u64 values are held as int64 bit patterns: left shifts wrap, right
shifts are masked to be logical and unsigned compares flip the sign bit
first, since torch on the CPU has no shifts or compares on uint64.

Departures from the crate: none in the records.  The SIMD modes, width
16 and nthash2 are left out (``benchmark/reference/kminmers.py`` has the
first two); the crate disables nthash2.
"""

from __future__ import annotations

from typing import Dict, List

import torch

MODES = ("regular", "hpc")
WIDTHS = (32, 64)

# NtHash's 64-bit seeds of A, C, G and T, codes 0-3; a code's complement
# is 3 - code.
_SEED64 = (0x3C8BFBB395C60474, 0x3193C18562A02B4C, 0x20323ED082572324, 0x295549F54BE24456)
_OTHER = 5  # every byte but ACGTN (0-4)
_XCODE_KEEP = 8
_I64_MIN = -(1 << 63)


def _as_i64(v: int) -> int:
    """A value in [0, 2^64) -> the int64 of the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _rotl(v: int, r: int, width: int) -> int:
    r %= width
    mask = (1 << width) - 1
    return ((v << r) | (v >> (width - r))) & mask if r else v & mask


def _seed_table(width: int, reverse: bool, rot: int, device) -> torch.Tensor:
    """int64[8]: each code's seed (reverse: its complement's) rotated left
    by ``rot`` at ``width``, as bit patterns."""
    mask = (1 << width) - 1
    seeds = [_SEED64[3 - c if reverse else c] & mask for c in range(4)] + [0, 1, 0, 0]
    return torch.tensor([_as_i64(_rotl(s, rot, width)) for s in seeds], dtype=torch.int64,
                        device=device)


def _scalar_table(device) -> torch.Tensor:
    table = torch.full((256,), _OTHER, dtype=torch.int64)
    for code, base in enumerate(b"ACGTN"):
        table[base] = code
    return table.to(device)


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u64 bit patterns by s in [1, 63]."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _rol64(x: torch.Tensor, r: int) -> torch.Tensor:
    r %= 64
    return x if r == 0 else (x << r) | _lsr(x, 64 - r)


def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b of u64 bit patterns."""
    return (a ^ _I64_MIN) < (b ^ _I64_MIN)


def _umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(_ult(b, a), b, a)


def bound(density: float, width: int) -> int:
    """The density bound trunc(d * (2^w - 1)) in f64, clamped to [0, 2^w - 1]."""
    hmax = (1 << width) - 1
    return min(hmax, max(0, int(float(density) * float(hmax))))


def mix(h: torch.Tensor, width: int) -> torch.Tensor:
    """Minimizer hashes of ``width`` bits mixed to 64 (bit patterns).  At
    width 32 every intermediate stays below 2^62, so no shift wraps."""
    if width == 64:
        return h
    h = h ^ (h << 13)
    h = h ^ (h >> 7)
    return h ^ (h << 17)


def _pack_left(mask: torch.Tensor) -> torch.Tensor:
    """int64[R, C]: each row's columns where ``mask`` holds first, in
    order, then the rest."""
    return torch.sort((~mask).to(torch.uint8), dim=1, stable=True).indices


def _window_hashes(codes: torch.Tensor, l: int, width: int) -> torch.Tensor:
    """Canonical NtHash1 of every window of l codes along dim 1."""
    nw = codes.shape[1] - l + 1
    fwd = torch.zeros((codes.shape[0], nw), dtype=torch.int64, device=codes.device)
    rev = torch.zeros_like(fwd)
    for t in range(l):
        window = codes[:, t : t + nw]
        fwd ^= _seed_table(width, False, l - 1 - t, codes.device)[window]
        rev ^= _seed_table(width, True, t, codes.device)[window]
    return _umin(fwd, rev)


def _block(seq: torch.Tensor, lengths: torch.Tensor, l: int, k: int, density: float,
           mode: str, width: int, xcodes: bool) -> List[Dict[str, torch.Tensor]]:
    R, L = seq.shape
    dev = seq.device
    if L - l + 1 < k:  # no row holds k windows
        none = torch.zeros(0, dtype=torch.int64, device=dev)
        return [{"hash": none, "start": none, "end": none, "rev": none.bool()}
                for _ in range(R)]
    x = seq.to(torch.int64)
    codes = x & 7 if xcodes else _scalar_table(dev)[x]
    keep = torch.ones((R, L), dtype=torch.bool, device=dev)
    if mode == "hpc" and xcodes:
        keep[:, 1:] = (x[:, 1:] & _XCODE_KEEP) != 0
    elif mode == "hpc":
        keep[:, 1:] = x[:, 1:] != x[:, :-1]
    keep &= torch.arange(L, device=dev)[None, :] < lengths[:, None]
    pos = _pack_left(keep)
    n_kept = keep.sum(1)
    h = _window_hashes(codes.gather(1, pos), l, width)
    n_win = n_kept - l + (0 if mode == "hpc" else 1)
    n_win = torch.where(lengths > l, n_win, torch.zeros_like(n_win))
    w = torch.arange(h.shape[1], device=dev)
    bits = _as_i64(bound(density, width))
    sel = (w[None, :] < n_win[:, None]) & ((h ^ _I64_MIN) <= (bits ^ _I64_MIN))
    order = _pack_left(sel)
    n_sel = sel.sum(1)
    start = pos.gather(1, order)
    if mode == "hpc":
        end = pos.gather(1, (order + l).clamp(max=L - 1)) - 1
    else:
        end = start + (l - 1)
    m = mix(h.gather(1, order), width)
    nk = m.shape[1] - k + 1
    fwd = torch.zeros((R, nk), dtype=torch.int64, device=dev)
    rev = torch.zeros_like(fwd)
    for t in range(k):
        fwd ^= _rol64(m[:, t : t + nk], k - 1 - t)
        rev ^= _rol64(m[:, t : t + nk], t)
    kh, kr = _umin(fwd, rev), _ult(rev, fwd)
    out = []
    for r, n in enumerate((n_sel - k + 1).clamp(min=0).tolist()):
        out.append({"hash": kh[r, :n], "start": start[r, :n],
                    "end": end[r, k - 1 : k - 1 + n], "rev": kr[r, :n]})
    return out


def kminmers_rows(seq: torch.Tensor, lengths: torch.Tensor, l: int, k: int, density: float,
                  mode: str, width: int, xcodes: bool = False,
                  block_rows: int = 8) -> List[Dict[str, torch.Tensor]]:
    """All k-min-mers of each row of ``seq`` (uint8[R, L], the first
    ``lengths[r]`` bytes of row r; raw bytes, or with ``xcodes`` the
    program's xcodes), in order -> one {hash (int64 bit patterns of the
    u64), start, end (int64), rev (bool)} a row, on ``seq``'s device;
    record i has offset i.  Turns TF32 off, as every plain reference on
    the card does, though nothing here multiplies floats."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: this reference computes {MODES}")
    if width not in WIDTHS:
        raise ValueError(f"hash width {width}: this reference computes {WIDTHS}")
    if l < 1 or k < 1:
        raise ValueError("l and k must be >= 1")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lengths = lengths.to(device=seq.device, dtype=torch.int64)
    out = []
    for b in range(0, seq.shape[0], block_rows):
        out += _block(seq[b : b + block_rows], lengths[b : b + block_rows], l, k, density,
                      mode, width, xcodes)
    return out
