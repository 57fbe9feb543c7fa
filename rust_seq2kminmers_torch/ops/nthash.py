"""Sliding canonical NtHash over a batch of code rows, at hash widths 16,
32 and 64 (NtHash1) and 31 (the NtHash2-hybrid variant).

The window hash is an XOR of position-rotated seeds; at width W,

    fh(i) = rolW(XOR_{j<l} rolW(F[c_{i+j}], -(i+j)), l-1+i)
    rh(i) = rolW(XOR_{j<l} rolW(R[c_{i+j}],  i+j),  -i)

with every rotate amount taken mod W, so one pre-rotated term per
position and a sliding XOR give every window.  Values are held in int64:
widths up to 32 zero-extended, width 64 as bit patterns (see
``ops/u64.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import SEED_TABLE_F, SEED_TABLE_R, seed_tables, seed_tables_nthash2_31
from .u64 import i64_of_u64, rol32, rol64, ult64


def seed_lookup(table, codes: torch.Tensor) -> torch.Tensor:
    """Seed per 3-bit code, as int64 (u64 seeds as bit patterns), by a
    plain index into the table; code 7, which no encoder makes, has seed
    0, as in the reference's select tree and the kernels' tables."""
    table = np.asarray(table)
    t = np.zeros(8, dtype=np.int64)
    t[: len(table)] = table.view(np.int64) if table.dtype == np.uint64 else table
    return _table_on(t.tobytes(), codes.device)[codes.to(torch.int64) & 7]


@functools.lru_cache(maxsize=None)
def _table_on(data: bytes, device: torch.device) -> torch.Tensor:
    """The int64 table on the device, copied there once: a copy from host
    memory cannot be captured into a CUDA graph, a read of this can."""
    return torch.tensor(np.frombuffer(data, dtype=np.int64), device=device)


def _shift_left(x: torch.Tensor, s: int) -> torch.Tensor:
    """y[..., i] = x[..., i + s], zero-filled at the end."""
    if s == 0:
        return x
    y = torch.zeros_like(x)
    y[..., : x.shape[-1] - s] = x[..., s:]
    return y


def sliding_window_xor(x: torch.Tensor, l: int) -> torch.Tensor:
    """W[..., i] = x[..., i] ^ ... ^ x[..., i+l-1] by log-doubling over the
    binary digits of l.  Entries past L-l+1 mix in zeros; callers mask."""
    acc = None
    acc_len = 0
    w = x  # XOR of m consecutive terms, m = 1, 2, 4, ...
    m = 1
    rem = l
    while rem:
        if rem & 1:
            term = _shift_left(w, acc_len)
            acc = term if acc is None else acc ^ term
            acc_len += m
        rem >>= 1
        if rem:
            w = w ^ _shift_left(w, m)
            m <<= 1
    return acc


def _rol16(x: torch.Tensor, r) -> torch.Tensor:
    """Rotate-left of values below 2^16 by amounts taken mod 16."""
    r = r & 15
    return ((x << r) | (x >> (16 - r))) & 0xFFFF


def _rol31(x: torch.Tensor, r) -> torch.Tensor:
    """Rotate-left of values below 2^31 by amounts taken mod 31 (a floor
    mod, so negative amounts rotate right)."""
    r = r % 31
    return ((x << r) | (x >> (31 - r))) & 0x7FFFFFFF


def _sliding_nthash(codes: torch.Tensor, l: int, tables, rol):
    L = codes.shape[-1]
    if L < l:
        raise ValueError(f"padded length {L} < l={l}")
    j = torch.arange(L, device=codes.device)
    a = rol(seed_lookup(tables[0], codes), -j)
    b = rol(seed_lookup(tables[1], codes), j)
    nwin = L - l + 1
    i = torch.arange(nwin, device=codes.device)
    fh = rol(sliding_window_xor(a, l)[..., :nwin], l - 1 + i)
    rh = rol(sliding_window_xor(b, l)[..., :nwin], -i)
    return fh, rh


def sliding_nthash32(codes: torch.Tensor, l: int):
    """codes [..., L] -> (fh, rh) u32-in-int64 [..., L-l+1]; window i covers
    codes[..., i:i+l], and position j rotates by j, so a row must start at
    rank 0 of its stream."""
    return _sliding_nthash(codes, l, (SEED_TABLE_F, SEED_TABLE_R), rol32)


def sliding_nthash16(codes: torch.Tensor, l: int):
    """NtHash1 at width 16: the low 16 bits of the seeds, rotates mod 16."""
    return _sliding_nthash(codes, l, seed_tables(16), _rol16)


def sliding_nthash2_31(codes: torch.Tensor, l: int):
    """The NtHash2-hybrid 31-bit variant: the top 31 bits of the seeds,
    rotates mod 31 (non-degenerate for l > 31)."""
    return _sliding_nthash(codes, l, seed_tables_nthash2_31(), _rol31)


def sliding_nthash64(codes: torch.Tensor, l: int):
    """NtHash1 at width 64: (fh, rh) as u64 bit patterns in int64."""
    return _sliding_nthash(codes, l, seed_tables(64), rol64)


def canonical_nthash(codes: torch.Tensor, l: int, hash_width=32, variant="nthash1"):
    """min(fh, rh) per window at a hash width (31 bits for nthash2); at
    width 64 the unsigned min of u64 bit patterns."""
    if variant == "nthash2":
        fh, rh = sliding_nthash2_31(codes, l)
    elif hash_width == 64:
        fh, rh = sliding_nthash64(codes, l)
        return torch.where(ult64(rh, fh), rh, fh)
    elif hash_width == 16:
        fh, rh = sliding_nthash16(codes, l)
    else:
        fh, rh = sliding_nthash32(codes, l)
    return torch.minimum(fh, rh)


def below_bound(h: torch.Tensor, bound: int, strict: bool, hash_width=32):
    """The density select: h < bound (strict) or h <= bound, unsigned at
    every width."""
    if hash_width == 64:
        b = i64_of_u64(bound)
        return ult64(h, b) if strict else ~ult64(b, h)
    return (h < bound) if strict else (h <= bound)
