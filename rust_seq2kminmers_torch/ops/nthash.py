"""Sliding canonical NtHash1-32 over a batch of code rows.

The window hash is an XOR of position-rotated seeds:

    fh(i) = rol32(XOR_{j<l} rol32(F[c_{i+j}], -(i+j)), l-1+i)
    rh(i) = rol32(XOR_{j<l} rol32(R[c_{i+j}],  i+j),  -i)

so one pre-rotated term per position and a sliding XOR give every window.
Values are u32 zero-extended in int64 (see ``ops/u64.py``).
"""

from __future__ import annotations

import torch

from ..constants import SEED_TABLE_F, SEED_TABLE_R
from .u64 import rol32


def seed_lookup(table, codes: torch.Tensor) -> torch.Tensor:
    """Seed per 3-bit code, as int64, by a plain index into the table."""
    t = torch.as_tensor(table.astype("int64"), device=codes.device)
    return t[codes.to(torch.int64) & 7]


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


def sliding_nthash32(codes: torch.Tensor, l: int):
    """codes [..., L] -> (fh, rh) u32-in-int64 [..., L-l+1]; window i covers
    codes[..., i:i+l], and position j rotates by j, so a row must start at
    rank 0 of its stream."""
    L = codes.shape[-1]
    if L < l:
        raise ValueError(f"padded length {L} < l={l}")
    j = torch.arange(L, device=codes.device)
    a = rol32(seed_lookup(SEED_TABLE_F, codes), -j)
    b = rol32(seed_lookup(SEED_TABLE_R, codes), j)
    nwin = L - l + 1
    i = torch.arange(nwin, device=codes.device)
    fh = rol32(sliding_window_xor(a, l)[..., :nwin], l - 1 + i)
    rh = rol32(sliding_window_xor(b, l)[..., :nwin], -i)
    return fh, rh
