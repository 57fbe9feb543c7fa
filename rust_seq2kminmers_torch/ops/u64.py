"""Unsigned 32- and 64-bit helpers on int64 tensors.

PyTorch's uint32 and uint64 tensors lack shifts, compares and ``where``
on the CPU, so the plain versions hold a u32 zero-extended in int64 and a
u64 as an int64 bit pattern.  Left shifts wrap; right shifts of a u64 are
masked to be logical; unsigned compares flip the sign bit first.
"""

from __future__ import annotations

import numpy as np
import torch

I64_MIN = -(1 << 63)
MASK32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern (or any integer tensor) -> u32 zero-extended in int64."""
    return x.to(torch.int64) & MASK32


def i32_bits(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 tensor -> int32 tensor with that bit pattern
    (the value is brought into int32 range first, so the cast is exact)."""
    return (((x & MASK32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def rol32(x: torch.Tensor, r) -> torch.Tensor:
    """Rotate-left of u32 values (in int64) by amounts taken mod 32."""
    r = r & 31
    return ((x << r) | (x >> (32 - r))) & MASK32


def lsr64(x: torch.Tensor, s) -> torch.Tensor:
    """Logical right shift of u64 bit patterns by s in [0, 63]."""
    top = torch.full_like(x, I64_MIN) >> s  # ones in the top s+1 bits
    return (x >> s) & ~(top << 1)


def rol64(x: torch.Tensor, r) -> torch.Tensor:
    """Rotate-left of u64 bit patterns by amounts taken mod 64.  The right
    part is shifted in two steps so that no shift reaches 64."""
    r = r & 63
    return (x << r) | lsr64(lsr64(x, 63 - r), 1)


def ult64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b on u64 bit patterns."""
    return (a ^ I64_MIN) < (b ^ I64_MIN)


def mix64_from_u32(x: torch.Tensor) -> torch.Tensor:
    """Xorshift mix of a zero-extended u32 in u64 arithmetic
    (x ^= x << 13; x ^= x >> 7; x ^= x << 17).  From x < 2^32 every
    intermediate stays below 2^62, so no shift wraps."""
    x = x ^ (x << 13)
    x = x ^ (x >> 7)
    return x ^ (x << 17)


def i64_of_u64(v: int) -> int:
    """A Python u64 -> the int64 with the same bit pattern."""
    return v - (1 << 64) if v >= 1 << 63 else v


_MURMUR_C1 = i64_of_u64(0xFF51AFD7ED558CCD)
_MURMUR_C2 = i64_of_u64(0xC4CEB9FE1A85EC53)


def mix64_murmur_from_u16(x: torch.Tensor) -> torch.Tensor:
    """Murmur64-style mix of the low 16 bits of x, as u64 bit patterns:
    x ^= rol64(x, 33); x *= C1; x ^= rol64(x, 33); x *= C2;
    x ^= rol64(x, 33).  int64 multiplication wraps like u64's."""
    v = x.to(torch.int64) & 0xFFFF
    v = v ^ rol64(v, 33)
    v = v * _MURMUR_C1
    v = v ^ rol64(v, 33)
    v = v * _MURMUR_C2
    return v ^ rol64(v, 33)


def split_u64(x: torch.Tensor):
    """u64 bit patterns -> (hi, lo) int32 tensors holding the u32 halves."""
    return i32_bits(x >> 32), i32_bits(x)


def join_u64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) u32 bit patterns -> u64 bit patterns in int64."""
    return (hi.to(torch.int64) << 32) | u32(lo)


def to_py_u64(pair) -> np.ndarray:
    """Host side: (hi, lo) u32 bit patterns (tensors or arrays of any
    32-bit integer dtype) -> numpy uint64."""
    hi, lo = (
        np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p)
        .astype(np.int64) & MASK32
        for p in pair
    )
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
