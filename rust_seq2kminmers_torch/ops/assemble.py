"""K-min-mer assembly: canonical NtHash in minimizer space over the
compacted minimizer stream, with 64-bit rotates:

    f(w) = rol64(XOR_{q<k} rol64(m_{w+q}, -(w+q)), k-1+w)
    r(w) = rol64(XOR_{q<k} rol64(m_{w+q},   w+q),  -w)
    hash = min(f, r),  rev = r < f

where m_j is the minimizer hash mixed to u64 per hash width: xorshift of
a u32, murmur of a u16, identity of a u64.  This is the plain version of
the assembly kernel (``ops/cuda/assemble_kernel.py``).
"""

from __future__ import annotations

import torch

from .nthash import sliding_window_xor
from .u64 import (
    join_u64,
    mix64_from_u32,
    mix64_murmur_from_u16,
    rol64,
    split_u64,
    u32,
    ult64,
)


def assemble_kminmers(min_hash: torch.Tensor, k: int):
    """min_hash: u32 bit patterns [B, M] -> ((hash_hi, hash_lo) int32
    bit patterns [B, M-k+1], rev bool [B, M-k+1]).

    Windows past a row's count - k + 1 read stream padding; callers mask.
    """
    return assemble_kminmers_mixed(mix64_from_u32(u32(min_hash)), k)


def assemble_kminmers_mixed(mixed: torch.Tensor, k: int):
    """The same assembly over minimizer hashes already mixed to u64 (bit
    patterns in int64, [B, M])."""
    M = mixed.shape[-1]
    if M < k:
        raise ValueError(f"minimizer capacity {M} < k={k}")
    j = torch.arange(M, device=mixed.device)
    nwin = M - k + 1
    w = j[:nwin]
    f = rol64(sliding_window_xor(rol64(mixed, -j), k)[..., :nwin], k - 1 + w)
    r = rol64(sliding_window_xor(rol64(mixed, j), k)[..., :nwin], -w)
    rev = ult64(r, f)
    return split_u64(torch.where(rev, r, f)), rev


def assemble_plain(min_hash, k: int, hash_width: int = 32, min_hash_hi=None):
    """The assembly at a hash width: u32 bit patterns ``min_hash`` (and, at
    width 64, the high words ``min_hash_hi``) mixed to u64, then
    assembled."""
    if hash_width == 32:
        return assemble_kminmers(min_hash, k)
    if hash_width == 16:
        return assemble_kminmers_mixed(mix64_murmur_from_u16(min_hash), k)
    return assemble_kminmers_mixed(join_u64(min_hash_hi, min_hash), k)


def assemble_masked_plain(
    min_hash, k: int, hash_width: int, min_hash_hi, n_min, min_start, min_end
):
    """The assembly masked to each row's count -> (hash_hi, hash_lo, start,
    end, rev, n_kminmers), the k-min-mer fields of ``KminmerBatch``: window
    w < n_kminmers = max(n_min - (k-1), 0) keeps its hash and rev, with
    start = min_start[w] and end = min_end[w + k - 1]; later windows are
    zero (false).  The plain version of ``assemble_masked_cuda``."""
    (kh_hi, kh_lo), rev = assemble_plain(min_hash, k, hash_width, min_hash_hi)
    mk = min_hash.shape[1] - k + 1
    n_km = torch.clamp(n_min - (k - 1), min=0)
    valid = torch.arange(mk, device=min_hash.device)[None, :] < n_km[:, None]
    return (
        torch.where(valid, kh_hi, 0),
        torch.where(valid, kh_lo, 0),
        torch.where(valid, min_start[:, :mk], 0),
        torch.where(valid, min_end[:, k - 1 :], 0),
        valid & rev,
        n_km,
    )
