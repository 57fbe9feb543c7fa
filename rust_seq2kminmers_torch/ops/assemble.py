"""K-min-mer assembly: canonical NtHash in minimizer space over the
compacted minimizer stream, with 64-bit rotates:

    f(w) = rol64(XOR_{q<k} rol64(m_{w+q}, -(w+q)), k-1+w)
    r(w) = rol64(XOR_{q<k} rol64(m_{w+q},   w+q),  -w)
    hash = min(f, r),  rev = r < f

where m_j is the xorshift-mixed u32 minimizer hash.  This is the plain
version of the assembly kernel (``ops/cuda/assemble_kernel.py``).
"""

from __future__ import annotations

import torch

from .nthash import sliding_window_xor
from .u64 import mix64_from_u32, rol64, split_u64, u32, ult64


def assemble_kminmers(min_hash: torch.Tensor, k: int):
    """min_hash: u32 bit patterns [B, M] -> ((hash_hi, hash_lo) int32
    bit patterns [B, M-k+1], rev bool [B, M-k+1]).

    Windows past a row's count - k + 1 read stream padding; callers mask.
    """
    M = min_hash.shape[-1]
    if M < k:
        raise ValueError(f"minimizer capacity {M} < k={k}")
    m = mix64_from_u32(u32(min_hash))
    j = torch.arange(M, device=min_hash.device)
    nwin = M - k + 1
    w = j[:nwin]
    f = rol64(sliding_window_xor(rol64(m, -j), k)[..., :nwin], k - 1 + w)
    r = rol64(sliding_window_xor(rol64(m, j), k)[..., :nwin], -w)
    rev = ult64(r, f)
    return split_u64(torch.where(rev, r, f)), rev
