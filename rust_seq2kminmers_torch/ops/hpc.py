"""Homopolymer compression (HPC): keep mask and compaction.

The raw-byte run comparison is precomputed into xcode bit 3 by the host
encoder (``constants.encode_xcodes``), so the device only reads it: a base
is kept when it starts a run and lies inside its read.  The kept bases are
left-packed with their original positions (start-of-run convention).
"""

from __future__ import annotations

import torch

from ..constants import CODE_PAD, XCODE_KEEP
from .compact import compact


def with_keep_bits_device(codes: torch.Tensor) -> torch.Tensor:
    """Stamp xcode keep bits onto plain 3-bit codes [..., L] on their own
    device, treating code equality as byte equality (synthetic inputs)."""
    low = codes & 7
    keep = low != torch.roll(low, 1, dims=-1)
    keep[..., 0] = True
    return low | torch.where(keep, XCODE_KEEP, 0).to(codes.dtype)


def hpc_keep_mask(codes: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """bool[B, L]: the xcode keep bit is set and the position is inside the
    read (j < length)."""
    j = torch.arange(codes.shape[-1], device=codes.device)
    return ((codes & XCODE_KEEP) != 0) & (j[None, :] < lengths[:, None])


def hpc_compress_packed(codes, lengths):
    """HPC compaction as ONE int32 column (pos << 3) | code, m = L.
    -> (packed int32[B, L], filled with (L << 3) | CODE_PAD past the
    count, hpc_len int32[B]).  The plain version of K4's HPC form,
    ``ops/cuda/masked_compact.py:hpc_compact``."""
    B, L = codes.shape
    if L >= 1 << 28:
        raise ValueError("padded length must be < 2^28 for packed streams")
    j = torch.arange(L, dtype=torch.int32, device=codes.device)
    packed = (j[None, :] << 3) | (codes & 7).to(torch.int32)
    (pk,), count = compact(
        hpc_keep_mask(codes, lengths), [packed], L, [(L << 3) | CODE_PAD]
    )
    return pk, count

