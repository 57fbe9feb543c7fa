"""Homopolymer compression (HPC) keep mask.

The raw-byte run comparison is precomputed into xcode bit 3 by the host
encoder (``constants.encode_xcodes``), so the device only reads it: a base
is kept when it starts a run and lies inside its read.
"""

from __future__ import annotations

import torch

from ..constants import XCODE_KEEP


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
