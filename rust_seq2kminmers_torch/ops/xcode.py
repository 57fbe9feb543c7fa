"""Xcode encoding of raw sequence bytes on the device, in chunks: the
plain PyTorch version of ``csrc/xcode.cu`` (``ops/cuda/xcode.py``).

Row b of a chunk holds ``length_local[b]`` bytes of one read.  Each
becomes ``table[byte] | XCODE_KEEP`` where it differs from the byte before
it, else ``table[byte]``; past ``length_local[b]`` the row is XCODE_PAD.
The byte before column 0 is ``prev[b]``: the read's byte before the chunk,
or ``READ_START`` (-1) where the chunk starts the read, whose first byte
is always kept.  A row whose ``prev`` is ``XCODE_ROW`` (-2) already holds
xcodes and is copied, padded past its length, so one batch can mix raw
and encoded reads.  The tables are ``constants.code_table(family)``, so
the result equals ``constants.encode_xcodes`` of each read.
"""

from __future__ import annotations

import torch

from ..constants import XCODE_KEEP, XCODE_PAD, code_table

READ_START = -1
XCODE_ROW = -2


def encode_xcodes_plain(raw: torch.Tensor, prev: torch.Tensor, length_local: torch.Tensor,
                        family: str) -> torch.Tensor:
    """raw uint8[B, C], prev int32[B], length_local int32[B] -> uint8[B, C]
    xcodes, on the inputs' device."""
    B, C = raw.shape
    table = torch.from_numpy(code_table(family)).to(raw.device)
    x = raw.to(torch.int32)
    before = torch.cat([prev[:, None].to(torch.int32), x[:, :-1]], dim=1)[:, :C]
    enc = table[raw.long()] | torch.where(x != before, XCODE_KEEP, 0).to(torch.uint8)
    enc = torch.where((prev == XCODE_ROW)[:, None], raw, enc)
    inside = torch.arange(C, device=raw.device)[None, :] < length_local[:, None]
    return torch.where(inside, enc, torch.tensor(XCODE_PAD, dtype=torch.uint8, device=raw.device))
