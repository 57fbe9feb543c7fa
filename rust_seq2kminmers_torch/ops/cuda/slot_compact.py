"""K2: slot compaction (``csrc/slot_compact.cu``) and its plain version.

Stitches K1's per-tile survivor rows ``[B, nt, cap]`` into the ordered
minimizer stream ``[B, m]`` of each read: tile t's first kept[b, t]
slots go to the offset that an exclusive scan of the kept counts gives.
"""

from __future__ import annotations

import ctypes

import torch

from ..compact import compact
from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 4 + [_P]


def slot_compact(
    start: torch.Tensor,  # int32[B, nt, cap]
    end: torch.Tensor,
    hsh: torch.Tensor,
    kept: torch.Tensor,  # int32[B, nt] survivors per tile (<= cap)
    m: int,
):
    """-> ((start, end, hash) int32[B, m], n_slotted int32[B]).

    Slots past min(n_slotted, m) are zero; n_slotted = sum of kept is not
    clipped, so n_slotted > m reveals survivors dropped at m.  CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    if start.ndim != 3:
        raise ValueError(f"start must be [B, nt, cap], got {tuple(start.shape)}")
    B, nt, cap = start.shape
    dev = start.device
    for name, t in (("start", start), ("end", end), ("hash", hsh)):
        build.require(t, name, torch.int32, (B, nt, cap), dev)
    build.require(kept, "kept", torch.int32, (B, nt), dev)
    if m < 1:
        raise ValueError(f"m={m} must be positive")
    if dev.type == "cpu":
        return slot_compact_plain(start, end, hsh, kept, m)
    build.require_cuda(dev, start=start, end=end, hash=hsh, kept=kept)
    outs = tuple(
        torch.empty((B, m), dtype=torch.int32, device=dev) for _ in range(3)
    )
    n_slotted = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return outs, n_slotted
    fn = build.function("s2k_slot_compact", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(
            *map(build.ptr, (start, end, hsh, kept, *outs, n_slotted)),
            B, nt, cap, m, build.stream_of(dev),
        )
    build.launches["slot_compact"] += 1
    build.check(err, "s2k_slot_compact")
    return outs, n_slotted


def slot_compact_plain(start, end, hsh, kept, m):
    """The plain PyTorch version of the kernel, on any device."""
    B, nt, cap = start.shape
    slot = torch.arange(cap, device=start.device)
    valid = (slot < kept.clamp(0, cap)[..., None]).view(B, nt * cap)
    cols, n = compact(
        valid, [c.reshape(B, nt * cap) for c in (start, end, hsh)], m, [0, 0, 0]
    )
    return tuple(cols), n
