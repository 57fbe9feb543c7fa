"""K2: slot compaction (``csrc/slot_compact.cu``) and its plain version.

Stitches K1's per-tile survivor rows ``[B, nt, cap]`` into the ordered
minimizer stream ``[B, m]`` of each read: tile t's first kept[b, t]
slots go to the offset that an exclusive scan of the kept counts gives.
At hash width 64 the hash is a (hi, lo) pair of columns, as K1 gives it.
"""

from __future__ import annotations

import ctypes

import torch

from ..compact import compact
from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 10 + [_I] * 4 + [_P]


def slot_compact(
    start: torch.Tensor,  # int32[B, nt, cap]
    end: torch.Tensor,
    hsh,  # int32[B, nt, cap], or its (hi, lo) pair at hash width 64
    kept: torch.Tensor,  # int32[B, nt] survivors per tile (<= cap)
    m: int,
):
    """-> ((start, end, hash) int32[B, m], n_slotted int32[B]), the hash a
    (hi, lo) pair when it came as one.

    Slots past min(n_slotted, m) are zero; n_slotted = sum of kept is not
    clipped, so n_slotted > m reveals survivors dropped at m.  CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    if start.ndim != 3:
        raise ValueError(f"start must be [B, nt, cap], got {tuple(start.shape)}")
    B, nt, cap = start.shape
    dev = start.device
    hi, lo = hsh if isinstance(hsh, tuple) else (None, hsh)
    cols = {"start": start, "end": end, "hash": lo}
    if hi is not None:
        cols["hash_hi"] = hi
    for name, t in cols.items():
        build.require(t, name, torch.int32, (B, nt, cap), dev)
    build.require(kept, "kept", torch.int32, (B, nt), dev)
    if m < 1:
        raise ValueError(f"m={m} must be positive")
    if dev.type == "cpu":
        return slot_compact_plain(start, end, hsh, kept, m)
    build.require_cuda(dev, kept=kept, **cols)
    outs = [torch.empty((B, m), dtype=torch.int32, device=dev) for _ in cols]
    n_slotted = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return _columns(outs, hi is not None), n_slotted
    # No hi column: its pointers are null and the kernel skips it.
    hi_ptrs = (build.ptr(hi), build.ptr(outs[3])) if hi is not None else (None, None)
    fn = build.function("s2k_slot_compact", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(
            *map(build.ptr, (start, end, lo)), hi_ptrs[0], build.ptr(kept),
            *map(build.ptr, outs[:3]), hi_ptrs[1], build.ptr(n_slotted),
            B, nt, cap, m, build.stream_of(dev),
        )
    build.launches["slot_compact"] += 1
    build.check(err, "s2k_slot_compact")
    return _columns(outs, hi is not None), n_slotted


def _columns(outs, has_hi: bool):
    """(start, end, hash), with the hash as (hi, lo) when has_hi."""
    return (outs[0], outs[1], (outs[3], outs[2]) if has_hi else outs[2])


def slot_compact_plain(start, end, hsh, kept, m):
    """The plain PyTorch version of the kernel, on any device."""
    B, nt, cap = start.shape
    hi, lo = hsh if isinstance(hsh, tuple) else (None, hsh)
    cols = [start, end, lo] + ([hi] if hi is not None else [])
    slot = torch.arange(cap, device=start.device)
    valid = (slot < kept.clamp(0, cap)[..., None]).view(B, nt * cap)
    outs, n = compact(
        valid, [c.reshape(B, nt * cap) for c in cols], m, [0] * len(cols)
    )
    return _columns(outs, hi is not None), n
