"""K2: slot compaction (``csrc/slot_compact.cu``) and its plain version.

Stitches K1's per-tile survivor rows ``[B, nt, cap]`` into the ordered
minimizer stream ``[B, m]`` of each read: tile t's first kept[b, t]
slots go to the offset that an exclusive scan of the kept counts gives.
At hash width 64 the hash is a (hi, lo) pair of columns, as K1 gives it.

Two forms share the kernel: ``slot_compact`` takes the kept counts
``[B, nt]`` and returns the unclipped n_slotted; ``slot_compact_counts``
takes K1's ``counts [B, nt, 3]`` as they are and returns the pipeline's
n_min = min(n_slotted, m) and n_raw = the sum of the raw counts.
"""

from __future__ import annotations

import ctypes

import torch

from ..compact import compact
from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] + [_P] * 8 + [_I] * 5 + [_P]


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
    B, nt, _ = _require_rows(start, end, hsh, m)
    build.require(kept, "kept", torch.int32, (B, nt), start.device)
    if start.device.type == "cpu":
        return slot_compact_plain(start, end, hsh, kept, m)
    n_slotted = torch.empty((B,), dtype=torch.int32, device=start.device)
    cols = _launch(start, end, hsh, kept, None, 1, m, True, n_slotted, None, None)
    return cols, n_slotted


def slot_compact_counts(
    start: torch.Tensor,  # int32[B, nt, cap]
    end: torch.Tensor,
    hsh,  # int32[B, nt, cap], or its (hi, lo) pair at hash width 64
    counts: torch.Tensor,  # int32[B, nt, 3]: K1's (kept, raw, stream) per tile
    m: int,
    fill: bool = True,
    n_min: torch.Tensor | None = None,  # int32[B] to write n_min into
    n_raw: torch.Tensor | None = None,  # int32[B] to write n_raw into
):
    """-> ((start, end, hash) int32[B, m], n_min int32[B], n_raw int32[B]):
    the compaction of ``slot_compact`` from K1's counts, read in place,
    with n_min = min(sum of kept, m) and n_raw = sum of raw.  With
    ``fill`` False the slots past n_min are left undefined (the kernel
    does not write them).  ``n_min`` and ``n_raw``, when given, are
    written and returned.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    B, nt, _ = _require_rows(start, end, hsh, m)
    dev = start.device
    build.require(counts, "counts", torch.int32, (B, nt, 3), dev)
    for name, t in (("n_min", n_min), ("n_raw", n_raw)):
        if t is not None:
            build.require(t, name, torch.int32, (B,), dev)
    if dev.type == "cpu":
        return slot_compact_counts_plain(start, end, hsh, counts, m, fill, n_min, n_raw)
    build.require_cuda(dev, n_min=n_min, n_raw=n_raw)
    n_min, n_raw = (
        torch.empty((B,), dtype=torch.int32, device=dev) if t is None else t
        for t in (n_min, n_raw)
    )
    # kept and raw are columns 0 and 1 of counts, read at stride 3.
    cols = _launch(start, end, hsh, counts, counts[:, :, 1:], 3, m, fill, None,
                   n_min, n_raw)
    return cols, n_min, n_raw


def _require_rows(start, end, hsh, m):
    """Check the survivor rows and m; -> (B, nt, cap)."""
    if start.ndim != 3:
        raise ValueError(f"start must be [B, nt, cap], got {tuple(start.shape)}")
    hi, lo = hsh if isinstance(hsh, tuple) else (None, hsh)
    for name, t in (("start", start), ("end", end), ("hash", lo), ("hash_hi", hi)):
        if t is not None:
            build.require(t, name, torch.int32, start.shape, start.device)
    if m < 1:
        raise ValueError(f"m={m} must be positive")
    return start.shape


def _launch(start, end, hsh, kept, raw, stride, m, fill, n_slotted, n_min, n_raw):
    """One call of the kernel's two launches; -> the output columns."""
    B, nt, cap = start.shape
    dev = start.device
    hi, lo = hsh if isinstance(hsh, tuple) else (None, hsh)
    build.require_cuda(dev, start=start, end=end, hash=lo, hash_hi=hi, kept=kept)
    outs = [torch.empty((B, m), dtype=torch.int32, device=dev)
            for _ in range(3 if hi is None else 4)]
    if B == 0:
        return _columns(outs, hi is not None)
    offsets = torch.empty((B, nt + 1), dtype=torch.int32, device=dev)
    # Absent outputs and the absent hi column are null pointers.
    opt = [None if t is None else build.ptr(t)
           for t in (hi, raw, outs[3] if hi is not None else None, n_slotted, n_min, n_raw)]
    fn = build.function("s2k_slot_compact", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(
            *map(build.ptr, (start, end, lo)), opt[0], build.ptr(kept), opt[1], stride,
            *map(build.ptr, outs[:3]), opt[2], build.ptr(offsets), *opt[3:],
            B, nt, cap, m, int(fill), build.stream_of(dev),
        )
    build.launches["slot_compact"] += 1
    build.check(err, "s2k_slot_compact")
    return _columns(outs, hi is not None)


def _columns(outs, has_hi: bool):
    """(start, end, hash), with the hash as (hi, lo) when has_hi."""
    return (outs[0], outs[1], (outs[3], outs[2]) if has_hi else outs[2])


def slot_compact_plain(start, end, hsh, kept, m):
    """The plain PyTorch version of ``slot_compact``, on any device."""
    B, nt, cap = start.shape
    hi, lo = hsh if isinstance(hsh, tuple) else (None, hsh)
    cols = [start, end, lo] + ([hi] if hi is not None else [])
    slot = torch.arange(cap, device=start.device)
    valid = (slot < kept.clamp(0, cap)[..., None]).view(B, nt * cap)
    outs, n = compact(
        valid, [c.reshape(B, nt * cap) for c in cols], m, [0] * len(cols)
    )
    return _columns(outs, hi is not None), n


def slot_compact_counts_plain(start, end, hsh, counts, m, fill=True, n_min=None,
                              n_raw=None):
    """The plain PyTorch version of ``slot_compact_counts``, on any device.
    It always fills: zeros are one value of the slots that ``fill=False``
    leaves undefined."""
    cols, n_slotted = slot_compact_plain(start, end, hsh, counts[:, :, 0], m)
    got = (torch.clamp(n_slotted, max=m), counts[:, :, 1].sum(dim=1, dtype=torch.int32))
    n_min, n_raw = (v if out is None else out.copy_(v)
                    for out, v in zip((n_min, n_raw), got))
    return cols, n_min, n_raw
