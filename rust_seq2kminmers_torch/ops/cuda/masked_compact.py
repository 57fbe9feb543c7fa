"""K4: ordered masked compaction (``csrc/masked_compact.cu``).  Its plain
version is ``ops/compact.py:compact``.

Per row, the elements of each column where the mask is set are left-packed,
in order, into m slots; slots past the selected count hold the column's
fill; elements past m are dropped, and the returned count is unclipped, so
count > m reveals the loss.
"""

from __future__ import annotations

import ctypes

import torch

from ..compact import compact
from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] + [_P] * 3 + [_I] * 3 + [_P]
MAX_COLS = 4


def masked_compact(mask: torch.Tensor, cols, m: int, fills):
    """mask bool[B, N]; cols: 1 to 4 int32 or uint8 tensors [B, N]; fills:
    one int per column -> (list of [B, m] tensors in the columns' dtypes,
    count int32[B]).  CPU tensors take the plain version; CUDA tensors
    launch the kernel (uint8 columns are widened to int32 around it)."""
    if mask.ndim != 2:
        raise ValueError(f"mask must be [B, N], got {tuple(mask.shape)}")
    B, N = mask.shape
    dev = mask.device
    build.require(mask, "mask", torch.bool, (B, N), dev)
    if not 1 <= len(cols) <= MAX_COLS or len(fills) != len(cols):
        raise ValueError(f"need 1 to {MAX_COLS} columns, one fill each")
    for i, c in enumerate(cols):
        dt = c.dtype if c.dtype in (torch.int32, torch.uint8) else torch.int32
        build.require(c, f"cols[{i}]", dt, (B, N), dev)
    if m < 1:
        raise ValueError(f"m={m} must be positive")
    if dev.type == "cpu":
        return compact(mask, cols, m, fills)
    build.require_cuda(dev, mask=mask, **{f"cols[{i}]": c for i, c in enumerate(cols)})
    wide = [c.to(torch.int32) for c in cols]
    outs = [torch.empty((B, m), dtype=torch.int32, device=dev) for _ in cols]
    count = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return [o.to(c.dtype) for o, c in zip(outs, cols)], count
    tile = build.function("s2k_masked_compact_tile", [])()
    nt = -(-max(N, 1) // tile)
    tile_count, tile_off = (
        torch.empty((B, nt), dtype=torch.int32, device=dev) for _ in range(2)
    )
    ins = (_P * MAX_COLS)(*(c.data_ptr() for c in wide))
    outp = (_P * MAX_COLS)(*(o.data_ptr() for o in outs))
    fill_arr = (_I * MAX_COLS)(*fills)
    fn = build.function("s2k_masked_compact", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(
            build.ptr(mask.view(torch.uint8)),
            ctypes.cast(ins, _P), ctypes.cast(outp, _P), ctypes.cast(fill_arr, _P),
            len(cols), *map(build.ptr, (tile_count, tile_off, count)),
            B, N, m, build.stream_of(dev),
        )
    build.launches["masked_compact"] += 1
    build.check(err, "s2k_masked_compact")
    return [o.to(c.dtype) for o, c in zip(outs, cols)], count
