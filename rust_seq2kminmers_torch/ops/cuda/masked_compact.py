"""K4: ordered masked compaction (``csrc/masked_compact.cu``), in two forms.

``masked_compact``: per row, the elements of each column where the mask is
set are left-packed, in order, into m slots; slots past the selected count
hold the column's fill; elements past m are dropped, and the returned count
is unclipped, so count > m reveals the loss.  Its plain version is
``ops/compact.py:compact``.

``hpc_compact``: the general path's HPC compaction, read straight from the
xcodes: the packed column (pos << 3) | code of the kept bases, m = L.  Its
plain version is ``ops/hpc.py:hpc_compress_packed``.
"""

from __future__ import annotations

import ctypes

import torch

from ..compact import compact
from ..hpc import hpc_compress_packed
from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 5 + [_I] + [_P] * 3 + [_I] * 3 + [_P]
_HPC_ARGTYPES = [_P] * 6 + [_I] * 2 + [_P]
MAX_COLS = 4


def masked_compact(mask: torch.Tensor, cols, m: int, fills):
    """mask bool[B, N]; cols: 1 to 4 int32 or uint8 tensors [B, N]; fills:
    one int per column -> (list of [B, m] tensors in the columns' dtypes,
    count int32[B]).  CPU tensors take the plain version; CUDA tensors
    launch the kernel, which reads and writes uint8 columns as bytes."""
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
    outs = [torch.empty((B, m), dtype=c.dtype, device=dev) for c in cols]
    count = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return outs, count
    tile_count, tile_off = _scratch(B, N, dev)
    ins = (_P * MAX_COLS)(*(c.data_ptr() for c in cols))
    outp = (_P * MAX_COLS)(*(o.data_ptr() for o in outs))
    fill_arr = (_I * MAX_COLS)(*fills)
    sizes = (_I * MAX_COLS)(*(c.element_size() for c in cols))
    fn = build.function("s2k_masked_compact", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(
            build.ptr(mask.view(torch.uint8)),
            *(ctypes.cast(a, _P) for a in (ins, outp, fill_arr, sizes)),
            len(cols), *map(build.ptr, (tile_count, tile_off, count)),
            B, N, m, build.stream_of(dev),
        )
    build.launches["masked_compact"] += 1
    build.check(err, "s2k_masked_compact")
    return outs, count


def hpc_compact(codes: torch.Tensor, lengths: torch.Tensor):
    """codes uint8[B, L] xcodes, lengths int32[B] -> (packed int32[B, L]:
    (pos << 3) | code of each kept base in order, then (L << 3) | CODE_PAD;
    hpc_len int32[B]).  A base is kept when its xcode keep bit is set and
    it lies inside its read.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if codes.ndim != 2:
        raise ValueError(f"codes must be [B, L], got {tuple(codes.shape)}")
    B, L = codes.shape
    dev = codes.device
    build.require(codes, "codes", torch.uint8, (B, L), dev)
    build.require(lengths, "lengths", torch.int32, (B,), dev)
    if L >= 1 << 28:
        raise ValueError("padded length must be < 2^28 for packed streams")
    if dev.type == "cpu":
        return hpc_compress_packed(codes, lengths)
    build.require_cuda(dev, codes=codes, lengths=lengths)
    packed = torch.empty((B, L), dtype=torch.int32, device=dev)
    count = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0 or L == 0:
        count.zero_()
        return packed, count
    tile_count, tile_off = _scratch(B, L, dev)
    fn = build.function("s2k_hpc_compact", _HPC_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(
            *map(build.ptr, (codes, lengths, packed, tile_count, tile_off, count)),
            B, L, build.stream_of(dev),
        )
    build.launches["hpc_compact"] += 1
    build.check(err, "s2k_hpc_compact")
    return packed, count


def _scratch(B: int, N: int, dev):
    """The tiles' counts and offsets, int32[B, nt] each."""
    tile = build.function("s2k_masked_compact_tile", [])()
    nt = -(-max(N, 1) // tile)
    return torch.empty((2, B, nt), dtype=torch.int32, device=dev).unbind(0)
