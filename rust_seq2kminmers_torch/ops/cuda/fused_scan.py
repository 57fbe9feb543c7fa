"""K1: fused minimizer scan (``csrc/fused_scan.cu``) and its plain version.

One pass over xcodes ``uint8[B, L]``: HPC keep (hpc modes), canonical
NtHash1-32 over the kept stream, density select, and the per-tile pack of
the survivors (start, end, hash).  A window belongs to the tile holding
its emitting element: its last element, or its one-past-last element when
``hpc_end`` (hpc mode: end = pos[f+l] - 1, so the final window is never
emitted).  Per tile, ``counts`` = (kept survivors, raw selected, kept
stream elements); kept < raw means the tile's ``cap`` slots overflowed.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...constants import CODE_PAD, SEED_TABLE_F, SEED_TABLE_R, U32_MAX
from ..compact import compact
from ..hpc import hpc_keep_mask
from ..nthash import sliding_nthash32
from ..u64 import i32_bits
from . import build

TILE = 16384  # bases per output tile
MAX_L = 255
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 3 + [ctypes.c_uint32] + [_I] * 6 + [_P]


def default_tile_cap(density: float, tile: int = TILE) -> int:
    """Survivor slots per tile from the density: twice the binomial mean
    plus a tail margin, in multiples of 128, at most the tile (lossless).
    The same rule as the TPU's per-block ``default_rows_out``."""
    mean = tile * max(density, 0.0)
    need = -(-(2.0 * mean + 5.0 * mean ** 0.5 + 192.0) // 128) * 128
    return int(min(need, tile))


@functools.lru_cache(maxsize=None)
def _seeds(device: torch.device) -> torch.Tensor:
    """Forward seeds in [0, 8), reverse seeds in [8, 16), as u32 bits."""
    t = np.zeros(16, dtype=np.uint32)
    t[: len(SEED_TABLE_F)] = SEED_TABLE_F
    t[8 : 8 + len(SEED_TABLE_R)] = SEED_TABLE_R
    return torch.from_numpy(t.view(np.int32)).to(device)


def fused_minimizer_scan(
    codes: torch.Tensor,  # uint8[B, L] xcodes
    lengths: torch.Tensor,  # int32[B]
    limit: torch.Tensor,  # int32[B] largest window-start rank, -1 = none
    l: int,
    bound: int,
    strict: bool,
    do_hpc: bool,
    hpc_end: bool,
    tile: int = TILE,
    cap: int | None = None,  # survivor slots per tile; None = tile
):
    """-> (start, end, hash) int32[B, nt, cap] and counts int32[B, nt, 3],
    nt = ceil(L / tile).  Tile t's survivors are the first counts[b, t, 0]
    slots of its row, in stream order; later slots are undefined.
    ``hash`` holds u32 bit patterns.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if codes.ndim != 2:
        raise ValueError(f"codes must be [B, L], got {tuple(codes.shape)}")
    B, L = codes.shape
    dev = codes.device
    build.require(codes, "codes", torch.uint8, (B, L), dev)
    build.require(lengths, "lengths", torch.int32, (B,), dev)
    build.require(limit, "limit", torch.int32, (B,), dev)
    if not 2 <= l <= MAX_L:
        raise ValueError(f"l={l} must be in [2, {MAX_L}]")
    if L >= 1 << 28:
        raise ValueError("padded length must be < 2^28")
    if not 0 <= bound <= U32_MAX:
        raise ValueError(f"bound {bound} is not a u32")
    if tile < 1:
        raise ValueError(f"tile={tile} must be positive")
    cap = tile if cap is None else cap
    if not 1 <= cap <= tile:
        raise ValueError(f"cap={cap} must be in [1, tile={tile}]")
    if dev.type == "cpu":
        return fused_scan_plain(
            codes, lengths, limit, l, bound, strict, do_hpc, hpc_end, tile, cap
        )
    build.require_cuda(dev, codes=codes, lengths=lengths, limit=limit)
    nt = -(-L // tile)
    start, end, hsh = (
        torch.empty((B, nt, cap), dtype=torch.int32, device=dev)
        for _ in range(3)
    )
    counts = torch.empty((B, nt, 3), dtype=torch.int32, device=dev)
    if B == 0 or L == 0:
        counts.zero_()
        return start, end, hsh, counts
    seeds = _seeds(dev)
    fn = build.function("s2k_fused_scan", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(
            *map(build.ptr, (codes, lengths, limit, seeds, start, end, hsh, counts)),
            B, L, l, bound, int(strict), int(do_hpc), int(hpc_end), tile, cap, nt,
            build.stream_of(dev),
        )
    build.launches["fused_scan"] += 1
    build.check(err, "s2k_fused_scan")
    return start, end, hsh, counts


def fused_scan_plain(
    codes, lengths, limit, l, bound, strict, do_hpc, hpc_end, tile, cap
):
    """The plain PyTorch version of the kernel, on any device.  Slots past
    a tile's kept count are zero."""
    B, L = codes.shape
    dev = codes.device
    nt = -(-L // tile)
    j = torch.arange(L, device=dev)
    if do_hpc:
        keep = hpc_keep_mask(codes, lengths)
    else:  # every padded position is hashed; `limit` bounds the windows
        keep = torch.ones((B, L), dtype=torch.bool, device=dev)
    (scode, spos), n = compact(
        keep, [codes.to(torch.int64) & 7, j.expand(B, L)], L, [CODE_PAD, L]
    )
    fh, rh = sliding_nthash32(scode, l)
    h = torch.minimum(fh, rh)
    nwin = L - l + 1
    f = torch.arange(nwin, device=dev)
    emit = f + (l if hpc_end else l - 1)  # stream index of the emitting element
    passed = (h < bound) if strict else (h <= bound)
    sel = (
        (emit[None, :] < n[:, None])
        & (f[None, :] <= limit[:, None])
        & passed
    )
    pos = torch.cat([spos, spos.new_full((B, 1), L)], dim=1)
    start = spos[:, :nwin]
    end = pos[:, l : l + nwin] - 1 if hpc_end else spos[:, l - 1 : l - 1 + nwin]
    etile = (torch.gather(pos, 1, emit.expand(B, nwin)) // tile).clamp_(max=nt - 1)

    seli = sel.to(torch.int64)
    raw = torch.zeros((B, nt), dtype=torch.int64, device=dev)
    raw.scatter_add_(1, etile, seli)
    tile_off = torch.cumsum(raw, dim=1) - raw
    slot = torch.cumsum(seli, dim=1) - 1 - torch.gather(tile_off, 1, etile)
    dest = torch.where(sel & (slot < cap), etile * cap + slot, nt * cap)
    outs = []
    for col in (start, end, h):
        o = torch.zeros((B, nt * cap + 1), dtype=torch.int64, device=dev)
        o.scatter_(1, dest, col)
        outs.append(i32_bits(o[:, :-1]).view(B, nt, cap))
    stream = torch.nn.functional.pad(keep.to(torch.int64), (0, nt * tile - L))
    stream = stream.view(B, nt, tile).sum(dim=2)
    counts = torch.stack([raw.clamp(max=cap), raw, stream], dim=2)
    return (*outs, counts.to(torch.int32))


def valid_slots(rows: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Zero the slots past each tile's kept count: the part of the output
    contract that is defined, for comparing the kernel with the plain
    version."""
    slot = torch.arange(rows.shape[2], device=rows.device)
    return torch.where(slot < counts[..., :1], rows, 0)
