"""K1: fused minimizer scan (``csrc/fused_scan.cu``) and its plain version.

One pass over xcodes ``uint8[B, L]``: HPC keep (hpc modes), canonical
NtHash over the kept stream (NtHash1 at hash width 16, 32 or 64, or the
NtHash2-hybrid 31-bit variant), density select, and the per-tile pack of
the survivors (start, end, hash).  A window belongs to the tile holding
its emitting element: its last element, or its one-past-last element when
``hpc_end`` (hpc mode: end = pos[f+l] - 1, so the final window is never
emitted).  Per tile, ``counts`` = (kept survivors, raw selected, kept
stream elements); kept < raw means the tile's ``cap`` slots overflowed.

The scan resumes mid-read from a carry (``ops/long_read.py`` cuts a long
read into chunks): ``base0`` int32[B] is the global kept rank before this
chunk and ``carry0`` int32[B, l] the last l stream elements before it,
right-aligned and packed ``(pos << 3) | code`` with chunk-relative (so
negative) positions; only the last min(base0, l) are real.  Windows are
selected by their global start rank, so each chunk emits exactly the
windows whose emitting element it holds.  With ``emit_carry`` the scan
also returns the last l elements of its stream in the same packing, for
the next chunk (whose caller subtracts ``chunk << 3`` to rebase them); the
next base is ``base0 + counts[:, :, 2].sum(1)``.

The same algebra cuts a row into tiles that the card scans in parallel:
``tile_carries`` gives each tile t its first rank ``base[:, t]`` and its
pending prefix ``pending[:, t]`` (the carry a scan of tiles 0..t-1 would
hand it), and tile nt's prefix is the carry-out.  The kernel runs it as
its passes 1-2, then scans every tile from its own carry (pass 3).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...constants import CODE_PAD, seed_tables, seed_tables_nthash2_31
from ..compact import compact
from ..hpc import hpc_keep_mask
from ..nthash import below_bound, canonical_nthash
from ..u64 import i32_bits
from . import build

TILE = 16384  # bases per output tile
MAX_L = 255
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 16 + [_I] * 3 + [ctypes.c_uint64] + [_I] * 7 + [_P]
_CARRY_ARGTYPES = [_P] * 8 + [_I] * 6 + [_P]

# Kernel width per (hash_width, variant): 31 is the NtHash2-hybrid variant.
_WIDTHS = {(16, "nthash1"): 16, (32, "nthash1"): 32, (64, "nthash1"): 64,
           (32, "nthash2"): 31}


def default_tile_cap(density: float, tile: int = TILE) -> int:
    """Survivor slots per tile from the density: twice the binomial mean
    plus a tail margin, in multiples of 128, at most the tile (lossless).
    The same rule as the TPU's per-block ``default_rows_out``."""
    mean = tile * max(density, 0.0)
    need = -(-(2.0 * mean + 5.0 * mean ** 0.5 + 192.0) // 128) * 128
    return int(min(need, tile))


def kernel_width(hash_width: int, variant: str) -> int:
    """The kernel's hash width: 16, 32 or 64, or 31 for nthash2."""
    if (hash_width, variant) not in _WIDTHS:
        raise ValueError(
            f"no hash for hash_width={hash_width} variant={variant!r}"
        )
    return _WIDTHS[hash_width, variant]


@functools.lru_cache(maxsize=None)
def _seeds(device: torch.device, width: int) -> torch.Tensor:
    """Forward seeds in [0, 8), reverse seeds in [8, 16), as the bits of
    the width's type: uint64 at width 64, else uint32."""
    tf, tr = seed_tables_nthash2_31() if width == 31 else seed_tables(width)
    dt, view = (np.uint64, np.int64) if width == 64 else (np.uint32, np.int32)
    t = np.zeros(16, dtype=dt)
    t[: len(tf)] = tf
    t[8 : 8 + len(tr)] = tr
    return torch.from_numpy(t.view(view)).to(device)


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
    hash_width: int = 32,
    variant: str = "nthash1",
    base0: torch.Tensor | None = None,  # int32[B] carry-in kept rank
    carry0: torch.Tensor | None = None,  # int32[B, l] carry-in elements
    emit_carry: bool = False,
):
    """-> (start, end, hash) int32[B, nt, cap] and counts int32[B, nt, 3],
    nt = ceil(L / tile), then the carry-out int32[B, l] when
    ``emit_carry``.  Tile t's survivors are the first counts[b, t, 0]
    slots of its row, in stream order; later slots are undefined.
    ``hash`` holds u32 bit patterns; at hash_width 64 it is the pair (hi,
    lo) of the u64's halves.  ``base0`` and ``carry0`` default to a fresh
    read.  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if codes.ndim != 2:
        raise ValueError(f"codes must be [B, L], got {tuple(codes.shape)}")
    B, L = codes.shape
    dev = codes.device
    build.require(codes, "codes", torch.uint8, (B, L), dev)
    build.require(lengths, "lengths", torch.int32, (B,), dev)
    build.require(limit, "limit", torch.int32, (B,), dev)
    if not 2 <= l <= MAX_L:
        raise ValueError(f"l={l} must be in [2, {MAX_L}]")
    if base0 is not None:
        build.require(base0, "base0", torch.int32, (B,), dev)
    if carry0 is not None:
        build.require(carry0, "carry0", torch.int32, (B, l), dev)
    if L >= 1 << 28:
        raise ValueError("padded length must be < 2^28")
    width = kernel_width(hash_width, variant)
    if not 0 <= bound < 1 << (64 if width == 64 else 32):
        raise ValueError(f"bound {bound} does not fit hash width {width}")
    if tile < 1:
        raise ValueError(f"tile={tile} must be positive")
    cap = tile if cap is None else cap
    if not 1 <= cap <= tile:
        raise ValueError(f"cap={cap} must be in [1, tile={tile}]")
    if dev.type == "cpu":
        return fused_scan_plain(
            codes, lengths, limit, l, bound, strict, do_hpc, hpc_end, tile, cap,
            hash_width, variant, base0, carry0, emit_carry,
        )
    build.require_cuda(
        dev, codes=codes, lengths=lengths, limit=limit, base0=base0, carry0=carry0
    )
    nt = _tiles(L, tile, l)
    start, end, hsh, *hi = (
        torch.empty((B, nt, cap), dtype=torch.int32, device=dev)
        for _ in range(4 if width == 64 else 3)
    )
    hsh_hi = hi[0] if hi else None
    counts = torch.empty((B, nt, 3), dtype=torch.int32, device=dev)
    out_hash = hsh if hsh_hi is None else (hsh_hi, hsh)
    carry_out = (torch.empty((B, l), dtype=torch.int32, device=dev)
                 if emit_carry else None)
    outs = (start, end, out_hash, counts) + ((carry_out,) if emit_carry else ())
    if B == 0 or L == 0:  # no step: the carry passes through
        counts.zero_()
        if emit_carry and carry0 is not None:
            carry_out.copy_(carry0)
        elif emit_carry:
            carry_out.zero_()
        return outs
    fn = build.function("s2k_fused_scan", _ARGTYPES)
    opt = [None if t is None else build.ptr(t) for t in (hsh_hi, base0, carry0, carry_out)]
    # Dropped on return; the caching allocator hands it out again only in
    # the stream's order, after these launches.
    scratch = _scratch(B, nt, l, dev)
    with torch.cuda.device(dev):
        err = fn(
            *map(build.ptr, (codes, lengths, limit, _seeds(dev, width), start, end, hsh)),
            opt[0], build.ptr(counts), *opt[1:], *map(build.ptr, scratch),
            B, L, l, bound, width, int(strict), int(do_hpc), int(hpc_end), tile,
            cap, nt, build.stream_of(dev),
        )
    build.launches["fused_scan"] += 1
    build.check(err, "s2k_fused_scan")
    return outs


def _tiles(L: int, tile: int, l: int) -> int:
    nt = -(-L // tile)
    if (nt + 1) * l >= 1 << 31:
        raise ValueError(f"{nt} tiles of {l} pending elements exceed int32 indexing")
    return nt


def _scratch(B: int, nt: int, l: int, dev):
    """Passes 1-2's int32 arrays, carved from one allocation: tile counts
    [B, nt], tails [B, nt, l], first ranks [B, nt + 1] and pending
    prefixes [B, nt + 1, l]."""
    sizes = [B * nt, B * nt * l, B * (nt + 1), B * (nt + 1) * l]
    parts = torch.empty(sum(sizes), dtype=torch.int32, device=dev).split(sizes)
    return [p.view(B, -1) for p in parts]


def tile_carries(
    codes: torch.Tensor,  # uint8[B, L] xcodes
    lengths: torch.Tensor,  # int32[B]
    l: int,
    tile: int,
    do_hpc: bool,
    base0: torch.Tensor | None = None,  # int32[B] carry-in kept rank
    carry0: torch.Tensor | None = None,  # int32[B, l] carry-in elements
):
    """K1's passes 1-2 alone -> (base int32[B, nt + 1], pending int32[B,
    nt + 1, l]): tile t's first global kept rank and the l stream elements
    before it (ranks base - l .. base - 1), packed ``(pos << 3) | code``
    with chunk-relative positions, as ``carry0`` is.  base[:, nt] is the
    next chunk's base0 and pending[:, nt] the carry-out.  CPU tensors take
    the plain version; CUDA tensors launch the kernel's two passes."""
    B, L = codes.shape
    dev = codes.device
    build.require(codes, "codes", torch.uint8, (B, L), dev)
    build.require(lengths, "lengths", torch.int32, (B,), dev)
    if not 2 <= l <= MAX_L:
        raise ValueError(f"l={l} must be in [2, {MAX_L}]")
    if base0 is not None:
        build.require(base0, "base0", torch.int32, (B,), dev)
    if carry0 is not None:
        build.require(carry0, "carry0", torch.int32, (B, l), dev)
    if L >= 1 << 28 or tile < 1:
        raise ValueError(f"need L < 2^28 and tile >= 1, got L={L}, tile={tile}")
    if dev.type == "cpu":
        return tile_carries_plain(codes, lengths, l, tile, do_hpc, base0, carry0)
    build.require_cuda(dev, codes=codes, lengths=lengths, base0=base0, carry0=carry0)
    if B == 0 or L == 0:
        raise ValueError(f"no tile in a [{B}, {L}] batch")
    nt = _tiles(L, tile, l)
    tile_count, tail, base, pending = _scratch(B, nt, l, dev)
    fn = build.function("s2k_tile_carries", _CARRY_ARGTYPES)
    opt = [None if t is None else build.ptr(t) for t in (base0, carry0)]
    with torch.cuda.device(dev):
        err = fn(
            *map(build.ptr, (codes, lengths)), *opt,
            *map(build.ptr, (tile_count, tail, base, pending)),
            B, L, l, int(do_hpc), tile, nt, build.stream_of(dev),
        )
    build.launches["tile_carries"] += 1
    build.check(err, "s2k_tile_carries")
    return base, pending.view(B, nt + 1, l)


def tile_carries_plain(codes, lengths, l, tile, do_hpc, base0=None, carry0=None):
    """The plain version of passes 1-2, on any device: the extended stream
    (the carry, then the row's kept elements) read at each tile's ranks."""
    B, L = codes.shape
    dev = codes.device
    nt = -(-L // tile)
    if do_hpc:
        keep = hpc_keep_mask(codes, lengths)
    else:  # every padded position is a stream element
        keep = torch.ones((B, L), dtype=torch.bool, device=dev)
    count = torch.nn.functional.pad(keep.to(torch.int64), (0, nt * tile - L))
    count = count.view(B, nt, tile).sum(dim=2)
    b0 = (torch.zeros(B, dtype=torch.int64, device=dev) if base0 is None
          else base0.to(torch.int64))
    base = torch.cat([b0[:, None], b0[:, None] + torch.cumsum(count, dim=1)], dim=1)
    j = torch.arange(L, device=dev)
    packed = (j[None, :] << 3) | (codes.to(torch.int64) & 7)
    (stream,), _ = compact(keep, [packed], L, [0])
    carry = (torch.zeros((B, l), dtype=torch.int64, device=dev) if carry0 is None
             else carry0.to(torch.int64))
    xstream = torch.cat([carry, stream], dim=1)  # index = rank - (base0 - l)
    idx = (base - b0[:, None])[:, :, None] + torch.arange(l, device=dev)
    pending = torch.gather(xstream, 1, idx.view(B, -1)).view(B, nt + 1, l)
    return base.to(torch.int32), pending.to(torch.int32)


def fused_scan_plain(
    codes, lengths, limit, l, bound, strict, do_hpc, hpc_end, tile, cap,
    hash_width=32, variant="nthash1", base0=None, carry0=None, emit_carry=False,
):
    """The plain PyTorch version of the kernel, on any device.  Slots past
    a tile's kept count are zero.  The carry's elements are prepended to
    the chunk's kept stream at global ranks base0 - l ..; the window hash
    does not depend on the rank, so only the masks see it."""
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
    base = (torch.zeros(B, dtype=torch.int64, device=dev) if base0 is None
            else base0.to(torch.int64))
    carry = (torch.zeros((B, l), dtype=torch.int64, device=dev) if carry0 is None
             else carry0.to(torch.int64))
    # The extended stream: the carry in [0, l), the chunk's kept elements
    # from l on; window f starts at global rank base - l + f.
    xcode = torch.cat([carry & 7, scode], dim=1)
    xpos = torch.cat([carry >> 3, spos, spos.new_full((B, 1), L)], dim=1)
    h = canonical_nthash(xcode, l, hash_width, variant)
    nwin = L + 1
    f = torch.arange(nwin, device=dev)
    emit = f + (l if hpc_end else l - 1)  # stream index of the emitting element
    rank = base[:, None] - l + f[None, :]
    passed = below_bound(h, bound, strict, hash_width)
    sel = (
        (emit[None, :] >= l)
        & (emit[None, :] < (n + l)[:, None])
        & (rank >= 0)
        & (rank <= limit[:, None])
        & passed
    )
    start = xpos[:, :nwin]
    end = xpos[:, l : l + nwin] - 1 if hpc_end else xpos[:, l - 1 : l - 1 + nwin]
    # A carried emitting element (never selected) would give a negative tile.
    epos = torch.gather(xpos, 1, emit.expand(B, nwin)).clamp_(min=0)
    etile = (epos // tile).clamp_(max=nt - 1)

    seli = sel.to(torch.int64)
    raw = torch.zeros((B, nt), dtype=torch.int64, device=dev)
    raw.scatter_add_(1, etile, seli)
    tile_off = torch.cumsum(raw, dim=1) - raw
    slot = torch.cumsum(seli, dim=1) - 1 - torch.gather(tile_off, 1, etile)
    dest = torch.where(sel & (slot < cap), etile * cap + slot, nt * cap)
    outs = []
    # i32_bits keeps the low word: of h, and of h >> 32 (the high word).
    for col in (start, end, h) + ((h >> 32,) if hash_width == 64 else ()):
        o = torch.zeros((B, nt * cap + 1), dtype=torch.int64, device=dev)
        o.scatter_(1, dest, col)
        outs.append(i32_bits(o[:, :-1]).view(B, nt, cap))
    stream = torch.nn.functional.pad(keep.to(torch.int64), (0, nt * tile - L))
    stream = stream.view(B, nt, tile).sum(dim=2)
    counts = torch.stack([raw.clamp(max=cap), raw, stream], dim=2)
    hsh = outs[2] if hash_width != 64 else (outs[3], outs[2])
    out = (outs[0], outs[1], hsh, counts.to(torch.int32))
    if not emit_carry:
        return out
    # The last l elements of the extended stream, [n, n + l).
    last = n.to(torch.int64)[:, None] + torch.arange(l, device=dev)[None, :]
    packed = (torch.gather(xpos, 1, last) << 3) | torch.gather(xcode, 1, last)
    return out + (packed.to(torch.int32),)


def valid_slots(rows: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Zero the slots past each tile's kept count: the part of the output
    contract that is defined, for comparing the kernel with the plain
    version."""
    slot = torch.arange(rows.shape[2], device=rows.device)
    return torch.where(slot < counts[..., :1], rows, 0)
