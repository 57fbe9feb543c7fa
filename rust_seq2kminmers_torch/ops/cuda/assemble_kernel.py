"""K3: k-min-mer assembly (``csrc/assemble.cu``).  Its plain versions are
``ops/assemble.py:assemble_plain`` and ``assemble_masked_plain``."""

from __future__ import annotations

import ctypes

import torch

from ..assemble import assemble_masked_plain, assemble_plain
from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 11 + [_I] * 4 + [_P]


def assemble_kminmers_cuda(
    min_hash: torch.Tensor, k: int, hash_width: int = 32, min_hash_hi=None
):
    """min_hash: u32 bit patterns int32[B, M] (at hash_width 64 the low
    words, with the high words in ``min_hash_hi``) -> ((hash_hi, hash_lo)
    int32[B, M-k+1], rev bool[B, M-k+1]).  The mix to u64 follows the
    width: xorshift (32), murmur of the low 16 bits (16), identity (64).
    Every window is computed; ``assemble_masked_cuda`` masks those past a
    row's count - k + 1.  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    _require(min_hash, k, hash_width, min_hash_hi)
    if min_hash.device.type == "cpu":
        return assemble_plain(min_hash, k, hash_width, min_hash_hi)
    hi, lo, rev = _launch(min_hash, k, hash_width, min_hash_hi)
    return (hi, lo), rev


def assemble_masked_cuda(
    min_hash: torch.Tensor,
    k: int,
    hash_width: int,
    min_hash_hi,
    n_min: torch.Tensor,  # int32[B] valid minimizers per row
    min_start: torch.Tensor,  # int32[B, M]
    min_end: torch.Tensor,  # int32[B, M]
):
    """The k-min-mer fields of a batch from its minimizer stream -> (hash_hi,
    hash_lo, start, end) int32[B, M-k+1], rev bool[B, M-k+1], n_kminmers
    int32[B]: window w < n_kminmers = max(n_min - (k-1), 0) has its hash
    and rev, start = min_start[w] and end = min_end[w + k - 1]; later
    windows are zero (false).  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    B, M = _require(min_hash, k, hash_width, min_hash_hi)
    dev = min_hash.device
    build.require(n_min, "n_min", torch.int32, (B,), dev)
    build.require(min_start, "min_start", torch.int32, (B, M), dev)
    build.require(min_end, "min_end", torch.int32, (B, M), dev)
    if dev.type == "cpu":
        return assemble_masked_plain(
            min_hash, k, hash_width, min_hash_hi, n_min, min_start, min_end
        )
    return _launch(min_hash, k, hash_width, min_hash_hi, n_min, min_start, min_end)


def _require(min_hash, k, hash_width, min_hash_hi):
    """Check the hash columns and k; -> (B, M)."""
    if min_hash.ndim != 2:
        raise ValueError(f"min_hash must be [B, M], got {tuple(min_hash.shape)}")
    B, M = min_hash.shape
    build.require(min_hash, "min_hash", torch.int32, (B, M), min_hash.device)
    if hash_width not in (16, 32, 64):
        raise ValueError(f"hash_width must be 16/32/64, got {hash_width}")
    if (min_hash_hi is not None) != (hash_width == 64):
        raise ValueError("min_hash_hi is given exactly at hash_width 64")
    if min_hash_hi is not None:
        build.require(min_hash_hi, "min_hash_hi", torch.int32, (B, M), min_hash.device)
    if not 1 <= k <= M:
        raise ValueError(f"k={k} must be in [1, M={M}]")
    return B, M


def _launch(min_hash, k, hash_width, min_hash_hi, n_min=None, min_start=None,
            min_end=None):
    """One launch; -> (hash_hi, hash_lo, rev), or with n_min the masked
    (hash_hi, hash_lo, start, end, rev, n_kminmers)."""
    B, M = min_hash.shape
    dev = min_hash.device
    build.require_cuda(dev, min_hash=min_hash, min_hash_hi=min_hash_hi, n_min=n_min,
                       min_start=min_start, min_end=min_end)
    masked = n_min is not None
    nwin = M - k + 1
    hi, lo, *pos = (torch.empty((B, nwin), dtype=torch.int32, device=dev)
                    for _ in range(4 if masked else 2))
    rev = torch.empty((B, nwin), dtype=torch.bool, device=dev)
    n_km = torch.empty((B,), dtype=torch.int32, device=dev) if masked else None
    outs = (hi, lo, *pos, rev, n_km) if masked else (hi, lo, rev)
    if B == 0:
        return outs
    ins = [None if t is None else build.ptr(t)
           for t in (min_hash_hi, min_start, min_end, n_min)]
    opt_out = [None] * 3 if not masked else list(map(build.ptr, (*pos, n_km)))
    fn = build.function("s2k_assemble", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(
            build.ptr(min_hash), *ins, *map(build.ptr, (hi, lo, rev)), *opt_out,
            B, M, k, hash_width, build.stream_of(dev),
        )
    build.launches["assemble"] += 1
    build.check(err, "s2k_assemble")
    return outs
