"""K3: k-min-mer assembly (``csrc/assemble.cu``).  Its plain version is
``ops/assemble.py:assemble_kminmers``."""

from __future__ import annotations

import ctypes

import torch

from ..assemble import assemble_kminmers
from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 3 + [_P]


def assemble_kminmers_cuda(min_hash: torch.Tensor, k: int):
    """min_hash: u32 bit patterns int32[B, M] -> ((hash_hi, hash_lo)
    int32[B, M-k+1], rev bool[B, M-k+1]).  Every window is computed;
    callers mask those past a row's count - k + 1.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if min_hash.ndim != 2:
        raise ValueError(f"min_hash must be [B, M], got {tuple(min_hash.shape)}")
    B, M = min_hash.shape
    dev = min_hash.device
    build.require(min_hash, "min_hash", torch.int32, (B, M), dev)
    if not 1 <= k <= M:
        raise ValueError(f"k={k} must be in [1, M={M}]")
    if dev.type == "cpu":
        return assemble_kminmers(min_hash, k)
    build.require_cuda(dev, min_hash=min_hash)
    nwin = M - k + 1
    hi, lo = (
        torch.empty((B, nwin), dtype=torch.int32, device=dev) for _ in range(2)
    )
    rev = torch.empty((B, nwin), dtype=torch.bool, device=dev)
    if B == 0:
        return (hi, lo), rev
    fn = build.function("s2k_assemble", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(
            *map(build.ptr, (min_hash, hi, lo, rev)), B, M, k,
            build.stream_of(dev),
        )
    build.launches["assemble"] += 1
    build.check(err, "s2k_assemble")
    return (hi, lo), rev
