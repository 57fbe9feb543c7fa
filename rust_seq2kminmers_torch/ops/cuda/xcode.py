"""Xcode encoding of raw sequence bytes (``csrc/xcode.cu``) and its plain
version (``ops/xcode.py``, which states the function)."""

from __future__ import annotations

import ctypes
import functools

import torch

from ...constants import code_table
from ..xcode import encode_xcodes_plain
from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 5 + [_I] * 2 + [_P]


@functools.lru_cache(maxsize=None)
def _table(device: torch.device, family: str) -> torch.Tensor:
    return torch.from_numpy(code_table(family)).to(device)


def encode_xcodes_cuda(raw: torch.Tensor, prev: torch.Tensor, length_local: torch.Tensor,
                       family: str) -> torch.Tensor:
    """raw uint8[B, C], prev int32[B], length_local int32[B] -> uint8[B, C]
    xcodes (see ``ops/xcode.py``).  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if raw.ndim != 2:
        raise ValueError(f"raw must be [B, C], got {tuple(raw.shape)}")
    B, C = raw.shape
    dev = raw.device
    build.require(raw, "raw", torch.uint8, (B, C), dev)
    build.require(prev, "prev", torch.int32, (B,), dev)
    build.require(length_local, "length_local", torch.int32, (B,), dev)
    code_table(family)  # an unknown family raises
    if dev.type == "cpu":
        return encode_xcodes_plain(raw, prev, length_local, family)
    build.require_cuda(dev, raw=raw, prev=prev, length_local=length_local)
    if B > 65535:
        raise ValueError(f"at most 65535 rows a launch, got {B}")
    out = torch.empty_like(raw)
    if B == 0 or C == 0:
        return out
    fn = build.function("s2k_xcode", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(*map(build.ptr, (raw, prev, length_local, _table(dev, family), out)),
                 B, C, build.stream_of(dev))
    build.launches["xcode"] += 1
    build.check(err, "s2k_xcode")
    return out
