"""K5 and K6: in-row compaction (``csrc/inrow_compact.cu``) and its plain
version.

Each 128-lane row of up to four f32 payloads ``[R, 128]`` is left-packed
by one shared keep mask (f32 ``[R, 128]``, nonzero = keep), in order,
with zeros after the row's kept count.  Values move as bit patterns.  K5
(``inrow_compact_ballot``) ranks with warp ballots and scatters through
shared memory; K6 (``inrow_compact_mma``) applies the same permutation as
an integer one-hot product on the tensor cores.  The profiling script
``rust_seq2kminmers_torch/scripts/prof_mxu_compact.py`` races the two.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

LANES = 128
MAX_PAYLOADS = 4
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 9 + [_I] * 2 + [_P]


def inrow_compact_ballot(xs, keep: torch.Tensor) -> list:
    """K5: the payloads ``xs`` (a list of 1-4 f32[R, 128]) left-packed per
    row by ``keep`` -> a list of f32[R, 128].  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    return _inrow(xs, keep, "ballot")


def inrow_compact_mma(xs, keep: torch.Tensor) -> list:
    """K6: the same as ``inrow_compact_ballot``, on the tensor cores."""
    return _inrow(xs, keep, "mma")


def _inrow(xs, keep, method):
    if keep.ndim != 2 or keep.shape[1] != LANES:
        raise ValueError(f"keep must be [R, {LANES}], got {tuple(keep.shape)}")
    R = keep.shape[0]
    dev = keep.device
    build.require(keep, "keep", torch.float32, (R, LANES), dev)
    xs = list(xs)
    if not 1 <= len(xs) <= MAX_PAYLOADS:
        raise ValueError(f"1 to {MAX_PAYLOADS} payloads, got {len(xs)}")
    for i, x in enumerate(xs):
        build.require(x, f"xs[{i}]", torch.float32, (R, LANES), dev)
    if dev.type == "cpu":
        return inrow_compact_plain(xs, keep)
    build.require_cuda(dev, keep=keep, **{f"xs[{i}]": x for i, x in enumerate(xs)})
    outs = [torch.empty_like(x) for x in xs]
    if R == 0:
        return outs
    pad = [None] * (MAX_PAYLOADS - len(xs))
    fn = build.function(f"s2k_inrow_compact_{method}", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(
            *map(build.ptr, xs), *pad, build.ptr(keep), *map(build.ptr, outs), *pad,
            len(xs), R, build.stream_of(dev),
        )
    build.launches[f"inrow_compact_{method}"] += 1
    build.check(err, f"s2k_inrow_compact_{method}")
    return outs


def inrow_compact_plain(xs, keep: torch.Tensor) -> list:
    """The plain PyTorch version of both kernels, on any device: a row-wise
    cumsum rank, then one scatter per payload into a zeroed row."""
    kept = keep != 0
    rank = torch.cumsum(kept.to(torch.int64), dim=1) - 1
    dest = torch.where(kept, rank, LANES)  # dropped elements land in a spare lane
    outs = []
    for x in xs:
        out = torch.zeros((x.shape[0], LANES + 1), dtype=x.dtype, device=x.device)
        out.scatter_(1, dest, x)
        outs.append(out[:, :LANES])
    return outs
