"""The general path's minimizer stream (``csrc/general_scan.cu``) and its
plain version.

For l = 1 or l > 255 (beyond K1's carry), the pipeline hashes whole rows:
the canonical NtHash of every window of l stream elements, the density
select, the window gate, each window's start and end, and the ordered
compaction of (start, end, hash[, hash_hi]) into [B, m] with zeros past
the count.  In the hpc modes the stream is K4's packed HPC column (pos <<
3) | code and ``eff_len`` its count; otherwise the xcodes, with ``eff_len``
the lengths.  The reference package computes this in XLA
(``rust_seq2kminmers_tpu/ops/pipeline.py:198-264``), so no TPU kernel
stands behind it.
"""

from __future__ import annotations

import ctypes

import torch

from ...constants import MODES
from ..compact import compact
from ..nthash import below_bound, canonical_nthash
from ..u64 import i32_bits
from . import build
from .fused_scan import _seeds, kernel_width

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _I] + [_P] * 10 + [_I] * 3 + [ctypes.c_uint64] + [_I] * 4 + [_P]


def general_minimizers(
    stream: torch.Tensor,  # int32[B, L] packed (hpc modes) or uint8[B, L] xcodes
    eff_len: torch.Tensor,  # int32[B] stream elements per row
    lengths: torch.Tensor,  # int32[B] read lengths
    l: int,
    bound: int,
    strict: bool,
    mode: str,
    hash_width: int,
    variant: str,
    m: int,
):
    """-> (start, end, hash) int32[B, m], hash_hi int32[B, m] at
    hash_width 64 (else None), n_min and n_raw int32[B]: the selected
    windows in order, zero past n_min = min(n_raw, m).  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if stream.ndim != 2:
        raise ValueError(f"stream must be [B, L], got {tuple(stream.shape)}")
    B, L = stream.shape
    dev = stream.device
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    is_hpc = mode in ("hpc", "hpcsimd")
    build.require(stream, "stream", torch.int32 if is_hpc else torch.uint8, (B, L), dev)
    build.require(eff_len, "eff_len", torch.int32, (B,), dev)
    build.require(lengths, "lengths", torch.int32, (B,), dev)
    if not 1 <= l < L:
        raise ValueError(f"l={l} must be in [1, L={L})")
    if L >= 1 << 28:
        raise ValueError("padded length must be < 2^28")
    width = kernel_width(hash_width, variant)
    if not 0 <= bound < 1 << (64 if width == 64 else 32):
        raise ValueError(f"bound {bound} does not fit hash width {width}")
    if m < 1:
        raise ValueError(f"m={m} must be positive")
    if dev.type == "cpu":
        return general_minimizers_plain(
            stream, eff_len, lengths, l, bound, strict, mode, hash_width, variant, m
        )
    build.require_cuda(dev, stream=stream, eff_len=eff_len, lengths=lengths)
    start, end, hsh, *hi = (
        torch.empty((B, m), dtype=torch.int32, device=dev)
        for _ in range(4 if width == 64 else 3)
    )
    n_min, n_raw = torch.empty((2, B), dtype=torch.int32, device=dev).unbind(0)
    hsh_hi = hi[0] if hi else None
    if B == 0:
        return start, end, hsh, hsh_hi, n_min, n_raw
    size = build.function("s2k_general_scan_scratch", [_I] * 3)
    size.restype = ctypes.c_size_t
    scratch = torch.empty(size(B, L, width), dtype=torch.uint8, device=dev)
    fn = build.function("s2k_general_scan", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(
            build.ptr(stream), int(is_hpc),
            *map(build.ptr, (lengths, eff_len, _seeds(dev, width), start, end, hsh)),
            None if hsh_hi is None else build.ptr(hsh_hi),
            *map(build.ptr, (n_min, n_raw, scratch)),
            B, L, l, bound, width, int(strict), int(mode == "hpc"), m,
            build.stream_of(dev),
        )
    build.launches["general_scan"] += 1
    build.check(err, "s2k_general_scan")
    return start, end, hsh, hsh_hi, n_min, n_raw


def general_minimizers_plain(
    stream, eff_len, lengths, l, bound, strict, mode, hash_width, variant, m
):
    """The plain PyTorch version, on any device: whole-row hashes, the
    select and the gate, then one compaction."""
    B, L = stream.shape
    h = canonical_nthash(stream, l, hash_width, variant)  # reads the low 3 bits
    nwin = L - l + 1
    i = torch.arange(nwin, dtype=torch.int32, device=stream.device)[None, :]

    # Whole-read gate: no window unless the read is longer than l.  The
    # hpc mode never emits the last HPC window.
    if mode == "hpc":
        valid = i < (eff_len - l)[:, None]
    else:
        valid = i <= (eff_len - l)[:, None]
    sel = (lengths > l)[:, None] & valid & below_bound(h, bound, strict, hash_width)

    if mode in ("hpc", "hpcsimd"):
        pos = stream >> 3
        start = pos[:, :nwin]
        if mode == "hpc":  # first original index after the window, - 1
            pos_ext = torch.cat([pos, pos.new_full((B, 1), L)], dim=1)
            end = pos_ext[:, l : l + nwin] - 1
        else:
            end = pos[:, l - 1 : l - 1 + nwin]
    else:
        start = i.expand(B, nwin)
        end = start + (l - 1)
    cols = [start, end, i32_bits(h)]
    if hash_width == 64:
        cols.append(i32_bits(h >> 32))
    cols, n_raw = compact(sel, [c.contiguous() for c in cols], m, [0] * len(cols))
    hash_hi = cols[3] if hash_width == 64 else None
    return cols[0], cols[1], cols[2], hash_hi, torch.clamp(n_raw, max=m), n_raw
