"""User-facing API: one sequence in, its k-min-mer records out.

``KminmersIterator(seq, l, k, density, mode)`` and ``kminmers_list``
mirror the reference package's surface; a single read is padded to a
power-of-two length and run through the batched pipeline on ``device``.
``kminmers_batch`` adds the overflow rescue to ``kminmer_pipeline``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List

import numpy as np
import torch

from .constants import XCODE_PAD, encode_xcodes, family_of_mode
from .ops.pipeline import PipelineSpec, kminmer_pipeline
from .ops.u64 import to_py_u64

# Reference limit: the SIMD paths assert l <= 31, where 32-bit NtHash1
# stops being a rolling hash of distinct rotations.
MAX_L_SIMD = 31


class KSizeTooBig(ValueError):
    """l is past the reference's limit for the mode."""


@dataclasses.dataclass
class KminmerRecord:
    """One k-min-mer.  Equality compares the hash only, as the
    reference's does; positions are payload."""

    hash: int
    start: int
    end: int
    offset: int
    rev: bool

    def __eq__(self, other):
        return self.hash == other.hash

    def get_hash(self) -> int:
        return self.hash


def _mode_name(mode) -> str:
    """A mode string, or an enum whose value is one (the reference's
    HashMode)."""
    return str(getattr(mode, "value", mode)).lower()


def _bucket_length(n: int) -> int:
    """Pad single reads to a small set of lengths."""
    b = 256
    while b < n + 1:
        b *= 2
    return b


def _round_cap(n: int) -> int:
    """Round capacities up to powers of two."""
    c = 128
    while c < n:
        c *= 2
    return c


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is false"
        )
    return device


def rescue_spec(spec: PipelineSpec, m_cap_needed: int = 0) -> PipelineSpec:
    """The configuration an overflow retries with: tile_cap = 0 is the
    lossless per-tile capacity (every base of a tile may survive), so one
    rescue run loses nothing below the stream capacity M.  M itself is
    raised, to a power of two, only when the raw count needs it."""
    changes = {"tile_cap": 0}
    if m_cap_needed and (
        spec.max_minimizers is None or spec.max_minimizers < m_cap_needed
    ):
        changes["max_minimizers"] = _round_cap(m_cap_needed)
    return dataclasses.replace(spec, **changes)


def kminmers_batch(codes, lengths, spec: PipelineSpec, max_retries: int = 8):
    """kminmer_pipeline with overflow rescue.  A read whose raw selected
    count exceeds its kept count lost survivors to a tile's or the
    stream's capacity; the batch then reruns on ``rescue_spec``.

    Returns a KminmerBatch whose n_minimizers == n_minimizers_raw."""
    for _ in range(max_retries):
        out = kminmer_pipeline(codes, lengths, spec)
        n_raw = out.n_minimizers_raw.cpu()
        if bool((out.n_minimizers.cpu() >= n_raw).all()):
            return out
        spec = rescue_spec(spec, int(n_raw.max()))
    raise RuntimeError(
        f"minimizer overflow not resolved after {max_retries} retries"
    )


def kminmers_list(
    seq, l: int, k: int, density: float, mode="regular", device="cuda"
) -> List[KminmerRecord]:
    """All k-min-mers of one sequence, in order.  ``seq`` is str, bytes or
    a pre-encoded integer array of xcodes.  ``device`` must exist: on a
    machine without a GPU, pass ``device="cpu"`` to run the plain
    versions."""
    mode = _mode_name(mode)
    device = _device(device)
    if mode in ("simd", "hpcsimd") and l > MAX_L_SIMD:
        raise KSizeTooBig(f"l={l} exceeds {MAX_L_SIMD} for SIMD modes")
    if isinstance(seq, np.ndarray) and np.issubdtype(seq.dtype, np.integer):
        codes = seq.astype(np.uint8, copy=False)
    else:
        codes = encode_xcodes(seq, family_of_mode(mode))
    n = len(codes)
    if n <= l:
        return []
    L = _bucket_length(n)
    padded = np.full((1, L), XCODE_PAD, dtype=np.uint8)
    padded[0, :n] = codes
    spec = PipelineSpec(l=l, k=k, density=density, mode=mode)
    out = kminmers_batch(
        torch.from_numpy(padded).to(device),
        torch.tensor([n], dtype=torch.int32, device=device),
        spec,
    )
    nk = int(out.n_kminmers[0])
    if nk == 0:
        return []
    hashes = to_py_u64((out.hash_hi[0, :nk], out.hash_lo[0, :nk]))
    start = out.start[0, :nk].cpu().numpy()
    end = out.end[0, :nk].cpu().numpy()
    rev = out.rev[0, :nk].cpu().numpy()
    return [
        KminmerRecord(
            hash=int(hashes[i]),
            start=int(start[i]),
            end=int(end[i]),
            offset=i,
            rev=bool(rev[i]),
        )
        for i in range(nk)
    ]


class KminmersIterator:
    """Iterator over the k-min-mers of one sequence.

        for km in KminmersIterator(seq, l=10, k=5, density=0.1, mode="hpc"):
            print(km.hash, km.start, km.end, km.offset, km.rev)
    """

    def __init__(
        self, seq, l: int, k: int, density: float, mode="regular",
        device="cuda",
    ):
        self._records = kminmers_list(seq, l, k, density, mode, device)

    def __iter__(self) -> Iterator[KminmerRecord]:
        return iter(self._records)

    def __len__(self) -> int:
        return len(self._records)

    def collect(self) -> List[KminmerRecord]:
        return list(self._records)
