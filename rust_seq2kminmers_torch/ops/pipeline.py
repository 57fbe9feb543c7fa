"""The batched k-min-mer pipeline: xcodes -> KminmerBatch.

    codes uint8[B, L], lengths int32[B]
      -> K1 fused scan: HPC keep, canonical NtHash1-32, density select,
         per-tile survivor pack                  (ops/cuda/fused_scan.py)
      -> K2 slot compaction into the ordered minimizer stream [B, m]
                                                 (ops/cuda/slot_compact.py)
      -> K3 xorshift mix + k-window canonical hash in minimizer space
                                                 (ops/cuda/assemble_kernel.py)
      -> masking of the windows past each read's count

Per-mode conventions (bit-exact with the reference package):
  regular : all windows, hash <= f64 bound, start=i, end=i+l-1
  simd    : all windows, hash <  f32 bound, start=i, end=i+l-1
  hpc     : drops the last HPC window, hash <= f64 bound,
            start=run_start[i], end=run_start[i+l]-1
  hpcsimd : all windows, hash <  f32 bound,
            start=run_start[i], end=run_start[i+l-1]

On CUDA tensors every stage launches its kernel; on CPU tensors every
stage runs its plain version.  ``kminmer_pipeline_plain`` runs the plain
versions on any device, as the reference the kernels are held against.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..constants import hash_bound_simd_u32, hash_bound_u32
from .assemble import assemble_kminmers
from .cuda.assemble_kernel import assemble_kminmers_cuda
from .cuda.fused_scan import (
    MAX_L,
    TILE,
    default_tile_cap,
    fused_minimizer_scan,
    fused_scan_plain,
)
from .cuda.slot_compact import slot_compact, slot_compact_plain

MODES = ("regular", "hpc", "simd", "hpcsimd")


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """Static configuration of the pipeline.

    The fields, and the rules for ``bound``, ``strict_threshold``,
    ``is_hpc`` and ``capacity_for``, mirror the reference package's
    ``PipelineSpec`` at u32 hashes and NtHash1 (the widths 16/64 and the
    nthash2 variant are not ported yet).  Its TPU-only fields have no
    counterpart: ``compaction`` (the device decides) and ``slots`` /
    ``rows_out`` (per-row and per-block survivor capacities), which the
    single per-tile capacity ``tile_cap`` replaces.

    ``max_minimizers`` is the capacity M of the compacted minimizer stream
    per read (None = derived from the density and length); survivors past
    it are dropped and show in ``KminmerBatch.n_minimizers_raw``.
    ``tile_cap`` is the survivor slots per K1 tile: None derives it from the
    density, 0 is the lossless maximum (the tile size).
    """

    l: int
    k: int
    density: float
    mode: str = "regular"
    max_minimizers: Optional[int] = None
    tile_cap: Optional[int] = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.l < 1 or self.k < 1:
            raise ValueError("l and k must be >= 1")
        if self.tile_cap is not None and self.tile_cap < 0:
            raise ValueError(f"tile_cap={self.tile_cap} must be >= 0")

    @property
    def strict_threshold(self) -> bool:
        # SIMD paths compare with `<`, scalar paths with `<=`.
        return self.mode in ("simd", "hpcsimd")

    @property
    def bound(self) -> int:
        if self.strict_threshold:
            return hash_bound_simd_u32(self.density)
        return hash_bound_u32(self.density)

    @property
    def is_hpc(self) -> bool:
        return self.mode in ("hpc", "hpcsimd")

    def capacity_for(self, length: int) -> int:
        if self.max_minimizers is not None:
            return max(self.max_minimizers, self.k)
        nwin = max(length - self.l + 1, 1)
        est = int(nwin * max(self.density, 0.0) * 4.0) + 128
        return min(max(est, self.k), nwin)

    def cap_per_tile(self, tile: int = TILE) -> int:
        if self.tile_cap is None:
            return default_tile_cap(self.density, tile)
        return tile if self.tile_cap == 0 else min(self.tile_cap, tile)


class KminmerBatch(NamedTuple):
    """Struct-of-arrays batch of k-min-mer records, field for field the
    reference package's ``KminmerBatch``.  The first n_kminmers[b] entries
    of each row are valid, in sequence order; entry w has offset w.  Hash
    fields are int32 tensors holding u32 bit patterns."""

    hash_hi: torch.Tensor  # int32[B, Mk]
    hash_lo: torch.Tensor  # int32[B, Mk]
    start: torch.Tensor  # int32[B, Mk]
    end: torch.Tensor  # int32[B, Mk]
    rev: torch.Tensor  # bool[B, Mk]
    n_kminmers: torch.Tensor  # int32[B]
    min_hash: torch.Tensor  # int32[B, M]
    min_hash_hi: torch.Tensor  # int32[B, M], zeros at u32 hashes
    min_start: torch.Tensor  # int32[B, M]
    min_end: torch.Tensor  # int32[B, M]
    n_minimizers: torch.Tensor  # int32[B] (clipped to M)
    n_minimizers_raw: torch.Tensor  # int32[B] (unclipped; > n_minimizers = loss)


def kminmer_pipeline(
    codes: torch.Tensor, lengths: torch.Tensor, spec: PipelineSpec
) -> KminmerBatch:
    """codes: uint8[B, L] xcodes (XCODE_PAD past each length), lengths:
    int32[B], both on one device."""
    return _pipeline(
        codes, lengths, spec,
        fused_minimizer_scan, slot_compact, assemble_kminmers_cuda,
    )


def kminmer_pipeline_plain(
    codes: torch.Tensor, lengths: torch.Tensor, spec: PipelineSpec
) -> KminmerBatch:
    """The same pipeline through the plain version of every stage, on the
    inputs' device."""
    return _pipeline(
        codes, lengths, spec,
        fused_scan_plain, slot_compact_plain, assemble_kminmers,
    )


def _pipeline(codes, lengths, spec, scan, stitch, assemble) -> KminmerBatch:
    B, L = codes.shape
    l, k = spec.l, spec.k
    if not 2 <= l <= MAX_L:
        raise ValueError(f"l={l} must be in [2, {MAX_L}]")
    if L < l + 1:
        raise ValueError(f"padded length {L} must exceed l={l}")
    lengths = lengths.to(torch.int32)
    m_cap = spec.capacity_for(L)
    if m_cap < k:
        raise ValueError(f"minimizer capacity {m_cap} < k={k}")

    # Largest window-start rank per read; no window unless length > l.  In
    # the HPC modes the kept stream itself ends each read, so only the
    # length gate is left.
    none = torch.full_like(lengths, -1)
    if spec.is_hpc:
        limit = torch.where(lengths > l, torch.full_like(lengths, 1 << 30), none)
    else:
        limit = torch.where(lengths > l, lengths - l, none)

    st, en, hs, counts = scan(
        codes, lengths, limit, l, spec.bound, spec.strict_threshold,
        spec.is_hpc, spec.mode == "hpc", TILE, spec.cap_per_tile(TILE),
    )
    n_raw = counts[:, :, 1].sum(dim=1, dtype=torch.int32)
    (min_start, min_end, min_hash), n_slotted = stitch(
        st, en, hs, counts[:, :, 0].contiguous(), m_cap
    )
    n_min = torch.clamp(n_slotted, max=m_cap)
    (kh_hi, kh_lo), rev = assemble(min_hash, k)

    mk = m_cap - k + 1
    n_km = torch.clamp(n_min - (k - 1), min=0)
    km_valid = torch.arange(mk, device=codes.device)[None, :] < n_km[:, None]
    return KminmerBatch(
        hash_hi=torch.where(km_valid, kh_hi, 0),
        hash_lo=torch.where(km_valid, kh_lo, 0),
        start=torch.where(km_valid, min_start[:, :mk], 0),
        end=torch.where(km_valid, min_end[:, k - 1 :], 0),
        rev=km_valid & rev,
        n_kminmers=n_km,
        min_hash=min_hash,
        min_hash_hi=torch.zeros_like(min_hash),
        min_start=min_start,
        min_end=min_end,
        n_minimizers=n_min,
        n_minimizers_raw=n_raw,
    )
