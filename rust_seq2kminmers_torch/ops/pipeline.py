"""The batched k-min-mer pipeline: xcodes -> KminmerBatch.

Two paths, routed as the reference package routes them: the fused path
when 2 <= l <= 255, the general path otherwise (l = 1, or l > 255).

    fused path (K1's carry holds up to 255 elements):
      codes uint8[B, L], lengths int32[B]
      -> K1 fused scan: HPC keep, canonical NtHash, density select,
         per-tile survivor pack                  (ops/cuda/fused_scan.py)
      -> K2 slot compaction into the ordered minimizer stream [B, m],
         with its counts n_min and n_raw         (ops/cuda/slot_compact.py)
      -> K3 mix to u64 + k-window canonical hash in minimizer space,
         written as the k-min-mer fields, zero past each read's count
                                                 (ops/cuda/assemble_kernel.py)

    general path:
      -> (hpc modes) K4's HPC form: the kept bases left-packed with their
         positions, (pos << 3) | code            (ops/cuda/masked_compact.py)
      -> the general scan: canonical NtHash of every window of the whole
         rows, density select, window gate, start/end, and the ordered
         compaction into [B, m] with n_min and n_raw
                                                 (ops/cuda/general_scan.py)
      -> K3, as on the fused path

The hash is NtHash1 at width 16, 32 or 64, or the NtHash2-hybrid 31-bit
variant; the minimizer hashes mix to u64 as murmur (16), xorshift (32,
nthash2) or the identity (64).

Per-mode conventions (bit-exact with the reference package):
  regular : all windows, hash <= f64 bound, start=i, end=i+l-1
  simd    : all windows, hash <  f32 bound, start=i, end=i+l-1
  hpc     : drops the last HPC window, hash <= f64 bound,
            start=run_start[i], end=run_start[i+l]-1
  hpcsimd : all windows, hash <  f32 bound,
            start=run_start[i], end=run_start[i+l-1]

On CUDA tensors every kernel stage launches its kernel; on CPU tensors
every stage runs its plain version.  ``kminmer_pipeline_plain`` runs the
plain versions on any device, as the reference the kernels are held
against.  ``make_pipeline(spec)`` is the compiled step, as the reference
jits it: on the card, one captured CUDA graph of ``kminmer_pipeline`` per
input shape, replayed as one launch.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import NamedTuple, Optional

import torch

from ..constants import (
    MODES,
    hash_bound,
    hash_bound_nthash2_31,
    hash_bound_simd_u32,
    hash_bound_u32,
)
from .assemble import assemble_masked_plain
from .cuda.assemble_kernel import assemble_masked_cuda
from .cuda.fused_scan import (
    MAX_L,
    TILE,
    default_tile_cap,
    fused_minimizer_scan,
    fused_scan_plain,
)
from .cuda.general_scan import general_minimizers, general_minimizers_plain
from .cuda.graph import CapturedStep
from .cuda.masked_compact import hpc_compact
from .cuda.slot_compact import slot_compact_counts, slot_compact_counts_plain
from .hpc import hpc_compress_packed


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """Static configuration of the pipeline.

    The fields, and the rules for validation, ``bound``,
    ``strict_threshold``, ``is_hpc`` and ``capacity_for``, mirror the
    reference package's ``PipelineSpec``: ``hash_width`` is 16, 32 or 64
    (SIMD modes are u32 only), ``variant`` is "nthash1" or "nthash2" (u32
    only; 31-bit hashes with halved bounds).  Its TPU-only fields have no
    counterpart: ``compaction`` (the device decides) and ``slots`` /
    ``rows_out`` (per-row and per-block survivor capacities), which the
    single per-tile capacity ``tile_cap`` replaces.

    ``max_minimizers`` is the capacity M of the compacted minimizer stream
    per read (None = derived from the density and length); survivors past
    it are dropped and show in ``KminmerBatch.n_minimizers_raw``.
    ``tile_cap`` is the survivor slots per K1 tile: None derives it from the
    density, 0 is the lossless maximum (the tile size).  It has no effect
    on the general path, whose only capacity is M.
    """

    l: int
    k: int
    density: float
    mode: str = "regular"
    max_minimizers: Optional[int] = None
    tile_cap: Optional[int] = None
    hash_width: int = 32
    variant: str = "nthash1"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.l < 1 or self.k < 1:
            raise ValueError("l and k must be >= 1")
        if self.tile_cap is not None and self.tile_cap < 0:
            raise ValueError(f"tile_cap={self.tile_cap} must be >= 0")
        if self.hash_width not in (16, 32, 64):
            raise ValueError(f"hash_width must be 16/32/64, got {self.hash_width}")
        if self.hash_width != 32 and self.mode in ("simd", "hpcsimd"):
            raise ValueError("SIMD modes require hash_width=32")
        if self.variant not in ("nthash1", "nthash2"):
            raise ValueError(f"unknown variant {self.variant!r}")
        if self.variant == "nthash2" and self.hash_width != 32:
            raise ValueError("nthash2 variant is 32-bit-lane only")

    @property
    def strict_threshold(self) -> bool:
        # SIMD paths compare with `<`, scalar paths with `<=`.
        return self.mode in ("simd", "hpcsimd")

    @property
    def bound(self) -> int:
        if self.variant == "nthash2":  # 31-bit hash space: halved bounds
            if self.strict_threshold:
                return hash_bound_nthash2_31(self.density)
            return hash_bound_u32(self.density) // 2
        if self.strict_threshold:
            return hash_bound_simd_u32(self.density)
        if self.hash_width != 32:
            return hash_bound(self.density, self.hash_width)
        return hash_bound_u32(self.density)

    @property
    def is_hpc(self) -> bool:
        return self.mode in ("hpc", "hpcsimd")

    @property
    def fused(self) -> bool:
        """The route: the fused path iff K1's carry covers l."""
        return 2 <= self.l <= MAX_L

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
    min_hash: torch.Tensor  # int32[B, M] (the low words at hash_width 64)
    min_hash_hi: torch.Tensor  # int32[B, M], zeros unless hash_width 64
    min_start: torch.Tensor  # int32[B, M]
    min_end: torch.Tensor  # int32[B, M]
    n_minimizers: torch.Tensor  # int32[B] (clipped to M)
    n_minimizers_raw: torch.Tensor  # int32[B] (unclipped; > n_minimizers = loss)


class _Stages(NamedTuple):
    scan: object  # K1
    stitch: object  # K2
    hpc: object  # K4's HPC form
    general: object  # the general scan
    assemble: object  # K3


_KERNELS = _Stages(fused_minimizer_scan, slot_compact_counts, hpc_compact,
                   general_minimizers, assemble_masked_cuda)
_PLAIN = _Stages(fused_scan_plain, slot_compact_counts_plain, hpc_compress_packed,
                 general_minimizers_plain, assemble_masked_plain)


def kminmer_pipeline(
    codes: torch.Tensor, lengths: torch.Tensor, spec: PipelineSpec
) -> KminmerBatch:
    """codes: uint8[B, L] xcodes (XCODE_PAD past each length), lengths:
    int32[B], both on one device."""
    return _pipeline(codes, lengths, spec, _KERNELS)


def kminmer_pipeline_plain(
    codes: torch.Tensor, lengths: torch.Tensor, spec: PipelineSpec
) -> KminmerBatch:
    """The same pipeline through the plain version of every stage, on the
    inputs' device."""
    return _pipeline(codes, lengths, spec, _PLAIN)


def _pipeline(codes, lengths, spec, stages) -> KminmerBatch:
    B, L = codes.shape
    if L < spec.l + 1:
        raise ValueError(f"padded length {L} must exceed l={spec.l}")
    lengths = lengths.to(torch.int32)
    m_cap = spec.capacity_for(L)
    if m_cap < spec.k:
        raise ValueError(f"minimizer capacity {m_cap} < k={spec.k}")
    route = _fused_minimizers if spec.fused else _general_minimizers
    min_start, min_end, min_hash, min_hash_hi, n_min, n_raw = route(
        codes, lengths, spec, stages, m_cap
    )
    return _assemble(spec, stages, min_start, min_end, min_hash, min_hash_hi, n_min, n_raw)


def _fused_minimizers(codes, lengths, spec, stages, m_cap):
    """K1 -> K2: the minimizer stream [B, m_cap], zero past the count."""
    l = spec.l
    # Largest window-start rank per read; no window unless length > l.  In
    # the HPC modes the kept stream itself ends each read, so only the
    # length gate is left.
    none = torch.full_like(lengths, -1)
    if spec.is_hpc:
        limit = torch.where(lengths > l, torch.full_like(lengths, 1 << 30), none)
    else:
        limit = torch.where(lengths > l, lengths - l, none)

    st, en, hs, counts = stages.scan(
        codes, lengths, limit, l, spec.bound, spec.strict_threshold,
        spec.is_hpc, spec.mode == "hpc", TILE, spec.cap_per_tile(TILE),
        spec.hash_width, spec.variant,
    )
    (min_start, min_end, min_hash), n_min, n_raw = stages.stitch(st, en, hs, counts, m_cap)
    min_hash_hi, min_hash = min_hash if isinstance(min_hash, tuple) else (None, min_hash)
    return min_start, min_end, min_hash, min_hash_hi, n_min, n_raw


def _general_minimizers(codes, lengths, spec, stages, m_cap):
    """(hpc modes) K4's HPC form, then the general scan: the minimizer
    stream [B, m_cap], zero past the count."""
    if spec.is_hpc:
        stream, eff_len = stages.hpc(codes, lengths)
    else:
        stream, eff_len = codes, lengths
    return stages.general(
        stream, eff_len, lengths, spec.l, spec.bound, spec.strict_threshold,
        spec.mode, spec.hash_width, spec.variant, m_cap,
    )


class CompiledPipeline:
    """``make_pipeline(spec)``: ``fn(codes, lengths) -> KminmerBatch``, the
    counterpart of the reference's jitted pipeline.

    On CUDA tensors each key (device, codes shape and dtype, lengths
    shape) gets one captured graph of ``kminmer_pipeline``
    (``ops/cuda/graph.py``), captured on the key's first call, as jit
    compiles on a shape's first call, and replayed on every call;
    ``capture`` captures a key ahead of its first call.  ``lengths`` of
    another integer dtype are cast to int32 first, as the reference's
    caller does.  A call reads its inputs when it is called and returns a
    new batch that later calls leave alone; its 12 fields are bit for bit
    those of ``kminmer_pipeline``.  On CPU tensors it is
    ``kminmer_pipeline``.  Calls are serialised by a lock.  ``graphs``
    holds the captured steps; dropping the object frees their memory
    pools."""

    def __init__(self, spec: PipelineSpec):
        self.spec = spec
        self.graphs: dict = {}
        self._lock = threading.Lock()

    def __call__(self, codes: torch.Tensor, lengths: torch.Tensor) -> KminmerBatch:
        if codes.device.type != "cuda":
            return kminmer_pipeline(codes, lengths, self.spec)
        if lengths.dtype != torch.int32:
            lengths = lengths.to(torch.int32)
        with self._lock:
            return KminmerBatch(*self._step(codes, lengths)(codes, lengths))

    def capture(self, codes: torch.Tensor, lengths: torch.Tensor) -> None:
        """Capture the graph for the key of these CUDA inputs now, unless it
        exists: ahead of a run whose threads must not meet a capture."""
        with self._lock:
            self._step(codes, lengths.to(torch.int32))

    def _step(self, codes, lengths) -> CapturedStep:
        key = (codes.device, tuple(codes.shape), codes.dtype, tuple(lengths.shape))
        step = self.graphs.get(key)
        if step is None:
            step = self.graphs[key] = CapturedStep(
                functools.partial(kminmer_pipeline, spec=self.spec), (codes, lengths),
                codes.device,
            )
        return step


def make_pipeline(spec: PipelineSpec) -> CompiledPipeline:
    """-> fn(codes uint8[B, L], lengths int32[B]) -> KminmerBatch: the
    pipeline for ``spec``, one captured CUDA graph per input shape on the
    card (``CompiledPipeline``)."""
    return CompiledPipeline(spec)


def _assemble(spec, stages, min_start, min_end, min_hash, min_hash_hi, n_min, n_raw):
    """K3: the k-min-mer fields, zero past each read's count."""
    hash_hi, hash_lo, start, end, rev, n_km = stages.assemble(
        min_hash, spec.k, spec.hash_width, min_hash_hi, n_min, min_start, min_end
    )
    return KminmerBatch(
        hash_hi=hash_hi,
        hash_lo=hash_lo,
        start=start,
        end=end,
        rev=rev,
        n_kminmers=n_km,
        min_hash=min_hash,
        min_hash_hi=torch.zeros_like(min_hash) if min_hash_hi is None else min_hash_hi,
        min_start=min_start,
        min_end=min_end,
        n_minimizers=n_min,
        n_minimizers_raw=n_raw,
    )
