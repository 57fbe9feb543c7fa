"""User-facing API: one sequence in, its k-min-mer records out.

``KminmersIterator(seq, l, k, density, mode)`` and ``kminmers_list``
mirror the reference package's surface (``hash_width``, ``variant``,
``strict_limits``, ``backend``); with ``backend="torch"`` (the default) a
single read is padded to a power-of-two length and run through the
batched pipeline on ``device`` (text is encoded there, ``ops/cuda/xcode.py``),
and with ``backend="oracle"`` through the
numpy oracle (``oracle.py``, the semantic specification) on the host.
``kminmers_batch`` adds the overflow rescue to the compiled pipeline
(``make_pipeline``, cached per spec as the reference caches its jitted
pipelines); ``precompile_rescue`` captures the rescue's step ahead of a
run.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterator, List

import numpy as np
import torch

from . import tracing
from .constants import MODES, XCODE_PAD, byte_view, family_of_mode
from .oracle import HashMode, KminmerRecord
from .oracle import kminmers as oracle_kminmers
from .ops.cuda.xcode import encode_xcodes_cuda
from .ops.pipeline import PipelineSpec, make_pipeline
from .ops.xcode import READ_START
from .ops.u64 import to_py_u64

# Reference limits: the SIMD paths assert l <= 31, where 32-bit NtHash1
# stops being a rolling hash of distinct rotations; the scalar HPC path
# takes l < 256.  Both hold only for nthash1 under strict_limits.
MAX_L_SIMD = 31
MAX_L_HPC = 255
BACKENDS = ("torch", "oracle")


class KSizeTooBig(ValueError):
    """l is past the reference's limit for the mode."""


def _mode_name(mode) -> str:
    """A mode string, or an enum whose value is one (the reference's
    HashMode); any other mode raises ValueError, as HashMode(...) does in
    the reference."""
    name = str(getattr(mode, "value", mode)).lower()
    if name not in MODES:
        raise ValueError(f"{mode!r} is not a valid mode: one of {MODES}")
    return name


def _bucket_length(n: int) -> int:
    """Pad single reads to a small set of lengths."""
    b = 256
    while b < n + 1:
        b *= 2
    return b


@functools.lru_cache(maxsize=64)
def _cached_pipeline(spec: PipelineSpec):
    """The compiled pipeline of a spec, shared by every caller; one that
    the cache drops frees its graphs' memory pools."""
    return make_pipeline(spec)


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


def precompile_rescue(spec: PipelineSpec, batch_shape, device="cuda") -> None:
    """Capture the rescue's step (``rescue_spec(spec)``) for a (B, L) batch
    on ``device`` now, so that a later overflow replays a graph instead of
    capturing one mid-stream.  Cheap to repeat: the pipeline and its graph
    are cached.  On the CPU it runs the step once, as the reference runs
    its jitted step there."""
    B, L = batch_shape
    device = _device(device)
    fn = _cached_pipeline(rescue_spec(spec))
    codes = torch.zeros((B, L), dtype=torch.uint8, device=device)
    lengths = torch.zeros((B,), dtype=torch.int32, device=device)
    if device.type == "cuda":
        fn.capture(codes, lengths)
    else:
        fn(codes, lengths)


def kminmers_batch(codes, lengths, spec: PipelineSpec, max_retries: int = 8):
    """The compiled pipeline (``_cached_pipeline``) with overflow rescue.
    A read whose raw selected count exceeds its kept count lost survivors
    to a tile's or the stream's capacity (on the general path, only to the
    stream's); the batch then reruns on ``rescue_spec``.  The overflow
    check's fetch is the host's, outside the graph.

    Returns a KminmerBatch whose n_minimizers == n_minimizers_raw.

    Spans (``tracing.py``): ``batch.call`` the call; under it, an attempt
    a ``batch.step`` (the compiled step), ``batch.wait`` (the first fetch,
    which waits for the card) and ``batch.check``, and ``batch.rescue``
    once a rerun."""
    with tracing.span("batch.call"):
        for _ in range(max_retries):
            with tracing.span("batch.step"):
                out = _cached_pipeline(spec)(codes, lengths)
            with tracing.span("batch.wait"):
                n_raw = out.n_minimizers_raw.cpu()
            with tracing.span("batch.check"):
                done = bool((out.n_minimizers.cpu() >= n_raw).all())
            if done:
                return out
            with tracing.span("batch.rescue"):
                spec = rescue_spec(spec, int(n_raw.max()))
        raise RuntimeError(
            f"minimizer overflow not resolved after {max_retries} retries"
        )


def run_single(seq, spec: PipelineSpec, device: torch.device):
    """One sequence (str, bytes-like text or an integer array of xcodes),
    padded to a power-of-two length, through ``kminmers_batch`` -> its
    one-row KminmerBatch, or None when it is too short for a window.  Text
    goes to ``device`` as its bytes and is encoded there."""
    xcodes = isinstance(seq, np.ndarray) and np.issubdtype(seq.dtype, np.integer)
    data = seq.astype(np.uint8, copy=False) if xcodes else byte_view(seq)
    n = len(data)
    if n <= spec.l:
        return None
    padded = np.full((1, _bucket_length(n)), XCODE_PAD, dtype=np.uint8)
    padded[0, :n] = data
    codes = torch.from_numpy(padded).to(device)
    lengths = torch.tensor([n], dtype=torch.int32, device=device)
    if not xcodes:
        start = torch.full((1,), READ_START, dtype=torch.int32, device=device)
        codes = encode_xcodes_cuda(codes, start, lengths, family_of_mode(spec.mode))
    return kminmers_batch(codes, lengths, spec)


def kminmers_list(
    seq, l: int, k: int, density: float, mode="regular", device="cuda",
    strict_limits: bool = True, hash_width: int = 32, variant: str = "nthash1",
    *, backend: str = "torch",
) -> List[KminmerRecord]:
    """All k-min-mers of one sequence, in order.  ``seq`` is str, bytes or
    a pre-encoded integer array of xcodes.  ``backend="torch"`` runs the
    pipeline on ``device``, which must exist: on a machine without a GPU,
    pass ``device="cpu"`` to run the plain versions.  ``backend="oracle"``
    runs the numpy oracle and ignores ``device``.  ``hash_width``
    (16/32/64) and ``variant`` ("nthash1", or "nthash2" for l > 31) select
    the minimizer hash; ``strict_limits`` raises KSizeTooBig past the
    reference's limits for nthash1, on either backend."""
    mode = _mode_name(mode)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: one of {BACKENDS}")
    if strict_limits and variant == "nthash1":
        if mode in ("simd", "hpcsimd") and l > MAX_L_SIMD:
            raise KSizeTooBig(f"l={l} exceeds {MAX_L_SIMD} for SIMD modes")
        if mode == "hpc" and l > MAX_L_HPC:
            raise KSizeTooBig(f"l={l} exceeds {MAX_L_HPC} for Hpc mode")
    if backend == "oracle":
        return oracle_kminmers(seq, l, k, density, HashMode(mode), hash_width, variant)
    device = _device(device)
    spec = PipelineSpec(
        l=l, k=k, density=density, mode=mode, hash_width=hash_width,
        variant=variant,
    )
    out = run_single(seq, spec, device)
    nk = 0 if out is None else int(out.n_kminmers[0])
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
        device="cuda", strict_limits: bool = True, hash_width: int = 32,
        variant: str = "nthash1", *, backend: str = "torch",
    ):
        self._records = kminmers_list(
            seq, l, k, density, mode, device, strict_limits=strict_limits,
            hash_width=hash_width, variant=variant, backend=backend,
        )

    def __iter__(self) -> Iterator[KminmerRecord]:
        return iter(self._records)

    def __len__(self) -> int:
        return len(self._records)

    def collect(self) -> List[KminmerRecord]:
        return list(self._records)
