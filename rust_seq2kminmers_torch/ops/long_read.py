"""Chunked long-read path: reads of up to 2^31 - 1 bases through K1 with
its carry, chunk by chunk, on one GPU.

A read is cut into ``chunk``-base pieces (a multiple of 1024).  Each chunk
is one step: K1 (``ops/cuda/fused_scan.py``) resumes from the carry of the
chunk before it (the global kept rank and the last l kept elements,
packed ``(pos << 3) | code`` with chunk-relative positions), then K2
compacts the chunk's survivors into its minimizer stream and returns the
chunk's counts; the slots past them are left unwritten, as phase D reads
only the valid prefixes.  The carry stays on the device from step to
step, and many reads ride the same ``[B, chunk]`` steps with a
``[B]``-shaped carry.  On the card the step is one captured CUDA graph
(``_compiled_chunk_step``, the counterpart of the reference's jitted
``_chunk_step``), replayed once a chunk.

The phases of a call:

  A. a producer thread stages chunk after chunk into pinned buffers
     (``_Staging``), each read as it came: its raw bytes (a str or a
     bytes-like object, read in place) or its xcodes (an integer array),
     while this thread copies each staged chunk to the device on a side
     stream, encodes the raw rows there (``ops/cuda/xcode.py``) and
     dispatches the chunk's step, with no host sync;
  B. one fetch of every chunk's counts;
  C. chunks that lost survivors (a tile's or the stream's capacity) rerun
     from their saved carry-in on ``api.rescue_spec``, staged the same
     way: every base of a tile may survive and M is raised to what the
     counts ask;
  D. the valid prefix of every chunk's stream is gathered on the device,
     read after read, into one flat stream.

K-min-mer assembly (K3) then runs on that device-resident stream, and
one copy into pinned memory brings back each record's start, end, hash
and rev; the host only adds each chunk's offset to the positions and
builds the dicts.  CUDA tensors launch the kernels; ``device="cpu"`` runs
their plain versions, through the same producer thread.  The reference is
``rust_seq2kminmers_tpu/ops/long_read.py``; this module mirrors its
functions, except that a read given as text is encoded on the device and
not on the host, the codes go to the device unpacked (see
``minimizer_stream_long_batch``) and the assembly runs on the flat stream
in one launch.
"""

from __future__ import annotations

import collections
import functools
import queue
import threading
from typing import Tuple

import numpy as np
import torch

from .. import tracing
from ..api import _device, rescue_spec
from ..constants import XCODE_PAD, byte_view, family_of_mode
from ..io import queues
from .cuda.assemble_kernel import assemble_kminmers_cuda
from .cuda.fused_scan import TILE, fused_minimizer_scan
from .cuda.graph import CompiledStep
from .cuda.slot_compact import slot_compact_counts
from .cuda.xcode import encode_xcodes_cuda
from .pipeline import PipelineSpec
from .xcode import READ_START, XCODE_ROW

# 32 Mbp a launch: K1's positions need chunk < 2^28, and the chunk's
# outputs stay well under a GiB of device memory.
DEFAULT_CHUNK = 1 << 25
MAX_READ = (1 << 31) - 1  # positions are int32 on the device
# The largest window-start rank in the hpc modes, where the kept stream
# itself ends each read.  (The reference uses 2^30, which drops windows
# of reads that keep more than 2^30 bases.)
HPC_LIMIT = (1 << 31) - 1
_STAGES = 3  # pinned staging buffers


def _chunk_step(spec: PipelineSpec, chunk: int):
    """The eager chunk step of ``spec`` -> ``step(codes uint8[B, chunk],
    length_local, limit, base0 int32[B], carry0 int32[B, l])`` -> (start,
    end, hash lo[, hash hi] int32[B, M], n_min, n_raw, base_next int32[B],
    carry_next int32[B, l]): K1 with carry in and out, then K2's compaction
    of the chunk's survivors into [B, M], valid up to n_min.

    The counts are outputs, not writes into a tensor of the caller's:
    captured, the step's inputs are copies (``ops/cuda/graph.py``), so a
    write into one would never reach the caller, and a chunk index passed
    in as a Python int would be frozen at its captured value."""
    l = spec.l
    cap, m_cap = spec.cap_per_tile(TILE), spec.capacity_for(chunk)

    def step(codes, length_local, limit, base0, carry0):
        st, en, hs, counts, carry_out = fused_minimizer_scan(
            codes, length_local, limit, l, spec.bound, spec.strict_threshold,
            spec.is_hpc, spec.mode == "hpc", TILE, cap, spec.hash_width,
            spec.variant, base0=base0, carry0=carry0, emit_carry=True,
        )
        (mst, men, mhs), n_min, n_raw = slot_compact_counts(
            st, en, hs, counts, m_cap, fill=False
        )
        base_next = base0 + counts[:, :, 2].sum(dim=1, dtype=torch.int32)
        # Rebase the carried positions to the next chunk's origin: on the
        # packed (pos << 3) | code a shift of position is a subtraction.
        carry_next = carry_out - (chunk << 3)
        hash_cols = (mhs[1], mhs[0]) if isinstance(mhs, tuple) else (mhs,)  # lo[, hi]
        return (mst, men, *hash_cols, n_min, n_raw, base_next, carry_next)

    return step


@functools.lru_cache(maxsize=8)
def _compiled_chunk_step(spec: PipelineSpec, chunk: int) -> CompiledStep:
    """``_chunk_step(spec, chunk)`` compiled: one captured CUDA graph per
    key (device, B; the chunk and l are fixed), cached per (spec, chunk)
    as ``api._cached_pipeline`` caches the pipeline; one the cache drops
    frees its graphs' memory pools.  Not used for CPU tensors."""
    return CompiledStep(_chunk_step(spec, chunk))


class _Staging:
    """The chunks of every read, padded with XCODE_PAD, staged by a
    producer thread ahead of the thread that dispatches them (``run``).

    A row is staged as it came: xcodes, or with ``raw[b]`` set, the read's
    raw bytes, which ``run`` encodes on the device (``family``'s table)
    before it hands the chunk on.  For each chunk the producer also writes
    each row's byte before the chunk (``READ_START`` at a read's start;
    ``XCODE_ROW`` for a row of xcodes, which the encode copies).

    On a GPU: ``_STAGES`` slots, each pinned host buffers and device
    buffers, allocated here, on the caller's thread.  The producer only
    fills a free slot's host buffers through numpy and makes no CUDA call:
    a graph capture (``capture_error_mode="global"``, ``ops/cuda/graph.py``)
    rejects CUDA calls from other threads.  The caller's thread copies the
    buffers to the slot's device buffers on a side stream, after the
    compute stream's last use of them, makes the compute stream wait for
    the copy, and hands the slot back to the producer only after the copy
    has completed.  On the CPU the producer fills new arrays a chunk.

    Spans (``tracing.py``), a chunk each: the producer's ``long.fill`` (a
    root of its thread in the caller's call), and on this thread
    ``long.hand_back``, ``long.wait_staged``, ``long.h2d_issue``,
    ``long.encode_issue`` and ``long.dispatch``."""

    def __init__(self, rows, chunk: int, device: torch.device, raw=None,
                 family: str = "scalar"):
        self.rows, self.chunk, self.device = rows, chunk, device
        self.lengths = np.array([int(r.shape[0]) for r in rows], dtype=np.int64)
        self.cuda = device.type == "cuda"
        B = len(rows)
        self.raw_rows = np.flatnonzero(np.zeros(B, bool) if raw is None else raw)
        self.family = family
        # Each row's length in each chunk, [nchunks, B], on the device.
        nchunks = -(-int(self.lengths.max(initial=0)) // chunk)
        local = np.clip(self.lengths[None, :] - chunk * np.arange(nchunks)[:, None], 0, chunk)
        self.local = torch.from_numpy(local.astype(np.int32)).to(device)
        if not self.cuda:
            return
        self.host = [torch.empty((B, chunk), dtype=torch.uint8, pin_memory=True)
                     for _ in range(_STAGES)]
        self.host_np = [h.numpy() for h in self.host]
        self.dev = [torch.empty((B, chunk), dtype=torch.uint8, device=device)
                    for _ in range(_STAGES)]
        self.prev = [torch.empty((B,), dtype=torch.int32, pin_memory=True)
                     for _ in range(_STAGES)]
        self.prev_np = [p.numpy() for p in self.prev]
        self.prev_dev = [torch.empty((B,), dtype=torch.int32, device=device)
                         for _ in range(_STAGES)]
        self.used = [None] * _STAGES  # event: compute's last read of dev[s]
        self.stream = torch.cuda.Stream(device)

    def _before(self, ci: int, out: np.ndarray) -> np.ndarray:
        """Each row's byte before chunk ci into ``out`` int32[B]."""
        lo = ci * self.chunk
        out[:] = XCODE_ROW
        for b in self.raw_rows:
            out[b] = self.rows[b][lo - 1] if 0 < lo <= self.lengths[b] else READ_START
        return out

    def _fill(self, ci: int, buf: np.ndarray) -> np.ndarray:
        """Chunk ci of every read into ``buf`` [B, chunk]: a read's bases,
        then XCODE_PAD; the reads that ended before the chunk in one
        assignment."""
        c, lo = self.chunk, ci * self.chunk
        local = np.clip(self.lengths - lo, 0, c)
        buf[local == 0] = XCODE_PAD
        for b in np.flatnonzero(local):
            n = int(local[b])
            buf[b, :n] = self.rows[b][lo : lo + n]
            buf[b, n:] = XCODE_PAD
        return buf

    def _produce(self, ids, free, ready, stop, call: int) -> None:
        """Fill chunk after chunk of ``ids`` into a free slot (GPU) or new
        arrays (CPU) and put (slot, buffer, bytes before) into ``ready``; an
        exception is put there instead, for the caller's thread to raise.
        ``call``: the caller's call id, under which the fills are spans."""
        try:
            for ci in ids:
                if free is None:
                    slot = None
                    buf = np.empty((len(self.rows), self.chunk), dtype=np.uint8)
                    before = np.empty(len(self.rows), dtype=np.int32)
                else:
                    slot = queues.get(free, stop)
                    if slot is None:
                        return  # stopped
                    buf, before = self.host_np[slot], self.prev_np[slot]
                with tracing.span("long.fill", call=call):
                    self._fill(ci, buf)
                    self._before(ci, before)
                if not queues.put(ready, (slot, buf, before), stop):
                    return
        except Exception as e:  # handed to the caller's thread, which raises it
            queues.put(ready, e, stop)

    def run(self, ids, dispatch) -> None:
        """``dispatch(ci, codes)`` on this thread for each chunk index of
        ``ids``, in order, with ``codes`` uint8[B, chunk] xcodes on the
        device (the raw rows encoded on the compute stream just before),
        while the producer stages the chunks after it.  The producer's
        exception is raised here; an exception here stops the producer,
        which is joined before ``run`` returns, on every path."""
        ids = [int(ci) for ci in ids]
        free = None
        if self.cuda:
            free = queue.Queue()
            for s in range(_STAGES):
                free.put(s)
            compute = torch.cuda.current_stream(self.device)
        ready: queue.Queue = queue.Queue(maxsize=_STAGES)
        stop = threading.Event()
        producer = threading.Thread(
            target=self._produce, args=(ids, free, ready, stop, tracing.current_call()),
            daemon=True,
        )
        pending: collections.deque = collections.deque()  # (copy event, slot)
        producer.start()
        try:
            for ci in ids:
                # Hand back the slots whose copies have completed; with every
                # slot here, wait for the oldest copy, or the producer starves.
                with tracing.span("long.hand_back"):
                    while pending and (len(pending) == _STAGES or pending[0][0].query()):
                        copied, s = pending.popleft()
                        copied.synchronize()
                        free.put(s)
                with tracing.span("long.wait_staged"):
                    item = self._next(ready, producer)
                if isinstance(item, Exception):
                    raise item
                slot, buf, before = item
                if not self.cuda:
                    with tracing.span("long.dispatch"):
                        dispatch(ci, self._encode(ci, torch.from_numpy(buf),
                                                  torch.from_numpy(before)))
                    continue
                with tracing.span("long.h2d_issue"):
                    with torch.cuda.stream(self.stream):
                        if self.used[slot] is not None:
                            self.stream.wait_event(self.used[slot])
                        self.dev[slot].copy_(self.host[slot], non_blocking=True)
                        if self.raw_rows.size:
                            self.prev_dev[slot].copy_(self.prev[slot], non_blocking=True)
                        copied = torch.cuda.Event()
                        copied.record(self.stream)
                    compute.wait_event(copied)
                    pending.append((copied, slot))
                with tracing.span("long.encode_issue"):
                    codes = self._encode(ci, self.dev[slot], self.prev_dev[slot])
                with tracing.span("long.dispatch"):
                    dispatch(ci, codes)
                    self.used[slot] = torch.cuda.Event()
                    self.used[slot].record(compute)
            with tracing.span("long.hand_back"):
                for copied, _ in pending:  # every slot free for the next run
                    copied.synchronize()
        finally:
            stop.set()
            producer.join()

    def _encode(self, ci: int, staged: torch.Tensor, before: torch.Tensor) -> torch.Tensor:
        """The staged chunk ci as xcodes: a batch with raw rows is encoded
        (one launch), one of xcodes only is handed on as it is."""
        if not self.raw_rows.size:
            return staged
        return encode_xcodes_cuda(staged, before, self.local[ci], self.family)

    @staticmethod
    def _next(ready: queue.Queue, producer: threading.Thread):
        """The producer's next item; a producer that ended without one
        (it always puts one: a chunk or its exception) raises."""
        while True:
            try:
                return ready.get(timeout=queues.POLL_S)
            except queue.Empty:
                if not producer.is_alive():
                    try:
                        return ready.get_nowait()
                    except queue.Empty:
                        raise RuntimeError("the staging thread ended early") from None


def _capture(step, B: int, chunk: int, l: int, limit: torch.Tensor) -> None:
    """Capture ``step``'s key for [B, chunk] now, on this thread, unless
    it exists: before a producer starts.  An eager step (the CPU's)
    captures nothing."""
    if isinstance(step, CompiledStep):
        zeros = functools.partial(torch.zeros, dtype=torch.int32, device=limit.device)
        step.capture(torch.zeros((B, chunk), dtype=torch.uint8, device=limit.device),
                     zeros(B), limit, zeros(B), zeros((B, l)))


def _rows(seqs):
    """-> (one uint8 array a read, which of them are raw bytes): an
    integer ndarray holds xcodes; a str, bytes, bytearray or memoryview
    is the read's text, viewed in place where it can be
    (``constants.byte_view``; a str outside latin-1 raises)."""
    rows, raw = [], []
    for s in seqs:
        xc = isinstance(s, np.ndarray) and np.issubdtype(s.dtype, np.integer)
        rows.append(s.astype(np.uint8, copy=False) if xc else byte_view(s))
        raw.append(not xc)
    return rows, raw


def _streams(seqs, spec: PipelineSpec, chunk: int, device: torch.device):
    """Phases A-D over the reads ``seqs`` (each text or xcodes, ``_rows``) -> None
    when no read is longer than l, else (flat, nm, chunk): flat int32[ncols,
    total] on ``device``, every read's valid minimizers, read after read
    and chunk after chunk, as rows start, end (positions in their chunk),
    hash lo[, hash hi]; nm int[nchunks, B] the counts; chunk rounded up to
    a multiple of 1024.  Spans: ``long.setup``, phase A's (``_Staging``),
    ``long.counts``, ``long.rescue`` and ``long.gather``."""
    with tracing.span("long.setup"):
        rows, raw = _rows(seqs)
        lengths = np.array([int(r.shape[0]) for r in rows], dtype=np.int64)
        B = len(rows)
        n_max = int(lengths.max(initial=0))
        if n_max > MAX_READ:
            raise ValueError(f"a read of {n_max} bases exceeds {MAX_READ}")
        if not spec.fused:
            raise ValueError(f"long reads need 2 <= l <= 255 (K1's carry), got l={spec.l}")
        l = spec.l
        if n_max <= l:
            return None
        chunk = -(-max(int(chunk), 1024) // 1024) * 1024
        nchunks = -(-n_max // chunk)
        limit_h = np.where(lengths > l, HPC_LIMIT if spec.is_hpc else lengths - l, -1)
        limit = torch.from_numpy(limit_h.astype(np.int32)).to(device)
        staging = _Staging(rows, chunk, device, raw, family_of_mode(spec.mode))
        local_d = staging.local  # [nchunks, B]
        step_for = _compiled_chunk_step if device.type == "cuda" else _chunk_step
        step = step_for(spec, chunk)
        _capture(step, B, chunk, l, limit)

    # Phase A: every chunk dispatched; the carry chains on the device.  The
    # carry comes from the kept stream, which no capacity clips, so a chunk
    # that overflowed can be rerun later from its saved carry-in.
    per_chunk = [None] * nchunks  # (stream columns, n_min, n_raw, carry-in)
    carry = (torch.zeros(B, dtype=torch.int32, device=device),
             torch.zeros((B, l), dtype=torch.int32, device=device))

    def dispatch(ci, codes):
        nonlocal carry
        *cols, n_min, n_raw, base, carry_next = step(codes, local_d[ci], limit, *carry)
        per_chunk[ci] = (cols, n_min, n_raw, carry)
        carry = (base, carry_next)

    staging.run(range(nchunks), dispatch)

    def fetch_counts(ids):
        return torch.stack([t for ci in ids for t in per_chunk[ci][1:3]]).view(
            len(ids), 2, B).cpu().numpy()

    # Phase B: one fetch of the counts.
    with tracing.span("long.counts"):
        counts = fetch_counts(range(nchunks))
        nm, nr = counts[:, 0].copy(), counts[:, 1]

    # Phase C: rerun the chunks that lost survivors, on the lossless tile
    # capacity with M raised to the largest raw count.
    bad = np.flatnonzero((nm < nr).any(axis=1))
    if bad.size:
        with tracing.span("long.rescue"):
            rstep = step_for(rescue_spec(spec, int(nr.max())), chunk)
            _capture(rstep, B, chunk, l, limit)

            def redo(ci, codes):
                *cols, n_min, n_raw, _, _ = rstep(codes, local_d[ci], limit,
                                                  *per_chunk[ci][3])
                per_chunk[ci] = (cols, n_min, n_raw, per_chunk[ci][3])

            staging.run(bad, redo)
            rch = fetch_counts(bad)
            for i, ci in enumerate(bad):
                if (rch[i, 0] < rch[i, 1]).any():
                    raise RuntimeError(
                        f"chunk {ci} overflow not resolved ({rch[i, 0]} < {rch[i, 1]})"
                    )
                nm[ci] = rch[i, 0]

    # Phase D: the valid prefixes only, gathered on the device.
    with tracing.span("long.gather"):
        ncols = 4 if spec.hash_width == 64 else 3
        pieces = [
            per_chunk[ci][0][col][b, : int(nm[ci, b])]
            for col in range(ncols) for b in range(B) for ci in range(nchunks)
            if nm[ci, b]
        ]
        total = int(nm.sum())
        flat = (torch.cat(pieces) if pieces
                else torch.zeros(0, dtype=torch.int32, device=device)).view(ncols, total)
    return flat, nm, chunk


_NUMPY = {torch.int64: np.int64, torch.int32: np.int32, torch.bool: np.bool_}


def _fetch(tensors) -> list:
    """The tensors on the host in one copy: their bytes concatenated on
    the device (widest elements first keeps every view aligned), copied
    into pinned memory from a GPU and waited for -> numpy views of that
    one buffer, in order."""
    flat = torch.cat([t.contiguous().view(-1).view(torch.uint8) for t in tensors])
    if flat.device.type == "cuda":
        host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(flat.device))
        done.synchronize()
        flat = host
    raw, out, at = flat.numpy(), [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        out.append(raw[at : at + n].view(_NUMPY[t.dtype]).reshape(t.shape))
        at += n
    return out


def _origins(nm: np.ndarray, chunk: int, device) -> torch.Tensor:
    """int64[total] on the device: the origin (first base) of the chunk of
    each element of the flat stream (read after read, chunk after chunk),
    to add to its chunk-relative positions."""
    nchunks, B = nm.shape
    origins = np.tile(np.arange(nchunks, dtype=np.int64) * chunk, B)
    return torch.repeat_interleave(
        torch.from_numpy(origins).to(device),
        torch.from_numpy(nm.T.reshape(-1).astype(np.int64)).to(device),
        output_size=int(nm.sum()),
    )


def _words64(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """int64 bit patterns of the u64 values (hi << 32) | lo, from int32
    words: the two words side by side, little-endian, no arithmetic."""
    return torch.stack([lo, hi], dim=-1).view(torch.int64).squeeze(-1)


def _reads(nm: np.ndarray):
    """-> (first, stop) of each read's elements in the flat stream."""
    ends = np.cumsum(nm.sum(axis=0))
    return list(zip((ends - nm.sum(axis=0)).tolist(), ends.tolist()))


def minimizer_stream_long_batch(
    rows,  # one read each: str / bytes-like text, or an integer array of xcodes
    spec: PipelineSpec,
    chunk: int = DEFAULT_CHUNK,
    device="cuda",
):
    """-> list of (start int64, end int64, hash) numpy triples, one per
    read: its whole ordered minimizer stream, positions in the read.  The
    hash is uint16, uint32 or uint64 by ``spec.hash_width``.  The bytes go
    to the device one a base, as they are (text is encoded there): packing
    two a byte on the host cost more time than the halved copy saved."""
    device = _device(device)
    hdt = {16: np.uint16, 32: np.uint32, 64: np.uint64}[spec.hash_width]
    found = _streams(rows, spec, chunk, device)
    if found is None:
        empty = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, hdt))
        return [empty] * len(rows)
    flat, nm, chunk = found
    origin = _origins(nm, chunk, device)
    wide = spec.hash_width == 64
    start, end, h = _fetch([flat[0] + origin, flat[1] + origin,
                            _words64(flat[2], flat[3]) if wide else flat[2]])
    h = h.view(np.uint64 if wide else np.uint32)
    return [(start[a:z].copy(), end[a:z].copy(), h[a:z].astype(hdt)) for a, z in _reads(nm)]


def minimizer_stream_long(
    codes,  # ONE read: str / bytes-like text, or an integer array of xcodes
    spec: PipelineSpec,
    chunk: int = DEFAULT_CHUNK,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (start, end, hash) numpy arrays of the whole ordered minimizer
    stream of one long read (positions in the read)."""
    return minimizer_stream_long_batch([codes], spec, chunk=chunk, device=device)[0]


def assemble_stream(
    min_hash: np.ndarray,  # uint16/32/64[M] minimizer hashes, in order
    k: int,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """K3 over a whole minimizer stream -> (hash uint64[M-k+1], rev
    bool[M-k+1]); the mix to u64 follows the dtype (murmur, xorshift,
    identity).  K3 has no size limit, so the stream is one [1, M] row
    (the reference cuts it into tiles overlapping by k-1; a window's hash
    depends only on its own elements, so the result is the same)."""
    M = int(min_hash.shape[0])
    if M - k + 1 <= 0:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=bool)
    width = {np.dtype(np.uint16): 16, np.dtype(np.uint32): 32,
             np.dtype(np.uint64): 64}[min_hash.dtype]
    device = _device(device)
    row = min_hash.astype(np.uint64)[None, :]

    def word(x):
        return torch.from_numpy(x.astype(np.uint32).view(np.int32)).to(device)

    lo = word(row & np.uint64(0xFFFFFFFF))
    hi = word(row >> np.uint64(32)) if width == 64 else None
    (khi, klo), rev = assemble_kminmers_cuda(lo, k, width, hi)
    h = (khi[0].cpu().numpy().view(np.uint32).astype(np.uint64) << np.uint64(32)) | (
        klo[0].cpu().numpy().view(np.uint32)
    )
    return h, rev[0].cpu().numpy()


def _no_records() -> dict:
    return {
        "hash": np.zeros(0, np.uint64),
        "start": np.zeros(0, np.int64),
        "end": np.zeros(0, np.int64),
        "offset": np.zeros(0, np.int64),
        "rev": np.zeros(0, bool),
    }


def _records(seqs, spec: PipelineSpec, chunk: int, device: torch.device) -> list:
    """One records dict per read of ``seqs``: phases A-D, then K3 on the
    device-resident flat stream in one launch (the windows that straddle
    two reads are computed and dropped: a window's hash depends only on
    its own elements), then one pinned fetch of each window's start, end,
    hash (hi, lo) and rev.  Spans: ``long.call`` the call; under it
    ``_streams``'s, ``long.assemble``, ``long.fetch`` and ``long.records``."""
    with tracing.span("long.call"):
        found = _streams(seqs, spec, chunk, device)
        k = spec.k
        if found is None or found[0].shape[1] < k:
            return [_no_records() for _ in seqs]
        flat, nm, chunk = found
        with tracing.span("long.assemble"):
            nwin = flat.shape[1] - k + 1
            hi = flat[3:4] if spec.hash_width == 64 else None
            (khi, klo), rev = assemble_kminmers_cuda(flat[2:3], k, spec.hash_width, hi)
            # Window w: the hash and rev of minimizers w..w+k-1, the start of
            # minimizer w and the end of minimizer w + k - 1, in the read.
            origin = _origins(nm, chunk, device)
            cols = [_words64(klo[0], khi[0]), flat[0, :nwin] + origin[:nwin],
                    flat[1, k - 1 :] + origin[k - 1 :], rev[0]]
        with tracing.span("long.fetch"):
            h, start, end, rev = _fetch(cols)
        with tracing.span("long.records"):
            out = []
            for a, z in _reads(nm):
                nk = max(z - a - (k - 1), 0)
                w = slice(a, a + nk)
                out.append({
                    "hash": h[w].view(np.uint64).copy(),
                    "start": start[w].copy(),
                    "end": end[w].copy(),
                    "offset": np.arange(nk, dtype=np.int64),
                    "rev": rev[w].copy(),
                })
        return out


def kminmers_long(
    seq,
    l: int,
    k: int,
    density: float,
    mode: str = "regular",
    variant: str = "nthash1",
    chunk: int = DEFAULT_CHUNK,
    device="cuda",
    hash_width: int = 32,
) -> dict:
    """All k-min-mers of ONE long read as a struct-of-arrays dict {hash
    uint64, start, end, offset int64, rev bool}[n_kminmers], for reads
    past one launch's length cap (up to 2^31 - 1 bases).  ``seq`` is str,
    bytes or an integer array of xcodes; text is encoded on ``device``."""
    return kminmers_long_batch(
        [seq], l, k, density, mode=mode, variant=variant, chunk=chunk, device=device,
        hash_width=hash_width,
    )[0]


def kminmers_long_batch(
    seqs,
    l: int,
    k: int,
    density: float,
    mode: str = "regular",
    variant: str = "nthash1",
    chunk: int = DEFAULT_CHUNK,
    device="cuda",
    hash_width: int = 32,
) -> list:
    """kminmers_long over many reads at once: all ride the same [B, chunk]
    launches.  One dict per read, each equal to its kminmers_long run."""
    spec = PipelineSpec(
        l=l, k=k, density=density, mode=mode, variant=variant, hash_width=hash_width,
    )
    return _records(list(seqs), spec, chunk, _device(device))
