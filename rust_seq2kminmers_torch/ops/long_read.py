"""Chunked long-read path: reads of up to 2^31 - 1 bases through K1 with
its carry, chunk by chunk, on one GPU.

A read is cut into ``chunk``-base pieces (a multiple of 1024).  Each chunk
is one K1 launch (``ops/cuda/fused_scan.py``) that resumes from the carry
of the chunk before it: the global kept rank and the last l kept elements,
packed ``(pos << 3) | code`` with chunk-relative positions.  K2 then
compacts the chunk's survivors into its minimizer stream, and writes the
chunk's counts into a device tensor; the slots past them are left
unwritten, as phase D reads only the valid prefixes.  The carry stays
on the device from launch to launch, and many reads ride the same
``[B, chunk]`` launches with a ``[B]``-shaped carry.

The phases of ``minimizer_stream_long_batch``:

  A. every chunk is staged on the host into pinned buffers, copied to
     the device on a side stream and dispatched, with no host sync; K2
     writes each chunk's (n_min, n_raw) into one device tensor;
  B. one fetch of those counts;
  C. chunks that lost survivors (a tile's or the stream's capacity) rerun
     from their saved carry-in on ``api.rescue_spec``: every base of a tile
     may survive and M is raised to what the counts ask;
  D. the valid prefix of every chunk's stream is gathered on the device
     and fetched in one copy.

K-min-mer assembly (K3) then runs over each read's whole minimizer stream.
CUDA tensors launch the kernels; ``device="cpu"`` runs their plain
versions.  The reference is ``rust_seq2kminmers_tpu/ops/long_read.py``;
this module mirrors it function for function, except that the codes go
to the device unpacked (see ``minimizer_stream_long_batch``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..api import _device, rescue_spec
from ..constants import XCODE_PAD, encode_xcodes, family_of_mode
from .cuda.assemble_kernel import assemble_kminmers_cuda
from .cuda.fused_scan import TILE, fused_minimizer_scan
from .cuda.slot_compact import slot_compact_counts
from .pipeline import PipelineSpec

# 32 Mbp a launch: K1's positions need chunk < 2^28, and the chunk's
# outputs stay well under a GiB of device memory.
DEFAULT_CHUNK = 1 << 25
MAX_READ = (1 << 31) - 1  # positions are int32 on the device
# The largest window-start rank in the hpc modes, where the kept stream
# itself ends each read.  (The reference uses 2^30, which drops windows
# of reads that keep more than 2^30 bases.)
HPC_LIMIT = (1 << 31) - 1
_STAGES = 3  # pinned staging buffers in flight


def _chunk_step(spec: PipelineSpec, chunk: int, cap: int, m_cap: int):
    """One chunk: K1 with carry in and out, then K2's compaction of the
    chunk's survivors into [B, m_cap], valid up to n_min.  K2 writes
    (n_min, n_raw) into ``cacc[ci]`` (cacc int32[nchunks, 2, B] on the
    device), so the host never waits inside the chunk loop."""
    l = spec.l

    def step(codes, length_local, limit, base0, carry0, cacc, ci):
        st, en, hs, counts, carry_out = fused_minimizer_scan(
            codes, length_local, limit, l, spec.bound, spec.strict_threshold,
            spec.is_hpc, spec.mode == "hpc", TILE, cap, spec.hash_width,
            spec.variant, base0=base0, carry0=carry0, emit_carry=True,
        )
        (mst, men, mhs), _, _ = slot_compact_counts(
            st, en, hs, counts, m_cap, fill=False, n_min=cacc[ci, 0], n_raw=cacc[ci, 1]
        )
        base_next = base0 + counts[:, :, 2].sum(dim=1, dtype=torch.int32)
        # Rebase the carried positions to the next chunk's origin: on the
        # packed (pos << 3) | code a shift of position is a subtraction.
        carry_next = carry_out - (chunk << 3)
        return mst, men, mhs, base_next, carry_next

    return step


class _Staging:
    """Chunk ci of every read, padded with XCODE_PAD, on the device.

    On a GPU: staged into one of ``_STAGES`` pinned host buffers and copied
    to a matching device buffer on a side stream.  A pinned buffer is
    restaged only after its last copy completed, a device buffer is
    rewritten only after the compute stream's last use of it, and the
    compute stream waits for each copy.  On the CPU: a fresh tensor."""

    def __init__(self, rows, chunk: int, device: torch.device):
        self.rows, self.chunk, self.device = rows, chunk, device
        self.cuda = device.type == "cuda"
        if not self.cuda:
            return
        B = len(rows)
        self.host = [torch.empty((B, chunk), dtype=torch.uint8, pin_memory=True)
                     for _ in range(_STAGES)]
        self.dev = [torch.empty((B, chunk), dtype=torch.uint8, device=device)
                    for _ in range(_STAGES)]
        self.copied = [None] * _STAGES  # event: H2D copy out of host[s] done
        self.used = [None] * _STAGES  # event: compute's last read of dev[s]
        self.stream = torch.cuda.Stream(device)

    def _fill(self, ci: int, buf: np.ndarray) -> np.ndarray:
        c = self.chunk
        for b, row in enumerate(self.rows):
            part = row[ci * c : (ci + 1) * c]
            buf[b, : part.shape[0]] = part
            buf[b, part.shape[0] :] = XCODE_PAD
        return buf

    def host_array(self, ci: int) -> np.ndarray:
        """A private host array of chunk ci."""
        return self._fill(ci, np.empty((len(self.rows), self.chunk), dtype=np.uint8))

    def upload(self, ci: int) -> torch.Tensor:
        if not self.cuda:
            return torch.from_numpy(self.host_array(ci))
        s = ci % _STAGES
        if self.copied[s] is not None:
            self.copied[s].synchronize()
        self._fill(ci, self.host[s].numpy())
        with torch.cuda.stream(self.stream):
            if self.used[s] is not None:
                self.stream.wait_event(self.used[s])
            self.dev[s].copy_(self.host[s], non_blocking=True)
            self.copied[s] = torch.cuda.Event()
            self.copied[s].record(self.stream)
        torch.cuda.current_stream(self.device).wait_event(self.copied[s])
        return self.dev[s]

    def release(self, ci: int) -> None:
        """Every use of chunk ci's device buffer has been enqueued."""
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self.used[ci % _STAGES] = ev


def minimizer_stream_long_batch(
    rows,  # sequence of uint8[n_b] xcode arrays (one per read)
    spec: PipelineSpec,
    chunk: int = DEFAULT_CHUNK,
    device="cuda",
):
    """-> list of (start int64, end int64, hash) numpy triples, one per
    read: its whole ordered minimizer stream, positions in the read.  The
    hash is uint16, uint32 or uint64 by ``spec.hash_width``.  The codes go
    to the device one byte a base, as they are: packing two a byte on the
    host cost more time than the halved copy saved."""
    device = _device(device)
    lengths = np.array([int(r.shape[0]) for r in rows], dtype=np.int64)
    B = len(rows)
    n_max = int(lengths.max(initial=0))
    if n_max > MAX_READ:
        raise ValueError(f"a read of {n_max} bases exceeds {MAX_READ}")
    if not spec.fused:
        raise ValueError(f"long reads need 2 <= l <= 255 (K1's carry), got l={spec.l}")
    l = spec.l
    wide = spec.hash_width == 64
    hdt = {16: np.uint16, 32: np.uint32, 64: np.uint64}[spec.hash_width]
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, hdt))
    if n_max <= l:
        return [empty] * B
    chunk = -(-max(int(chunk), 1024) // 1024) * 1024
    nchunks = -(-n_max // chunk)
    limit_h = np.where(lengths > l, HPC_LIMIT if spec.is_hpc else lengths - l, -1)
    local = np.clip(lengths[None, :] - chunk * np.arange(nchunks)[:, None], 0, chunk)
    local_d = torch.from_numpy(local.astype(np.int32)).to(device)  # [nchunks, B]
    limit = torch.from_numpy(limit_h.astype(np.int32)).to(device)
    m_cap = spec.capacity_for(chunk)
    step = _chunk_step(spec, chunk, spec.cap_per_tile(TILE), m_cap)

    # Phase A: every chunk dispatched; the carry chains on the device.  The
    # carry comes from the kept stream, which no capacity clips, so a chunk
    # that overflowed can be rerun later from its saved carry-in.
    base = torch.zeros(B, dtype=torch.int32, device=device)
    carry = torch.zeros((B, l), dtype=torch.int32, device=device)
    cacc = torch.empty((nchunks, 2, B), dtype=torch.int32, device=device)
    staging = _Staging(rows, chunk, device)
    per_chunk = []
    for ci in range(nchunks):
        carry_in = (base, carry)
        mst, men, mhs, base, carry = step(
            staging.upload(ci), local_d[ci], limit, base, carry, cacc, ci
        )
        staging.release(ci)
        per_chunk.append([mst, men, mhs, carry_in])

    # Phase B: one fetch of the counts.
    counts = cacc.cpu().numpy()
    nm, nr = counts[:, 0].copy(), counts[:, 1]

    # Phase C: rerun the chunks that lost survivors, on the lossless tile
    # capacity with M raised to the largest raw count.
    bad = np.flatnonzero((nm < nr).any(axis=1))
    if bad.size:
        rspec = rescue_spec(spec, int(nr.max()))
        rstep = _chunk_step(
            rspec, chunk, rspec.cap_per_tile(TILE), rspec.capacity_for(chunk)
        )
        rcacc = torch.empty_like(cacc)
        for ci in bad:
            b0, c0 = per_chunk[ci][3]
            codes = torch.from_numpy(staging.host_array(int(ci))).to(device)
            per_chunk[ci][:3] = rstep(codes, local_d[ci], limit, b0, c0, rcacc, int(ci))[:3]
        rch = rcacc.cpu().numpy()
        for ci in bad:
            if (rch[ci, 0] < rch[ci, 1]).any():
                raise RuntimeError(
                    f"chunk {ci} overflow not resolved ({rch[ci, 0]} < {rch[ci, 1]})"
                )
            nm[ci] = rch[ci, 0]

    # Phase D: the valid prefixes only, gathered on the device, one copy.
    def columns(c):
        mst, men, mhs = c[:3]
        return [mst, men, *(reversed(mhs) if wide else (mhs,))]  # hash: lo, hi

    ncols = 4 if wide else 3
    pieces = [
        columns(per_chunk[ci])[col][b, : int(nm[ci, b])]
        for col in range(ncols) for b in range(B) for ci in range(nchunks)
        if nm[ci, b]
    ]
    total = int(nm.sum())
    flat = (torch.cat(pieces).cpu().numpy() if pieces
            else np.zeros(0, np.int32)).reshape(ncols, total)
    out = []
    ends = np.cumsum(nm.sum(axis=0))
    for b in range(B):
        seg = flat[:, ends[b] - nm[:, b].sum() : ends[b]]
        off = np.repeat(np.arange(nchunks, dtype=np.int64) * chunk, nm[:, b])
        h = seg[2].view(np.uint32)
        if wide:
            h = (seg[3].view(np.uint32).astype(np.uint64) << np.uint64(32)) | h
        out.append((seg[0] + off, seg[1] + off, h.astype(hdt)))
    return out


def minimizer_stream_long(
    codes: np.ndarray,  # uint8[n] xcodes of ONE read
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


def _xcodes(seq, mode: str) -> np.ndarray:
    if isinstance(seq, np.ndarray) and np.issubdtype(seq.dtype, np.integer):
        return seq.astype(np.uint8, copy=False)
    return encode_xcodes(seq, family_of_mode(mode))


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
    bytes or an integer array of xcodes."""
    spec = PipelineSpec(
        l=l, k=k, density=density, mode=mode, variant=variant, hash_width=hash_width,
    )
    start, end, mhash = minimizer_stream_long(
        _xcodes(seq, mode), spec, chunk=chunk, device=device
    )
    return _records_from_stream(start, end, mhash, k, device)


def _records_from_stream(start, end, mhash, k, device):
    nk = max(int(mhash.shape[0]) - (k - 1), 0)
    if nk == 0:
        return {
            "hash": np.zeros(0, np.uint64),
            "start": np.zeros(0, np.int64),
            "end": np.zeros(0, np.int64),
            "offset": np.zeros(0, np.int64),
            "rev": np.zeros(0, bool),
        }
    kh, rev = assemble_stream(mhash, k, device=device)
    return {
        "hash": kh,
        "start": start[:nk],
        "end": end[k - 1 :],
        "offset": np.arange(nk, dtype=np.int64),
        "rev": rev,
    }


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
    streams = minimizer_stream_long_batch(
        [_xcodes(s, mode) for s in seqs], spec, chunk=chunk, device=device
    )
    return [_records_from_stream(st, en, mh, k, device) for st, en, mh in streams]
