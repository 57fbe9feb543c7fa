"""Sequence-parallel pipeline: one read's bases cut over the mesh's 'seq'
ranks, every shard through K1, K2 and K3 at once.

The reference crate scans each sequence serially; its block hand-off
(src/nthash_avx512_32.rs:404-425) makes the scan resumable mid-stream, and
the port's K1 takes that hand-off as its carry (``base0``, ``carry0``).
The reference package (``rust_seq2kminmers_tpu/parallel/seqshard.py``)
applies it across shards, twice:

  1. Base space.  Each shard's kept count and last l kept elements come
     from K1's passes 1-2 (``tile_carries``).  One all-gather over 'seq'
     exchanges them (1 + l int32 a read a shard); each shard sums its
     predecessors' counts into its first kept rank and splices their
     tails into its carry, across as many shards as needed (a shard
     inside a long homopolymer run keeps nothing), then runs K1 from that
     carry and K2 into its own capacity.  Each minimizer is emitted by
     exactly one shard.
  2. Minimizer space.  A shard's survivors are a contiguous slice of the
     read's minimizer stream; a k-window that straddles shards needs only
     the k-1 minimizers before the shard.  A second all-gather exchanges
     each shard's count and last k-1 (start, hash) elements, and K3 runs
     over the halo and the shard's own stream.

The survivor streams never move: a step exchanges O(l + k) int32 a read
a shard.  Each rank returns its segment (``KminmerSegments``);
``join_segments`` lays the ranks' segments side by side and
``stitch_segments`` gives the dense single-stream view on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..api import _device
from ..ops.cuda.assemble_kernel import assemble_masked_cuda
from ..ops.cuda.fused_scan import TILE, fused_minimizer_scan, tile_carries
from ..ops.cuda.slot_compact import slot_compact_counts
from ..ops.long_read import HPC_LIMIT
from ..ops.pipeline import KminmerBatch, PipelineSpec
from .driver import host
from .mesh import all_gather, nccl_compiled_step

BLOCK = 1024  # a shard's length is a multiple of this, as the reference's kernel blocks
# A carried element is packed (pos << 3) | code in int32, pos relative to
# the shard: it fits while it lies less than 2^28 bases before the shard.
_CARRY_REACH = 1 << 28
_HASH_FIELDS = ("hash_hi", "hash_lo", "min_hash", "min_hash_hi")
_SHARD_FIELDS = ("n_kminmers_seg", "km_off_seg", "n_minimizers_seg", "n_minimizers_raw_seg")


class KminmerSegments(NamedTuple):
    """A sequence-sharded step's output, shard by shard: the reference
    package's ``KminmerSegments``.  A rank's step returns its own segment,
    [B_local, cap] and [B_local, 1]; ``join_segments`` lays S of them side
    by side, [B, S * cap] and [B, S], the reference's layout.  Segment s
    of a read holds its valid k-min-mers at columns [s * cap + off, s * cap
    + off + n) with off, n from km_off_seg, n_kminmers_seg (off > 0 only
    while the read's stream before the shard is shorter than k - 1), and
    its minimizers at [s * cap, s * cap + n_minimizers_seg).  Everything
    else is zero.  Hash fields hold u32 bit patterns."""

    hash_hi: torch.Tensor  # int32[B, cap]
    hash_lo: torch.Tensor  # int32[B, cap]
    start: torch.Tensor  # int32[B, cap]
    end: torch.Tensor  # int32[B, cap]
    rev: torch.Tensor  # bool[B, cap]
    n_kminmers_seg: torch.Tensor  # int32[B, 1]
    km_off_seg: torch.Tensor  # int32[B, 1]
    min_hash: torch.Tensor  # int32[B, cap] (the low words at hash_width 64)
    min_hash_hi: torch.Tensor  # int32[B, cap], zeros unless hash_width 64
    min_start: torch.Tensor  # int32[B, cap]
    min_end: torch.Tensor  # int32[B, cap]
    n_minimizers_seg: torch.Tensor  # int32[B, 1]
    n_minimizers_raw_seg: torch.Tensor  # int32[B, 1]


def _splice(tails: torch.Tensor, counts: torch.Tensor, s: int):
    """The last w elements of shards 0..s-1's streams, concatenated.

    tails int64[S, B, c, w]: each shard's last w elements in c columns,
    right-aligned (the last min(count, w) real); counts int64[S, B].
    -> (int64[B, c, w] right-aligned, zero where no element; bool[B, w]
    where there is one).  Slot q is the element w - q places before shard
    s; it lies in the shard j < s whose stream ends ``after[j]`` elements
    before shard s, at slot q + after[j] of its tail, so one gather per
    shard finds it and at most one shard holds it."""
    S, B, _, w = tails.shape
    cum = torch.cumsum(counts, 0)
    before = cum[s - 1] if s > 0 else torch.zeros_like(counts[0])
    after = before[None] - cum  # [S, B]: elements of shards j+1 .. s-1
    slot = torch.arange(w, device=tails.device)[None, None, :] + after[:, :, None]
    shard = torch.arange(S, device=tails.device)[:, None, None]
    valid = (shard < s) & (slot < w) & (slot >= w - counts.clamp(max=w)[:, :, None])
    vals = torch.gather(tails, 3, slot.clamp(0, w - 1)[:, :, None, :].expand_as(tails))
    return torch.where(valid[:, :, None, :], vals, 0).sum(0), valid.any(0)


def _check_shape(C: int, S: int) -> None:
    """The shard width's rules, raised before any step runs."""
    L = S * C
    if C % BLOCK:
        raise ValueError(f"padded length {L} must be a multiple of {S * BLOCK} "
                         f"(seq={S} shards x {BLOCK}-base blocks)")
    if L >= 1 << 31:
        raise ValueError(f"padded length {L} does not fit int32 positions")


def _raise_far(far, s: int) -> None:
    """The carry-reach guard: raise if ``far`` (a bool tensor, or None
    where the shard's offset cannot reach) is set."""
    if far is not None and bool(far):
        raise ValueError(f"a carried element lies 2^28 or more bases before shard {s}")


def _seq_body(codes, lengths, spec: PipelineSpec, group) -> tuple:
    """The step without its host checks -> (this rank's KminmerSegments,
    the carry-reach flag: a bool tensor where the shard's offset is 2^28
    or more, else None).  No host sync: a CUDA graph can hold it."""
    S, s = dist.get_world_size(group), dist.get_rank(group)
    device = codes.device
    l, k, t = spec.l, spec.k, spec.k - 1
    wide = spec.hash_width == 64
    shards = torch.arange(S, device=device)
    Bl, C = codes.shape
    cap = max(-(-spec.capacity_for(S * C) // S), k)
    off = s * C
    local_len = (lengths.to(torch.int64) - off).clamp(0, C).to(torch.int32)
    cols = torch.arange(cap, device=device)[None, :]

    # 1. Base space: the shard's kept count and last l elements (K1's
    # passes 1-2), gathered; this shard's first rank and carry.
    base, pending = tile_carries(codes, local_len, l, TILE, spec.is_hpc)
    mine = torch.cat([base[:, -1:], pending[:, -1]], dim=1)
    got = all_gather(mine, group).to(torch.int64)  # [S, Bl, 1 + l]
    counts = got[:, :, 0]
    # Shard j's positions are relative to its own origin; the carry's
    # are relative to this shard's: on (pos << 3) | code, a subtraction.
    tails = got[:, :, None, 1:] - (((s - shards) * C) << 3)[:, None, None, None]
    carry, real = _splice(tails, counts, s)
    carry = carry[:, 0]
    far = ((carry < -(_CARRY_REACH << 3)) & real).any() if off >= _CARRY_REACH else None
    base0 = counts[:s].sum(dim=0).to(torch.int32)
    none = torch.full_like(lengths, -1)
    limit = torch.where(lengths > l, torch.full_like(lengths, HPC_LIMIT) if spec.is_hpc
                        else lengths - l, none)

    # K1 from the carry, K2 into the shard's capacity, positions global.
    st, en, hs, tile_counts = fused_minimizer_scan(
        codes, local_len, limit, l, spec.bound, spec.strict_threshold, spec.is_hpc,
        spec.mode == "hpc", TILE, spec.cap_per_tile(TILE), spec.hash_width,
        spec.variant, base0=base0, carry0=carry.to(torch.int32),
    )
    (mst, men, mhs), n_min, n_raw = slot_compact_counts(st, en, hs, tile_counts, cap)
    hi, lo = mhs if wide else (torch.zeros_like(mhs), mhs)
    ok = cols < n_min[:, None]
    mst = torch.where(ok, mst + off, 0)
    men = torch.where(ok, men + off, 0)

    # 2. Minimizer space: the k-1 minimizers before the shard, then K3
    # over them and the shard's own stream.  Window w ends at local
    # minimizer w; it is whole once the read's stream before it
    # reaches back k-1, i.e. from w = j0 on.
    n_buf, j0 = n_min, None
    buf = [lo, hi, mst, men]
    if t:
        idx = (n_min[:, None] - t + torch.arange(t, device=device)).clamp(min=0)
        words = [mst, lo] + ([hi] if wide else [])
        mine = torch.cat([n_min[:, None]] + [torch.gather(c, 1, idx) for c in words], 1)
        got = all_gather(mine, group).to(torch.int64)  # [S, Bl, 1 + t * words]
        n_all = got[:, :, 0]
        halo, _ = _splice(got[:, :, 1:].reshape(S, Bl, len(words), t), n_all, s)
        halo = halo.to(torch.int32)
        h_start, h_lo = halo[:, 0], halo[:, 1]
        h_hi = halo[:, 2] if wide else torch.zeros_like(h_lo)
        zero = torch.zeros_like(h_lo)
        buf = [torch.cat(p, dim=1) for p in ((h_lo, lo), (h_hi, hi), (h_start, mst),
                                             (zero, men))]
        n_buf = n_min + t
        j0 = (t - n_all[:s].sum(dim=0)).clamp(min=0).to(torch.int32)
    hash_hi, hash_lo, start, end, rev, n_km = assemble_masked_cuda(
        buf[0], k, spec.hash_width, buf[1] if wide else None, n_buf, buf[2], buf[3]
    )
    if j0 is None:
        j0 = torch.zeros_like(n_min)
    else:
        keep = cols >= j0[:, None]
        hash_hi, hash_lo, start, end = (torch.where(keep, x, 0)
                                        for x in (hash_hi, hash_lo, start, end))
        rev = rev & keep
        n_km = (n_min - j0).clamp(min=0)
    seg = KminmerSegments(
        hash_hi=hash_hi, hash_lo=hash_lo, start=start, end=end, rev=rev,
        n_kminmers_seg=n_km[:, None], km_off_seg=j0[:, None],
        min_hash=lo, min_hash_hi=hi, min_start=mst, min_end=men,
        n_minimizers_seg=n_min[:, None], n_minimizers_raw_seg=n_raw[:, None],
    )
    return seg, far


def seq_step(codes: torch.Tensor, lengths: torch.Tensor, spec: PipelineSpec,
             group) -> KminmerSegments:
    """The sequence-sharded step as a plain function of tensors: this
    rank's block codes uint8[B/n_data, C] of codes[B, S * C] and the reads'
    whole lengths int32[B/n_data] -> this rank's KminmerSegments.  Every
    rank of ``group`` (the mesh's 'seq' dimension) calls it together; it
    raises ValueError for a shard width that is not a multiple of 1024 or
    a padded length of 2^31 or more, and, after both all-gathers, for a
    carried element that lies 2^28 or more bases before the shard."""
    _check_shape(codes.shape[1], dist.get_world_size(group))
    seg, far = _seq_body(codes, lengths, spec, group)
    _raise_far(far, dist.get_rank(group))
    return seg


class SequenceShardedPipeline:
    """``make_seq_pipeline``'s step: ``step(codes, lengths) -> this rank's
    KminmerSegments``.

    Over NCCL with a CUDA device it is compiled as the reference jits it,
    whole: one captured CUDA graph of the step per (device, codes shape and
    dtype, lengths shape), both all-gathers inside it
    (``ops/cuda/graph.py``'s ``CompiledStep``: a key's first call is the
    capture's eager warm-up and returns its answer, later calls replay,
    so each call issues the two all-gathers once on every rank).  The
    shape's ValueErrors come before the key is looked up; the carry-reach
    guard is a flag among the graph's outputs where the shard's offset
    can reach 2^28, raised on the host after the replay.  A capture or a
    replay that fails raises.  Over gloo the step is ``seq_step``,
    eagerly: its all-gathers go through the host."""

    def __init__(self, spec: PipelineSpec, group, device: torch.device):
        self.spec, self.group, self.device = spec, group, device
        self.compiled = None
        if dist.get_backend(group) == "nccl" and device.type == "cuda":
            self.compiled = nccl_compiled_step(self._flat)

    def _flat(self, codes, lengths) -> tuple:
        seg, far = _seq_body(codes, lengths, self.spec, self.group)
        return (*seg, *(() if far is None else (far,)))

    def __call__(self, codes, lengths) -> KminmerSegments:
        codes = torch.as_tensor(codes).to(self.device).contiguous()
        lengths = torch.as_tensor(lengths).to(self.device, torch.int32)
        if self.compiled is None:
            return seq_step(codes, lengths, self.spec, self.group)
        _check_shape(codes.shape[1], dist.get_world_size(self.group))
        out = self.compiled(codes, lengths)
        n = len(KminmerSegments._fields)
        _raise_far(out[n] if len(out) > n else None, dist.get_rank(self.group))
        return KminmerSegments(*out[:n])


def make_seq_pipeline(spec: PipelineSpec, mesh, device="cuda") -> SequenceShardedPipeline:
    """-> step(codes, lengths) -> this rank's KminmerSegments.  codes is
    uint8[B/n_data, C], this rank's block of codes[B, L] with L = n_seq * C
    (``batch_sharding(..., seq_sharded=True)``), lengths int32[B/n_data]
    the reads' whole lengths (``row_sharding``).

    Every rank of the mesh's seq dimension calls the step together.  C
    must be a multiple of 1024 (and below K1's 2^28); the capacity of a
    shard is ceil(capacity_for(L) / S), at least k.  Overflow is reported,
    not retried: a read lost minimizers where n_minimizers_raw_seg exceeds
    n_minimizers_seg, and the caller reruns on ``api.rescue_spec`` sized
    for S times the largest raw count, since survivors may crowd into one
    shard.  CUDA tensors launch the kernels; ``device="cpu"`` runs their
    plain versions.  Over NCCL the step is a captured graph
    (``SequenceShardedPipeline``)."""
    if not spec.fused:
        raise ValueError(f"the sequence-sharded path needs 2 <= l <= 255 (K1's carry), "
                         f"got l={spec.l}")
    return SequenceShardedPipeline(spec, mesh.get_group("seq"), _device(device))


def _host(name: str, a) -> np.ndarray:
    """A field as numpy in the reference's dtypes (uint32 hashes)."""
    a = host(a)
    return a.view(np.uint32) if name in _HASH_FIELDS and a.dtype == np.int32 else a


def join_segments(pieces, n_seq: int) -> KminmerSegments:
    """Every rank's segment, in rank order (rank d * n_seq + s holds data
    block d, shard s), laid out as the reference's [B, S * cap] and [B, S]
    numpy arrays."""
    out = {}
    for name in KminmerSegments._fields:
        parts = [_host(name, getattr(p, name)) for p in pieces]
        rows = [np.concatenate(parts[i : i + n_seq], axis=1)
                for i in range(0, len(parts), n_seq)]
        out[name] = np.concatenate(rows, axis=0)
    return KminmerSegments(**out)


def stitch_segments(seg: KminmerSegments) -> KminmerBatch:
    """The dense single-stream view of segments in the [B, S * cap] layout
    (``join_segments``): a KminmerBatch of numpy arrays in the reference's
    dtypes, each row's first n entries valid, in stream order, zero after.
    Every valid element's source and destination come from the counts at
    once, as ``stitch_records`` does: no loop over reads or shards."""
    f = {name: _host(name, a) for name, a in seg._asdict().items()}
    nk, km_off, nm = (f[n].astype(np.int64) for n in _SHARD_FIELDS[:3])
    B, S = nk.shape
    cap = f["hash_hi"].shape[1] // S
    n_km, n_min = nk.sum(axis=1), nm.sum(axis=1)

    def dense(names, counts, offs, n_rows):
        width = max(int(n_rows.max(initial=0)), 1)
        c = counts.reshape(-1)  # segment (b, s) is number b * S + s
        seg_of = np.repeat(np.arange(B * S), c)
        i = np.arange(c.sum()) - np.repeat(np.cumsum(c) - c, c)  # index in the segment
        before = (np.cumsum(counts, axis=1) - counts).reshape(-1)  # in the row
        src = seg_of * cap + np.repeat(offs.reshape(-1), c) + i
        dst = (seg_of // S) * width + np.repeat(before, c) + i
        out = {}
        for name in names:
            col = np.zeros(B * width, dtype=f[name].dtype)
            col[dst] = f[name].reshape(-1)[src]
            out[name] = col.reshape(B, width)
        return out

    km = dense(("hash_hi", "hash_lo", "start", "end", "rev"), nk, km_off, n_km)
    mins = dense(("min_hash", "min_hash_hi", "min_start", "min_end"), nm, np.zeros_like(nm),
                 n_min)
    return KminmerBatch(
        **km, n_kminmers=n_km.astype(np.int32), **mins,
        n_minimizers=n_min.astype(np.int32),
        n_minimizers_raw=f["n_minimizers_raw_seg"].sum(axis=1).astype(np.int32),
    )
