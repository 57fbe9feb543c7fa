"""Data-parallel pipeline with ordered global k-min-mer offsets, and the
host-side stitch of padded per-read outputs into one ordered stream.

The reference crate drives reads through a thread pool (src/main.rs:65-79);
the reference package (``rust_seq2kminmers_tpu/parallel/driver.py``)
shards them over a ``data`` mesh axis.  Here each rank of the mesh's
``data`` dimension runs the whole pipeline on its own rows, and the only
collectives are an all-gather of the per-read k-min-mer counts, which
gives each read its offset in the globally ordered stream, and an
all-reduce of the overflow flag.  The records never move between ranks.
``stitch_records`` is also the streaming runner's stitch.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..api import _cached_pipeline, _device
from ..ops.pipeline import KminmerBatch, PipelineSpec
from .mesh import all_gather, all_reduce_sum


class ShardedKminmers(NamedTuple):
    """One data rank's piece of a sharded step."""

    batch: KminmerBatch  # this rank's rows
    global_offset: torch.Tensor  # int32[B_local]: each read's first slot in the stream
    total: torch.Tensor  # int32[]: k-min-mers of the whole batch, every rank
    lost: torch.Tensor  # int32[]: data ranks where a read lost minimizers, every rank


def make_dp_pipeline(spec: PipelineSpec, mesh, device="cuda"):
    """-> step(codes, lengths) -> ShardedKminmers, where codes uint8[B/n_data,
    L] and lengths int32[B/n_data] are this rank's rows (``row_sharding``).

    Every rank of the mesh's data dimension calls the step together; the
    counts go through an all-gather over 'data' (4 bytes a read), and
    ``lost`` is the same on every rank, so a retry (``multihost``) stays
    collective.  The reference jits the whole step; here the local
    pipeline is the spec's compiled one (``api._cached_pipeline``, a
    captured graph on the card) and the two collectives run after it,
    outside the graph: gloo's go through the host."""
    device = _device(device)
    pipe = _cached_pipeline(spec)
    group = mesh.get_group("data")
    n_data, rank = dist.get_world_size(group), dist.get_rank(group)

    def step(codes, lengths) -> ShardedKminmers:
        out = pipe(torch.as_tensor(codes).to(device).contiguous(),
                   torch.as_tensor(lengths).to(device, torch.int32))
        counts = out.n_kminmers
        b_local = counts.shape[0]
        all_counts = all_gather(counts, group).view(n_data * b_local)
        excl = torch.cumsum(all_counts, 0, dtype=torch.int32) - all_counts
        short = (out.n_minimizers < out.n_minimizers_raw).any().to(torch.int32)
        return ShardedKminmers(
            batch=out,
            global_offset=excl[rank * b_local : (rank + 1) * b_local],
            total=all_counts.sum(dtype=torch.int32),
            lost=all_reduce_sum(short, group),
        )

    return step


def stitch_records(
    counts: np.ndarray,  # int[B] valid k-min-mers per read
    bases: np.ndarray,  # int[B] output base offset per read
    total: int,  # output length (>= bases[b] + counts[b] for all b)
    hashes: np.ndarray,  # uint64[B, >= max(counts)]
    start: np.ndarray,
    end: np.ndarray,
    rev: np.ndarray,
    read_base: int = 0,  # global index of read 0
    read_ids=None,  # int[B] explicit record ids; wins over read_base
) -> dict:
    """Vectorised O(total) stitch into one ordered struct-of-arrays {hash
    uint64, start, end, offset, read int64, rev bool}[total]: each output
    slot's (read, offset in the read) comes from the counts alone, then
    one fancy index gathers each column.  ``bases`` may be any
    collision-free offset assignment."""
    counts = counts.astype(np.int64)
    read_of = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    seg_start = np.repeat(np.cumsum(counts) - counts, counts)
    off_in_read = np.arange(counts.sum(), dtype=np.int64) - seg_start
    dest = np.repeat(bases.astype(np.int64), counts) + off_in_read
    if read_ids is not None:
        read = np.asarray(read_ids, dtype=np.int64)[read_of]
    else:
        read = read_of + read_base
    columns = {
        "hash": (np.uint64, hashes[read_of, off_in_read]),
        "start": (np.int64, start[read_of, off_in_read]),
        "end": (np.int64, end[read_of, off_in_read]),
        "offset": (np.int64, off_in_read),
        "rev": (bool, rev[read_of, off_in_read]),
        "read": (np.int64, read),
    }
    out = {}
    for name, (dtype, values) in columns.items():
        out[name] = np.zeros(total, dtype=dtype)
        out[name][dest] = values
    return out


def host(t) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def valid_corner(piece: ShardedKminmers) -> tuple:
    """(counts, offsets, total, hash uint64, start, end, rev) of one
    piece, numpy, cut to the rows' largest count."""
    b = piece.batch
    counts = host(b.n_kminmers).astype(np.int64)
    mk = int(counts.max(initial=0))
    words = [host(t[:, :mk]).astype(np.int64) & 0xFFFFFFFF for t in (b.hash_hi, b.hash_lo)]
    hashes = ((words[0] << 32) | words[1]).astype(np.uint64)
    return (counts, host(piece.global_offset).astype(np.int64), int(host(piece.total)),
            hashes, host(b.start[:, :mk]), host(b.end[:, :mk]),
            host(b.rev[:, :mk]).astype(bool))


def merge_ordered(result: Union[ShardedKminmers, Sequence[ShardedKminmers]], mesh=None):
    """The globally ordered struct-of-arrays {hash uint64, start, end,
    offset, read int64, rev bool}[total] of a step: read b's k-min-mers
    occupy [global_offset[b], global_offset[b] + n_kminmers[b]), with
    offsets 0..n-1 within the read (src/lib.rs:258-259).

    ``result`` is the list of every data rank's piece, in rank order; or
    this rank's own piece, with the mesh: each rank then sends its valid
    records to data rank 0 over 'data', which returns the dict (the other
    ranks return None)."""
    if isinstance(result, ShardedKminmers):
        group = mesh.get_group("data")
        pieces = [None] * dist.get_world_size(group) if dist.get_rank(group) == 0 else None
        dist.gather_object(valid_corner(result), pieces, dst=dist.get_global_rank(group, 0),
                           group=group)
        if pieces is None:
            return None
    else:
        pieces = [valid_corner(p) for p in result]
    counts, bases, totals, hashes, start, end, rev = zip(*pieces)
    mk = max((h.shape[1] for h in hashes), default=0)

    def cat(cols):
        return np.concatenate([np.pad(c, ((0, 0), (0, mk - c.shape[1]))) for c in cols])

    return stitch_records(np.concatenate(counts), np.concatenate(bases), totals[0],
                          cat(hashes), cat(start), cat(end), cat(rev))
