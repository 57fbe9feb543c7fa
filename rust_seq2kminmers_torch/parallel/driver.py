"""Stitching padded per-read k-min-mer outputs into one ordered stream.

``stitch_records`` is the host side of the reference package's
data-parallel driver (``rust_seq2kminmers_tpu/parallel/driver.py``): the
streaming runner uses it for every settled batch.
"""

from __future__ import annotations

import numpy as np


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
