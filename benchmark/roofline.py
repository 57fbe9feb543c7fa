"""The card's peaks and the least work of the main path's kernels.

A kernel's roofline share is its bound (the larger of its bytes over the
HBM rate and its integer operations over the peak rate) over its device
time.  Bytes count each input read once and each output written once;
operations count what these inputs need.  Every count is taken from the
run's own inputs and outputs.  The arithmetic is the one the port's chip
smoke test uses for K1, K2 and K3, frozen here so that later edits to the
program's scripts cannot move it.
"""

from __future__ import annotations

# NVIDIA's data sheet for the H100 SXM at 700 W: HBM bytes a second, and
# the 67 T/s non-tensor float32 rate taken for integer operations, whose
# own rate the sheet does not list (so the operations' time is a floor).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# K1 writes its survivors and counts per tile of this many bases.
K1_TILE = 16384


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds a kernel can take for this work."""
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S)


def k1_bound_s(rows: int, length: int, tiles: int, survivors: int, stream: int,
               width: int) -> float:
    """K1 (the fused scan) over ``rows`` x ``length`` xcodes cut into
    ``tiles`` tiles a row: each base read once, the lengths and limits,
    each survivor's (start, end, hash[, hash_hi]) and each tile's three
    counts written once.  Operations: the keep test a base (3), and a
    stream element's two rotated terms, two prefix XORs, its window's two
    XORs, two rotations, the min and the compare (12)."""
    nbytes = (rows * length + 8 * rows + survivors * (16 if width == 64 else 12)
              + rows * tiles * 3 * 4)
    return bound_s(nbytes, 3 * rows * length + 12 * stream)


def k2_bound_s(rows: int, tiles: int, survivors: int, capacity: int) -> float:
    """K2 (slot compaction): each survivor's 3 columns and each tile's kept
    and raw counts read; the ``capacity`` slots of 3 columns of every row
    (the fill included) and each row's two counts written."""
    nbytes = survivors * 12 + rows * tiles * 8 + rows * capacity * 12 + rows * 8
    return bound_s(nbytes, 3 * survivors)


def k3_bound_s(rows: int, n_min: list, k: int, capacity: int) -> float:
    """K3 (assembly, masked): each row's valid minimizer words and its valid
    windows' starts and ends read; 17 bytes a window slot and each row's
    count written.  Operations: a mix (12) a word, and a roll, min and
    compare (16) a valid window."""
    words = sum(n_min)
    valid = sum(max(n - (k - 1), 0) for n in n_min)
    slots = capacity - k + 1
    nbytes = words * 4 + valid * 8 + rows * slots * 17 + rows * 8
    return bound_s(nbytes, 12 * words + 16 * valid)
