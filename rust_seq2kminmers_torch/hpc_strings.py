"""String-level homopolymer compression (host side, numpy).

The reference crate's public HPC API (src/hpc.rs), with each function's
own nuance:

  * ``hpc(s)``             collapses runs of ANY character (src/hpc.rs:28-41);
  * ``encode_rle(s)``      collapses runs only of "ACTGactgNn" (src/hpc.rs:14)
                           and returns each kept character's original
                           position as int64 (the ``Vec<usize>``);
  * ``encode_rle_simd(s)`` collapses runs of ANY byte, positions as uint32
                           (src/hpc.rs:44-147).

A str is read as latin-1 (one byte a character) when it fits, else as
UTF-8 bytes; the result decodes its bytes as latin-1.  The pipeline's own
HPC compaction is on the device (``ops/hpc.py``, K4's HPC form).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_RLE_COLLAPSIBLE = np.zeros(256, dtype=bool)
_RLE_COLLAPSIBLE[np.frombuffer(b"ACTGactgNn", dtype=np.uint8)] = True


def _to_bytes(s) -> np.ndarray:
    if isinstance(s, str):
        try:
            s = s.encode("latin-1")
        except UnicodeEncodeError:
            s = s.encode()
    return np.frombuffer(bytes(s), dtype=np.uint8)


def _rle(s, collapse_any: bool) -> Tuple[str, np.ndarray]:
    """-> (kept characters as a str, their int64 positions)."""
    b = _to_bytes(s)
    keep = np.ones(len(b), dtype=bool)
    keep[1:] = b[1:] != b[:-1]
    if not collapse_any:
        keep[1:] |= ~_RLE_COLLAPSIBLE[b[1:]]
    pos = np.nonzero(keep)[0]
    return str(memoryview(b[pos]), "latin-1"), pos


def hpc(s) -> str:
    """Collapse runs of any repeated character."""
    if len(s) == 0:
        return ""
    return _rle(s, True)[0]


def encode_rle(s) -> Tuple[str, np.ndarray]:
    """Collapse runs of ACTG/actg/N/n only; runs of other characters are
    kept verbatim.  -> (hpc string, int64 start positions of the kept
    characters)."""
    if len(s) == 0:
        return "", np.zeros(0, dtype=np.int64)
    chars, pos = _rle(s, False)
    return chars, pos.astype(np.int64, copy=False)


def encode_rle_simd(s) -> Tuple[str, np.ndarray]:
    """Collapse runs of any byte; positions as uint32."""
    if len(s) == 0:
        return "", np.zeros(0, dtype=np.uint32)
    chars, pos = _rle(s, True)
    return chars, pos.astype(np.uint32)
