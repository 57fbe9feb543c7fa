"""String-level homopolymer compression (host side).

The reference crate's public HPC API (src/hpc.rs), with each function's
own nuance:

  * ``hpc(s)``             collapses runs of ANY character (src/hpc.rs:28-41);
  * ``encode_rle(s)``      collapses runs only of "ACTGactgNn" (src/hpc.rs:14)
                           and returns each kept character's original
                           position as int64 (the ``Vec<usize>``);
  * ``encode_rle_simd(s)`` collapses runs of ANY byte, positions as uint32
                           (src/hpc.rs:44-147).

A str is read as latin-1 (one byte a character) when it fits, else as
UTF-8 bytes; an ASCII str is read in place (``constants.byte_view``).
The result decodes its bytes as latin-1.  The three run on the host
library (``io/native_ext.py``, AVX-512 where the CPU has it); ``_rle``
is their plain numpy version, which the tests hold the library against.
The pipeline's own HPC compaction is on the device (``ops/hpc.py``, K4's
HPC form).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .constants import byte_view
from .io import native_ext

_RLE_COLLAPSIBLE = np.zeros(256, dtype=bool)
_RLE_COLLAPSIBLE[np.frombuffer(b"ACTGactgNn", dtype=np.uint8)] = True


def _to_bytes(s) -> np.ndarray:
    return byte_view(s, utf8=True)


def _rle(s, collapse_any: bool) -> Tuple[str, np.ndarray]:
    """The plain version: -> (kept characters as a str, their int64
    positions)."""
    b = _to_bytes(s)
    keep = np.ones(len(b), dtype=bool)
    keep[1:] = b[1:] != b[:-1]
    if not collapse_any:
        keep[1:] |= ~_RLE_COLLAPSIBLE[b[1:]]
    pos = np.nonzero(keep)[0]
    return str(memoryview(b[pos]), "latin-1"), pos


def hpc(s) -> str:
    """Collapse runs of any repeated character."""
    return native_ext.rle(_to_bytes(s), True, False, False)[0]


def encode_rle(s) -> Tuple[str, np.ndarray]:
    """Collapse runs of ACTG/actg/N/n only; runs of other characters are
    kept verbatim.  -> (hpc string, int64 start positions of the kept
    characters)."""
    return native_ext.rle(_to_bytes(s), False, True, True)


def encode_rle_simd(s) -> Tuple[str, np.ndarray]:
    """Collapse runs of any byte; positions as uint32 (32-bit positions in
    the library below 2^31 bytes, 64-bit ones cut to 32 bits above)."""
    b = _to_bytes(s)
    chars, pos = native_ext.rle(b, True, len(b) >= 1 << 31, True)
    return chars, pos.astype(np.uint32) if pos.dtype == np.int64 else pos.view(np.uint32)
