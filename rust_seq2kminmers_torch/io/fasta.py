"""FASTA/FASTQ input: a native C++ reader (ctypes) or a Python parser.

In place of the reference crate's rust-parallelfastx (mmap parsing with
thread-parallel record dispatch, src/main.rs:79).  The native library,
``native/fasta_reader.cpp``, is built with g++ on first use into
``native/build/`` (not committed; ``gxx.py``).  A build that fails raises
with g++'s output; ``FastaFile(..., prefer_native=False)`` selects the
Python parser.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..constants import BYTE_TO_CODE, CODE_PAD, XCODE_PAD, code_table, encode_xcodes
from . import gxx

NATIVE_DIR = Path(__file__).resolve().parent / "native"
SOURCE = NATIVE_DIR / "fasta_reader.cpp"
BUILD_DIR = NATIVE_DIR / "build"

_P, _I64, _U8 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint8
_SIGNATURES = {  # name -> (restype, argtypes)
    "s2k_open": (_P, [ctypes.c_char_p]),
    "s2k_num_records": (_I64, [_P]),
    "s2k_max_seq_len": (_I64, [_P]),
    "s2k_seq_len": (_I64, [_P, _I64]),
    "s2k_seq_lens": (None, [_P, _P]),
    "s2k_name": (_I64, [_P, _I64, ctypes.c_char_p, _I64]),
    "s2k_pack": (_I64, [_P, _I64, _I64, _I64, _P, _P, _I64]),
    "s2k_packx": (_I64, [_P, _I64, _I64, _I64, _P, _U8, _P, _P, _I64]),
    "s2k_packx_idx": (_I64, [_P, _P, _I64, _I64, _P, _U8, _P, _P, _I64]),
    "s2k_close": (None, [_P]),
}


@functools.lru_cache(maxsize=None)
def native_library() -> ctypes.CDLL:
    """Build (once per source, flags and CPU) and load the reader; raises
    RuntimeError with g++'s output if the build fails."""
    return gxx.build(SOURCE, BUILD_DIR, "libs2kfasta", _SIGNATURES)


def _addr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


class FastaFile:
    """An indexed FASTA/FASTQ file with batched packed reads.

    The native reader indexes the file unless ``prefer_native`` is False;
    a file it cannot map (an empty one) goes to the Python parser."""

    def __init__(self, path, prefer_native: bool = True):
        self.path = str(path)
        self._handle = None
        self._lib = native_library() if prefer_native else None
        if self._lib is not None:
            self._handle = self._lib.s2k_open(self.path.encode())
            if not self._handle:
                self._lib = None
        if self._lib is None:
            self._py_records = _py_index(self.path)

    @property
    def native(self) -> bool:
        return self._lib is not None

    def __len__(self) -> int:
        if self.native:
            return int(self._lib.s2k_num_records(self._handle))
        return len(self._py_records)

    def max_seq_len(self) -> int:
        if self.native:
            return int(self._lib.s2k_max_seq_len(self._handle))
        return max((len(s) for _, s in self._py_records), default=0)

    def seq_len(self, i: int) -> int:
        if self.native:
            return int(self._lib.s2k_seq_len(self._handle, i))
        return len(self._py_records[i][1])

    def seq_lens(self) -> np.ndarray:
        """All record lengths at once (int64[n])."""
        if self.native:
            out = np.empty(len(self), dtype=np.int64)
            self._lib.s2k_seq_lens(self._handle, _addr(out))
            return out
        return np.array([len(s) for _, s in self._py_records], dtype=np.int64)

    def name(self, i: int) -> str:
        if self.native:
            buf = ctypes.create_string_buffer(4096)
            n = self._lib.s2k_name(self._handle, i, buf, 4096)
            return buf.raw[:n].decode(errors="replace")
        return self._py_records[i][0]

    def pack_indices(
        self,
        indices,
        max_len: int,
        threads: int = 0,
        family: str = "scalar",
        out: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Gather-pack arbitrary record ids into uint8 xcodes, XCODE_PAD past
        each length; an id out of range packs an empty row.  -> (codes
        uint8[len(indices), max_len], lengths int64), written into ``out``
        when given (C-contiguous arrays of those shapes and dtypes, such
        as numpy views of pinned host tensors)."""
        idx = np.ascontiguousarray(np.asarray(indices, dtype=np.int64))
        count = len(idx)
        if out is None:
            codes = np.empty((count, max_len), dtype=np.uint8)
            lengths = np.empty(count, dtype=np.int64)
        else:
            codes, lengths = out
            for a, dtype, shape in ((codes, np.uint8, (count, max_len)),
                                    (lengths, np.int64, (count,))):
                if a.dtype != dtype or a.shape != shape or not a.flags["C_CONTIGUOUS"]:
                    raise ValueError(
                        f"out: expected a C-contiguous {np.dtype(dtype)}{list(shape)}, "
                        f"got {a.dtype}{list(a.shape)}"
                    )
        if count == 0:
            return codes, lengths
        if self.native:
            table = np.ascontiguousarray(code_table(family))
            self._lib.s2k_packx_idx(
                self._handle, _addr(idx), count, max_len, _addr(table), XCODE_PAD,
                _addr(codes), _addr(lengths), threads,
            )
            return codes, lengths
        for i, r in enumerate(idx):
            if r < 0 or r >= len(self._py_records):
                codes[i] = XCODE_PAD
                lengths[i] = 0
                continue
            x = encode_xcodes(self._py_records[r][1], family)[:max_len]
            codes[i, : len(x)] = x
            codes[i, len(x):] = XCODE_PAD
            lengths[i] = len(x)
        return codes, lengths

    def pack(
        self,
        first: int = 0,
        count: Optional[int] = None,
        max_len: Optional[int] = None,
        threads: int = 0,
        family: Optional[str] = "scalar",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Records [first, first + count) -> (codes uint8[count, max_len],
        lengths int64[count], clipped to max_len).

        family "scalar" or "simd" packs xcodes ((raw-byte-diff keep << 3) |
        the family's code, XCODE_PAD past each length); family None packs
        plain codes (ACGTN in either case, other bytes OTHER, CODE_PAD past
        each length, no keep bits)."""
        n = len(self)
        if count is None:
            count = n - first
        count = max(0, min(count, n - first))
        if max_len is None:
            max_len = self.max_seq_len()
        codes = np.empty((count, max_len), dtype=np.uint8)
        lengths = np.empty(count, dtype=np.int64)
        if count == 0:
            return codes, lengths
        if self.native:
            if family is None:
                got = self._lib.s2k_pack(
                    self._handle, first, count, max_len, _addr(codes), _addr(lengths),
                    threads,
                )
            else:
                table = np.ascontiguousarray(code_table(family))
                got = self._lib.s2k_packx(
                    self._handle, first, count, max_len, _addr(table), XCODE_PAD,
                    _addr(codes), _addr(lengths), threads,
                )
            if got != count:
                raise RuntimeError(f"packed {got} records of {count}")
            return codes, lengths
        for i in range(count):
            s = self._py_records[first + i][1]
            if family is None:
                b = np.frombuffer(s.encode("latin-1"), dtype=np.uint8)[:max_len]
                codes[i, : len(b)] = BYTE_TO_CODE[b]
                codes[i, len(b):] = CODE_PAD
                lengths[i] = len(b)
            else:
                x = encode_xcodes(s, family)[:max_len]
                codes[i, : len(x)] = x
                codes[i, len(x):] = XCODE_PAD
                lengths[i] = len(x)
        return codes, lengths

    def batches(
        self,
        batch_size: int,
        max_len: Optional[int] = None,
        threads: int = 0,
        family: Optional[str] = "scalar",
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        """Yield (codes, lengths, first record id) over the whole file."""
        if max_len is None:
            max_len = self.max_seq_len()
        n = len(self)
        for first in range(0, n, batch_size):
            codes, lengths = self.pack(
                first, min(batch_size, n - first), max_len, threads, family
            )
            yield codes, lengths, first

    def close(self):
        if self._handle:  # set only by the native reader
            self._lib.s2k_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def _py_index(path: str) -> List[Tuple[str, str]]:
    """The Python parser: multi-line FASTA and 4-line FASTQ records as
    (name, sequence) pairs."""
    records: List[Tuple[str, str]] = []
    with open(path) as f:
        first = f.read(1)
        f.seek(0)
        if first == "@":
            while True:
                hdr = f.readline()
                if not hdr:
                    break
                seq = f.readline().strip()
                f.readline()  # +
                f.readline()  # qualities
                if hdr.startswith("@"):
                    records.append((hdr[1:].strip(), seq))
        else:
            name, chunks = None, []
            for line in f:
                line = line.rstrip("\n")
                if line.startswith(">"):
                    if name is not None:
                        records.append((name, "".join(chunks)))
                    name, chunks = line[1:], []
                elif name is not None:
                    chunks.append(line)
            if name is not None:
                records.append((name, "".join(chunks)))
    return records
