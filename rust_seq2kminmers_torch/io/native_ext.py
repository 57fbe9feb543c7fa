"""The host string kernels (``native/rle.cpp``): run-length collapse and
xcode encoding, built by g++ on first use and loaded with ctypes (``gxx.py``).

The counterpart of the reference package's CPython extension
(``rust_seq2kminmers_tpu/io/native_ext.py`` over ``s2kext.cpp`` and
``rle_kernels.h``), without CPython's headers: the inputs are numpy uint8
arrays (``constants.byte_view`` reads a str or a bytes-like object in
place), and a collapse counts first, then stores into exact-size numpy
arrays, whose bytes become a str in one decode.  A library that does not
build raises: nothing falls back to numpy.

``scalar=True`` runs the scalar kernels where the AVX-512 ones would run
(``avx512()`` says which those are on this CPU).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from . import gxx

NATIVE_DIR = Path(__file__).resolve().parent / "native"
SOURCE = NATIVE_DIR / "rle.cpp"
BUILD_DIR = NATIVE_DIR / "build"

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {  # name -> (restype, argtypes)
    "s2k_native_avx512": (_I, []),
    "s2k_rle_plan_words": (_I, []),
    "s2k_rle_plan": (_I64, [_P, _I64, _I, _I, _P]),
    "s2k_rle_store": (_I, [_P, _P, _I64, _I, _P, _P, _I]),
    "s2k_rle_loop": (_I, [_P, _I64, _I, _I, _I, _I64, _I, _P, _P]),
    "s2k_xcode": (_I, [_P, _I64, _P, _P, _I]),
}
# The library's error codes.
_ERRORS = {1: "an argument is out of range",
           2: "32-bit positions cannot hold an input of 2^31 bytes or more",
           3: "out of memory"}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (once per source, flags and CPU) and load the library; raises
    RuntimeError with g++'s output if the build fails."""
    return gxx.build(SOURCE, BUILD_DIR, "libs2krle", _SIGNATURES)


def avx512() -> dict:
    """Which kernels run as AVX-512 on this CPU (else scalar)."""
    bits = library().s2k_native_avx512()
    return {"rle": bool(bits & 1), "xcode": bool(bits & 2)}


def _addr(a: Optional[np.ndarray]):
    return None if a is None else a.ctypes.data_as(_P)


def _check(err: int, name: str) -> None:
    if err == 2:
        raise OverflowError(f"{name}: {_ERRORS[2]}")
    if err:
        raise RuntimeError(f"{name}: {_ERRORS.get(err, f'error {err}')}")


def _contiguous(b: np.ndarray) -> np.ndarray:
    if b.dtype != np.uint8 or b.ndim != 1:
        raise TypeError(f"expected a 1-D uint8 array, got {b.dtype} {b.shape}")
    return np.ascontiguousarray(b)


def rle(b: np.ndarray, collapse_any: bool, wide: bool, want_pos: bool,
        scalar: bool = False) -> Tuple[str, Optional[np.ndarray]]:
    """Run-length collapse of the bytes ``b``: the first byte, then each
    byte that differs from the byte before it (with ``collapse_any``
    False, also each byte outside "ACTGactgNn") -> (the kept bytes as a
    latin-1 str, their positions as int64 (``wide``) or int32, or None
    without ``want_pos``)."""
    b = _contiguous(b)
    n = len(b)
    pdt = np.int64 if wide else np.int32
    if n == 0:
        return "", np.zeros(0, pdt) if want_pos else None
    lib = library()
    plan = np.empty(lib.s2k_rle_plan_words(), dtype=np.int64)
    total = lib.s2k_rle_plan(_addr(b), n, int(collapse_any), int(scalar), _addr(plan))
    chars = np.empty(total, dtype=np.uint8)
    pos = np.empty(total, dtype=pdt) if want_pos else None
    _check(lib.s2k_rle_store(_addr(plan), _addr(b), n, int(collapse_any), _addr(chars),
                             _addr(pos), 8 if wide else 4), "s2k_rle_store")
    return str(memoryview(chars), "latin-1"), pos


def rle_loop(b: np.ndarray, collapse_any: bool, wide: bool, want_pos: bool, min_ms: int,
             scalar: bool = False) -> Tuple[int, int]:
    """The collapse repeated inside the library for at least ``min_ms``
    ms into reused buffers -> (passes, nanoseconds).  32-bit positions
    refuse an input of 2^31 bytes or more (OverflowError)."""
    b = _contiguous(b)
    iters, ns = ctypes.c_int64(), ctypes.c_int64()
    _check(library().s2k_rle_loop(_addr(b), len(b), int(collapse_any), 8 if wide else 4,
                                  int(want_pos), int(min_ms), int(scalar),
                                  ctypes.byref(iters), ctypes.byref(ns)), "s2k_rle_loop")
    return iters.value, ns.value


def xcode(b: np.ndarray, table: np.ndarray, scalar: bool = False) -> np.ndarray:
    """uint8 xcodes of the bytes ``b``: ``table[byte] | keep << 3``, keep
    set on the first byte and where a byte differs from the one before."""
    b = _contiguous(b)
    table = np.ascontiguousarray(table, dtype=np.uint8)
    if table.shape != (256,):
        raise ValueError(f"the table must hold 256 bytes, got {table.shape}")
    out = np.empty(len(b), dtype=np.uint8)
    _check(library().s2k_xcode(_addr(b), len(b), _addr(table), _addr(out), int(scalar)),
           "s2k_xcode")
    return out
