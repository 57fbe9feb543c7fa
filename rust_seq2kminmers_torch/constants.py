"""NtHash seeds, base codes, xcode layout and density bounds (numpy), and
the byte view of a sequence's text.

Copies of the parts of ``rust_seq2kminmers_tpu.constants`` that the port
uses.  The reference package cannot be imported here: its ``__init__``
loads jax.  ``tests/test_torch_constants.py`` holds every value below equal
to the reference's.  ``encode_xcodes`` hands large inputs to the host
library (``io/native_ext.py``), imported when first needed.

Base codes: A=0 C=1 G=2 T=3 N=4, OTHER=5 (scalar-table default seed 1),
PAD=6 (padding; seed 0).  An xcode is ``(keep << 3) | code``, where
``keep`` says the raw byte differs from the previous raw byte (the HPC
run start; always set at position 0).
"""

from __future__ import annotations

import ctypes

import numpy as np

SEED_A64 = 0x3C8BFBB395C60474
SEED_C64 = 0x3193C18562A02B4C
SEED_G64 = 0x20323ED082572324
SEED_T64 = 0x295549F54BE24456

MASK32 = 0xFFFFFFFF
U32_MAX = 0xFFFFFFFF
U64_MAX = 0xFFFFFFFFFFFFFFFF

# The active H=u32 configuration keeps the low 32 bits of each seed.
SEED_A = SEED_A64 & MASK32
SEED_C = SEED_C64 & MASK32
SEED_G = SEED_G64 & MASK32
SEED_T = SEED_T64 & MASK32


def seed_tables(hash_width: int):
    """(forward, reverse) seed tables per code at a hash width: the LOW
    ``hash_width`` bits of the 64-bit seeds, as uint16 / uint32 / uint64."""
    if hash_width == 64:
        dt, mask = np.uint64, U64_MAX
    elif hash_width == 32:
        dt, mask = np.uint32, MASK32
    elif hash_width == 16:
        dt, mask = np.uint16, 0xFFFF
    else:
        raise ValueError(f"hash_width must be 16/32/64, got {hash_width}")
    seeds = [SEED_A64, SEED_C64, SEED_G64, SEED_T64]
    f = np.array([s & mask for s in seeds] + [0, 1, 0], dtype=dt)
    r = np.array([s & mask for s in seeds[::-1]] + [0, 1, 0], dtype=dt)
    return f, r


def seed_tables_nthash2_31():
    """Seed tables of the NtHash2-hybrid 31-bit variant: the TOP 31 bits of
    the 64-bit seeds (``SEED >> 33``), rotated mod 31."""
    seeds = [SEED_A64, SEED_C64, SEED_G64, SEED_T64]
    f = np.array([s >> 33 for s in seeds] + [0, 1, 0], dtype=np.uint32)
    r = np.array([s >> 33 for s in seeds[::-1]] + [0, 1, 0], dtype=np.uint32)
    return f, r

CODE_A = 0
CODE_C = 1
CODE_G = 2
CODE_T = 3
CODE_N = 4
CODE_OTHER = 5
CODE_PAD = 6
NUM_CODES = 7

# Forward seed per code, and the complement's seed for the reverse strand.
SEED_TABLE_F = np.array(
    [SEED_A, SEED_C, SEED_G, SEED_T, 0, 1, 0], dtype=np.uint32
)
SEED_TABLE_R = np.array(
    [SEED_T, SEED_G, SEED_C, SEED_A, 0, 1, 0], dtype=np.uint32
)

# Scalar modes (regular, hpc): uppercase ACGTN only; every other byte,
# lowercase included, hashes as OTHER.
BYTE_TO_CODE_SCALAR = np.full(256, CODE_OTHER, dtype=np.uint8)
for _b, _c in zip(b"ACGTN", (CODE_A, CODE_C, CODE_G, CODE_T, CODE_N)):
    BYTE_TO_CODE_SCALAR[_b] = _c

# SIMD modes (simd, hpcsimd): a 16-entry LUT on the byte's low nibble, so
# case folds and every non-base nibble maps to N.
_SIMD_NIBBLE_LUT = np.array(
    [4, 0, 4, 1, 3, 4, 4, 2, 4, 4, 4, 4, 4, 4, 4, 4], dtype=np.uint8
)
BYTE_TO_CODE_SIMD = _SIMD_NIBBLE_LUT[np.arange(256) & 0x0F]

# The plain-code table of ``encode_bases`` and ``FastaFile.pack(family=None)``:
# ACGTN in either case, every other byte OTHER.
BYTE_TO_CODE = BYTE_TO_CODE_SCALAR.copy()
for _b, _c in zip(b"acgtn", (CODE_A, CODE_C, CODE_G, CODE_T, CODE_N)):
    BYTE_TO_CODE[_b] = _c

CODE_TO_BYTE = np.frombuffer(b"ACGTN??", dtype=np.uint8).copy()

XCODE_KEEP = 8  # bit 3: this base differs from the previous raw byte
XCODE_PAD = XCODE_KEEP | CODE_PAD


MODES = ("regular", "hpc", "simd", "hpcsimd")


def family_of_mode(mode: str) -> str:
    """Hash-table family of a mode: scalar (regular/hpc) or simd."""
    return "simd" if mode in ("simd", "hpcsimd") else "scalar"


def code_table(family: str) -> np.ndarray:
    """256-entry byte -> 3-bit hash-code table of a mode family."""
    if family == "scalar":
        return BYTE_TO_CODE_SCALAR
    if family == "simd":
        return BYTE_TO_CODE_SIMD
    raise ValueError(f"unknown table family {family!r}")


def with_keep_bits(codes: np.ndarray) -> np.ndarray:
    """Stamp xcode keep bits onto plain 3-bit codes (1-D or [B, L]),
    treating code equality as byte equality: for synthetic inputs whose
    bases were never bytes."""
    codes = np.asarray(codes)
    low = codes & 7
    keep = low != np.roll(low, 1, axis=-1)
    keep[..., 0] = True
    return (low | np.where(keep, XCODE_KEEP, 0)).astype(np.uint8)


class _BorrowedBytes:
    """A numpy array interface over ``n`` bytes at ``addr`` that keeps
    their ``owner`` alive: the view's base holds this object."""

    def __init__(self, owner, addr: int, n: int):
        self.owner = owner
        self.__array_interface__ = {
            "data": (addr, True), "shape": (n,), "typestr": "|u1", "version": 3,
        }


_utf8_and_size = ctypes.pythonapi.PyUnicode_AsUTF8AndSize
_utf8_and_size.restype = ctypes.c_void_p
_utf8_and_size.argtypes = [ctypes.py_object, ctypes.POINTER(ctypes.c_ssize_t)]


def byte_view(seq, utf8: bool = False) -> np.ndarray:
    """A sequence's bytes as a read-only uint8 numpy array, with no copy
    where the caller's memory can be read as it is.

    An ASCII str is read in place: CPython keeps its characters as one
    byte each and hands them out through ``PyUnicode_AsUTF8AndSize``
    (for any other str that call would allocate and cache a UTF-8 copy).
    Any other str is read as latin-1, one byte a character; a str outside
    latin-1 raises ``UnicodeEncodeError``, or with ``utf8`` is read as its
    UTF-8 bytes.  bytes, bytearray, memoryview and ndarrays are viewed as
    bytes (a non-contiguous ndarray is copied)."""
    if isinstance(seq, str):
        if seq.isascii() and seq:
            n = ctypes.c_ssize_t()
            addr = _utf8_and_size(seq, ctypes.byref(n))
            return np.asarray(_BorrowedBytes(seq, addr, n.value))
        try:
            seq = seq.encode("latin-1")
        except UnicodeEncodeError:
            if not utf8:
                raise
            seq = seq.encode()
    if isinstance(seq, np.ndarray):
        return np.ascontiguousarray(seq).reshape(-1).view(np.uint8)
    return np.frombuffer(seq, dtype=np.uint8)


def _to_byte_array(seq: bytes | str | np.ndarray) -> np.ndarray:
    if isinstance(seq, np.ndarray):
        return seq.astype(np.uint8, copy=False)
    return byte_view(seq)


def encode_bases(seq: bytes | str | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 plain codes (A=0 C=1 G=2 T=3 N=4 in either
    case, other=5), without keep bits; ``encode_xcodes`` is the pipeline's
    encoder."""
    return BYTE_TO_CODE[_to_byte_array(seq)]


# Below this many bytes, encode_xcodes stays in numpy: a library call
# costs more than it saves (the reference package's threshold).
NATIVE_XCODE_MIN = 4096


def encode_xcodes(
    seq: bytes | str | np.ndarray, family: str = "scalar"
) -> np.ndarray:
    """ASCII sequence -> uint8 xcodes: (raw-byte-diff keep << 3) | code.
    From ``NATIVE_XCODE_MIN`` bytes on, a str, bytes-like object or 1-D
    uint8 ndarray is encoded by the host library (``io/native_ext.py``,
    AVX-512 where the CPU has it), read in place; a library that does not
    build raises."""
    table = code_table(family)
    if len(seq) >= NATIVE_XCODE_MIN and (
        not isinstance(seq, np.ndarray) or (seq.ndim == 1 and seq.dtype == np.uint8)
    ):
        from .io import native_ext

        return native_ext.xcode(_to_byte_array(seq), table)
    return _encode_xcodes_numpy(_to_byte_array(seq), table)


def _encode_xcodes_numpy(b: np.ndarray, table: np.ndarray) -> np.ndarray:
    codes = table[b]
    if len(b) == 0:
        return codes
    keep = np.empty(len(b), dtype=bool)
    keep[0] = True
    np.not_equal(b[1:], b[:-1], out=keep[1:])
    return codes | np.where(keep, np.uint8(XCODE_KEEP), np.uint8(0))


def hash_bound_u32(density: float) -> int:
    """Scalar-mode bound: trunc(density * u32::MAX), in f64."""
    return min(U32_MAX, int(np.float64(density) * np.float64(U32_MAX)))


def hash_bound(density: float, hash_width: int) -> int:
    """Scalar-mode bound at any width: trunc(density * H::MAX) in f64,
    clamped to [0, H::MAX] (``u64::MAX as f64`` rounds to 2^64)."""
    hmax = (1 << hash_width) - 1
    return min(hmax, max(0, int(np.float64(density) * np.float64(hmax))))


def hash_bound_nthash2_31(density: float) -> int:
    """NtHash2-31 SIMD-mode bound: the f32 SIMD bound halved, since the
    31-bit hash space is half the 32-bit one."""
    return hash_bound_simd_u32(density) // 2


def hash_bound_simd_u32(density: float) -> int:
    """SIMD-mode bound: the scalar bound recomputed through f32, as the
    reference's AVX-512 path does (``u32::MAX as f32`` rounds to 2^32),
    truncated and saturated like Rust's ``as u32``."""
    d2 = np.float64(hash_bound_u32(density)) / np.float64(U32_MAX)
    prod = float(np.float32(d2) * np.float32(np.float64(U32_MAX)))
    if prod <= 0.0:
        return 0
    if prod >= float(U32_MAX):
        return U32_MAX
    return int(prod)
