"""NtHash1 seeds, base codes, xcode layout and density bounds (numpy only).

Copies of the parts of ``rust_seq2kminmers_tpu.constants`` that the port
uses.  The reference package cannot be imported here: its ``__init__``
loads jax.  ``tests/test_torch_constants.py`` holds every value below equal
to the reference's.

Base codes: A=0 C=1 G=2 T=3 N=4, OTHER=5 (scalar-table default seed 1),
PAD=6 (padding; seed 0).  An xcode is ``(keep << 3) | code``, where
``keep`` says the raw byte differs from the previous raw byte (the HPC
run start; always set at position 0).
"""

from __future__ import annotations

import numpy as np

SEED_A64 = 0x3C8BFBB395C60474
SEED_C64 = 0x3193C18562A02B4C
SEED_G64 = 0x20323ED082572324
SEED_T64 = 0x295549F54BE24456

MASK32 = 0xFFFFFFFF
U32_MAX = 0xFFFFFFFF

# The active H=u32 configuration keeps the low 32 bits of each seed.
SEED_A = SEED_A64 & MASK32
SEED_C = SEED_C64 & MASK32
SEED_G = SEED_G64 & MASK32
SEED_T = SEED_T64 & MASK32

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

XCODE_KEEP = 8  # bit 3: this base differs from the previous raw byte
XCODE_PAD = XCODE_KEEP | CODE_PAD


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


def encode_xcodes(
    seq: bytes | str | np.ndarray, family: str = "scalar"
) -> np.ndarray:
    """ASCII sequence -> uint8 xcodes: (raw-byte-diff keep << 3) | code."""
    if isinstance(seq, str):
        seq = seq.encode("latin-1")
    if isinstance(seq, np.ndarray):
        b = seq.astype(np.uint8, copy=False)
    else:
        b = np.frombuffer(bytes(seq), dtype=np.uint8)
    codes = code_table(family)[b]
    if len(b) == 0:
        return codes
    keep = np.empty(len(b), dtype=bool)
    keep[0] = True
    np.not_equal(b[1:], b[:-1], out=keep[1:])
    return codes | np.where(keep, np.uint8(XCODE_KEEP), np.uint8(0))


def hash_bound_u32(density: float) -> int:
    """Scalar-mode bound: trunc(density * u32::MAX), in f64."""
    return min(U32_MAX, int(np.float64(density) * np.float64(U32_MAX)))


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
