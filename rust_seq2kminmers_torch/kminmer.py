"""The k-min-mer data model: the vector-of-mers record and its hashers.

The reference crate's kminmer.rs, on the host:
  * ``KminmerVec`` (kminmer.rs:18-126) keeps the k raw minimizer hashes;
    its canonical form is the lexicographic min of (mers, reversed mers)
    with a rev flag (normalize, :54-61); equality, ordering and hashing
    are on the mers.
  * ``kminmer_hash_from_mers`` is ``Kminmer::new`` for KminmerHash
    (:140-161): the hash is FxHash64 of the canonical mers vector.
  * FxHash (fxhash 0.2.1): per 8-byte word h = (rol(h, 5) ^ word) * SEED,
    over write_usize(len) and then the slice's little-endian bytes, as
    Rust hashes an integer slice.
  * SipHash-1-3 with zero keys is Rust's DefaultHasher, which the
    reference's generic ``get_hash`` uses (:42-47).

``kminmers_vec`` takes its minimizers from the pipeline's own stream
(``KminmerBatch.min_hash / min_start / min_end``) on ``device``.
"""

from __future__ import annotations

import struct
import warnings
from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np

from .api import HashMode, KminmerRecord, _device, _mode_name, run_single
from .oracle import nthash1_minimizer_space  # noqa: F401  (a name of this module)
from .ops.pipeline import PipelineSpec

_M64 = (1 << 64) - 1
_FX_SEED64 = 0x51_7C_C1_B7_27_22_0A_95
_FX_SEED32 = 0x9E_37_79_B9
_LE = {16: "<u2", 32: "<u4", 64: "<u8"}


def _rol64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _mer_bytes(mers: Sequence[int], mer_width: int) -> bytes:
    return np.asarray(mers, dtype=np.uint64).astype(_LE[mer_width]).tobytes()


def fxhash64_bytes(data: bytes, init: int = 0) -> int:
    """FxHasher64 ``write`` over a byte string (fxhash 0.2.1): 8-byte LE
    words, then 4/2/1-byte tails, each folded as
    h = (rol64(h, 5) ^ w) * SEED64 mod 2^64."""
    h, i, n = init, 0, len(data)
    while n - i >= 8:
        h = (_rol64(h, 5) ^ struct.unpack_from("<Q", data, i)[0]) * _FX_SEED64 & _M64
        i += 8
    for size, fmt in ((4, "<I"), (2, "<H"), (1, "<B")):
        if n - i >= size:
            h = (_rol64(h, 5) ^ struct.unpack_from(fmt, data, i)[0]) * _FX_SEED64 & _M64
            i += size
    return h


def fxhash64_of_mers(mers: Sequence[int], mer_width: int = 32) -> int:
    """fxhash::hash64(&Vec<H>): write_usize(len), then the slice's raw LE
    bytes."""
    h = (_rol64(0, 5) ^ (len(mers) & _M64)) * _FX_SEED64 & _M64
    return fxhash64_bytes(_mer_bytes(mers, mer_width), init=h)


def fxhash32_of_mers(mers: Sequence[int], mer_width: int = 32) -> int:
    """fxhash::hash32 (32-bit folding, 4-byte words) of a Vec<H>."""
    m32 = (1 << 32) - 1

    def add(h, w):
        return ((((h << 5) | (h >> 27)) & m32) ^ w) * _FX_SEED32 & m32

    # write_usize writes 8 bytes: two 4-byte words on the 32-bit folder
    h = add(add(0, len(mers) & m32), (len(mers) >> 32) & m32)
    data = _mer_bytes(mers, mer_width)
    i, n = 0, len(data)
    while n - i >= 4:
        h = add(h, struct.unpack_from("<I", data, i)[0])
        i += 4
    if n - i >= 2:
        h = add(h, struct.unpack_from("<H", data, i)[0])
        i += 2
    if n - i >= 1:
        h = add(h, data[i])
    return h


class SipHash13:
    """SipHash-1-3 (Rust's DefaultHasher with zero keys)."""

    def __init__(self, k0: int = 0, k1: int = 0):
        self.v0 = k0 ^ 0x736F6D6570736575
        self.v1 = k1 ^ 0x646F72616E646F6D
        self.v2 = k0 ^ 0x6C7967656E657261
        self.v3 = k1 ^ 0x7465646279746573
        self.buf = b""
        self.length = 0

    def _round(self):
        v0, v1, v2, v3 = self.v0, self.v1, self.v2, self.v3
        v0 = (v0 + v1) & _M64
        v1 = _rol64(v1, 13) ^ v0
        v0 = _rol64(v0, 32)
        v2 = (v2 + v3) & _M64
        v3 = _rol64(v3, 16) ^ v2
        v0 = (v0 + v3) & _M64
        v3 = _rol64(v3, 21) ^ v0
        v2 = (v2 + v1) & _M64
        v1 = _rol64(v1, 17) ^ v2
        v2 = _rol64(v2, 32)
        self.v0, self.v1, self.v2, self.v3 = v0, v1, v2, v3

    def _compress(self, m: int):
        self.v3 ^= m
        self._round()  # one compression round
        self.v0 ^= m

    def write(self, data: bytes):
        self.length += len(data)
        self.buf += data
        while len(self.buf) >= 8:
            self._compress(struct.unpack_from("<Q", self.buf, 0)[0])
            self.buf = self.buf[8:]

    def finish(self) -> int:
        b = (self.length & 0xFF) << 56
        for i, c in enumerate(self.buf):
            b |= c << (8 * i)
        self._compress(b)
        self.v2 ^= 0xFF
        for _ in range(3):  # three finalization rounds
            self._round()
        return (self.v0 ^ self.v1 ^ self.v2 ^ self.v3) & _M64


def siphash13_of_mers(mers: Sequence[int], mer_width: int = 32) -> int:
    """Rust ``Vec<H>.hash(&mut DefaultHasher)`` then ``finish()``: a usize
    length prefix, then the slice's LE bytes, through SipHash-1-3(0, 0)."""
    h = SipHash13()
    h.write(struct.pack("<Q", len(mers)))
    h.write(_mer_bytes(mers, mer_width))
    return h.finish()


@dataclass
class KminmerVec:
    """The reference's KminmerVec (kminmer.rs:18-126)."""

    mers: List[int]
    start: int = 0
    end: int = 0
    offset: int = 0
    rev: bool = False
    mer_width: int = field(default=32, compare=False)

    def __post_init__(self):
        self.mers = [int(m) for m in self.mers]
        self.normalize()

    def normalize(self):
        """Canonical = lexicographic min of (mers, reversed) (:54-61)."""
        rev_mers = self.mers[::-1]
        if rev_mers < self.mers:
            self.mers = rev_mers
            self.rev = True

    def is_normalized(self) -> bool:
        return self.mers <= self.mers[::-1]

    def print(self) -> str:
        """The first 2 decimal digits of each mer (:71-78)."""
        return "".join(f"{str(m)[:2]} " for m in self.mers)

    def get_hash(self) -> int:
        """The generic path (:42-47): DefaultHasher (SipHash-1-3), with the
        reference's performance warning."""
        warnings.warn(
            "[warning, seq2kminmers] generic get_hash() method called; "
            "Shouldn't, it's a performance issue. Use KminmerHash instead"
        )
        return siphash13_of_mers(self.mers, self.mer_width)

    def get_hash_usize(self) -> int:
        return fxhash64_of_mers(self.mers, self.mer_width)

    def get_hash_u32(self) -> int:
        return fxhash32_of_mers(self.mers, self.mer_width)

    def get_hash_u64(self) -> int:
        return fxhash64_of_mers(self.mers, self.mer_width)

    # Equality and ordering on the mers only (:97-126).
    def __eq__(self, other):
        return self.mers == other.mers

    def __lt__(self, other):
        return self.mers < other.mers

    def __hash__(self):
        return hash(tuple(self.mers))


def kminmer_hash_from_mers(
    mers: Sequence[int], start: int, end: int, offset: int, mer_width: int = 32,
) -> KminmerRecord:
    """``Kminmer::new`` for KminmerHash (kminmer.rs:140-161): canonicalize,
    then hash = FxHash64 of the canonical mers vector."""
    mers = [int(m) for m in mers]
    rev = mers[::-1] < mers
    h = fxhash64_of_mers(mers[::-1] if rev else mers, mer_width)
    return KminmerRecord(hash=h, start=start, end=end, offset=offset, rev=rev)


def kminmers_vec(
    seq, l: int, k: int, density: float, mode=HashMode.Regular,
    hash_width: int = 32, device="cuda",
) -> List[KminmerVec]:
    """The pipeline's minimizer stream of one sequence as KminmerVec
    records (the reference's alternative KminmerType, src/lib.rs:39 and
    kminmer.rs:18): each window of k raw, unmixed minimizer hashes, from
    the first mer's start to the last mer's end."""
    spec = PipelineSpec(l=l, k=k, density=density, mode=_mode_name(mode),
                        hash_width=hash_width)
    out = run_single(seq, spec, _device(device))
    if out is None:
        return []
    n = int(out.n_minimizers[0])
    mers = out.min_hash[0, :n].cpu().numpy().view(np.uint32).astype(np.uint64)
    if hash_width == 64:
        hi = out.min_hash_hi[0, :n].cpu().numpy().view(np.uint32).astype(np.uint64)
        mers |= hi << np.uint64(32)
    start = out.min_start[0, :n].cpu().numpy()
    end = out.min_end[0, :n].cpu().numpy()
    mers = mers.tolist()
    return [
        KminmerVec(mers=mers[w : w + k], start=int(start[w]), end=int(end[w + k - 1]),
                   offset=w, mer_width=hash_width)
        for w in range(n - k + 1)
    ]
