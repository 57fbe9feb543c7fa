"""The port's host HPC strings (``hpc``, ``encode_rle``, ``encode_rle_simd``)
against the reference package's, value for value and dtype for dtype."""

import jax  # noqa: F401  (the reference package's own import, made explicit)
import numpy as np
import pytest

from rust_seq2kminmers_torch import hpc_strings as ph
from rust_seq2kminmers_tpu import hpc_strings as jh

FUNCS = ["hpc", "encode_rle", "encode_rle_simd"]


def _same(name, s):
    mine, ref = getattr(ph, name)(s), getattr(jh, name)(s)
    if name == "hpc":
        assert isinstance(mine, str) and mine == ref
        return
    assert isinstance(mine[0], str) and mine[0] == ref[0]
    assert mine[1].dtype == ref[1].dtype
    np.testing.assert_array_equal(mine[1], ref[1])


def _inputs(rng):
    """Byte strings: random over all 256 values, runs of non-ACGTN bytes
    (collapsed by hpc and encode_rle_simd, kept by encode_rle), runs of
    ACGTN in both cases, and tiny ones."""
    out = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes() for n in (1, 2, 17, 5000)]
    alphabet = np.frombuffer(b"ACGTNacgtnQ*-\x00\xff", dtype=np.uint8)
    for n in (3, 64, 4000):
        b = rng.choice(alphabet, size=n)
        out.append(np.repeat(b, rng.integers(1, 6, size=n)).tobytes())
    out += [b"QQQQ", b"A", b"AAAA", b"aAaA", b"NNnn**--ACGT", b"\x00\x00\xff\xff"]
    return out


@pytest.mark.parametrize("name", FUNCS)
def test_equal_on_ecoli(name, ecoli_seq):
    _same(name, ecoli_seq)
    _same(name, ecoli_seq.encode())


@pytest.mark.parametrize("name", FUNCS)
def test_equal_on_any_bytes(name):
    rng = np.random.default_rng(len(name))
    for s in _inputs(rng):
        _same(name, s)
        _same(name, bytearray(s))


@pytest.mark.parametrize("name", FUNCS)
def test_equal_on_str(name):
    """ASCII str, and str outside latin-1 (read as UTF-8 bytes by both)."""
    rng = np.random.default_rng(7 + len(name))
    for s in _inputs(rng):
        ascii_str = bytes(c & 0x7F for c in s).decode("ascii")
        _same(name, ascii_str)
    for s in ("ACGT→→TTA", "ααβAAC", "NN\U0001F600\U0001F600"):
        _same(name, s)


@pytest.mark.parametrize("name", FUNCS)
def test_empty_input(name):
    for s in ("", b"", bytearray()):
        _same(name, s)


def test_acgtn_input_agrees_across_functions(ecoli_seq):
    """On ACGTN-only input the three collapse the same runs (the
    reference's own check, tests/main.rs:76-78)."""
    s = ecoli_seq[:5000]
    chars, pos = ph.encode_rle(s)
    chars_simd, pos_simd = ph.encode_rle_simd(s)
    assert ph.hpc(s) == chars == chars_simd
    np.testing.assert_array_equal(pos, pos_simd.astype(np.int64))
