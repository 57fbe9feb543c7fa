"""The port's k-min-mer data model (``kminmer.py``), ``HashMode`` and the
top-level names, against the reference package's on the CPU."""

import warnings

import jax  # noqa: F401  (the reference package's own import, made explicit)
import numpy as np
import pytest

import rust_seq2kminmers_torch as port
import rust_seq2kminmers_tpu as ref
from rust_seq2kminmers_torch import kminmer as pk
from rust_seq2kminmers_torch.api import KminmerRecord
from rust_seq2kminmers_tpu import kminmer as jk
from rust_seq2kminmers_tpu import oracle

WIDTHS = [16, 32, 64]


def _mers(rng, width, n):
    return [int(x) for x in rng.integers(0, 1 << width, size=n, dtype=np.uint64)]


@pytest.mark.parametrize("width", WIDTHS)
def test_hashers_equal_reference(width):
    rng = np.random.default_rng(width)
    for n in range(0, 10):
        for _ in range(3):
            mers = _mers(rng, width, n)
            for name in ("fxhash64_of_mers", "fxhash32_of_mers", "siphash13_of_mers"):
                assert getattr(pk, name)(mers, width) == getattr(jk, name)(mers, width), (
                    name, mers)
    for n in range(0, 41):
        data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        init = int(rng.integers(0, 1 << 63))
        assert pk.fxhash64_bytes(data) == jk.fxhash64_bytes(data)
        assert pk.fxhash64_bytes(data, init) == jk.fxhash64_bytes(data, init)
        mine, theirs = pk.SipHash13(), jk.SipHash13()
        for part in (data[: n // 3], data[n // 3 :]):  # streamed in two writes
            mine.write(part)
            theirs.write(part)
        assert mine.finish() == theirs.finish()


def test_kminmer_vec_semantics():
    """tests/test_kminmer_model.py's checks, on the port's KminmerVec, and
    every method equal to the reference's."""
    v = pk.KminmerVec(mers=[5, 2, 9])
    assert v.mers == [5, 2, 9] and v.rev is False
    w = pk.KminmerVec(mers=[9, 2, 5])
    assert w.mers == [5, 2, 9] and w.rev is True
    assert v == w and hash(v) == hash(w)
    assert v.is_normalized() and w.is_normalized()
    p = pk.KminmerVec(mers=[3, 7, 3])
    assert p.mers == [3, 7, 3] and p.rev is False
    a, b = pk.KminmerVec(mers=[1, 2, 3]), pk.KminmerVec(mers=[1, 2, 4])
    assert a < b and sorted([b, a]) == [a, b]
    assert pk.fxhash64_of_mers([0]) != pk.fxhash64_of_mers([0, 0])
    assert pk.fxhash64_of_mers([1, 2]) != pk.fxhash64_of_mers([2, 1])

    rng = np.random.default_rng(3)
    for width in WIDTHS:
        for n in (1, 2, 5, 8):
            mers = _mers(rng, width, n)
            kw = dict(mers=mers, start=3, end=40, offset=2, mer_width=width)
            mine, theirs = pk.KminmerVec(**kw), jk.KminmerVec(**kw)
            assert (mine.mers, mine.rev, mine.start, mine.end, mine.offset) == (
                theirs.mers, theirs.rev, theirs.start, theirs.end, theirs.offset)
            assert mine.is_normalized() == theirs.is_normalized()
            assert mine.print() == theirs.print()
            for method in ("get_hash_usize", "get_hash_u32", "get_hash_u64"):
                assert getattr(mine, method)() == getattr(theirs, method)()
            with pytest.warns(UserWarning, match="performance issue"):
                h = mine.get_hash()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                assert h == theirs.get_hash()


def test_kminmer_hash_from_mers_equals_reference():
    rng = np.random.default_rng(4)
    r1 = pk.kminmer_hash_from_mers([5, 2, 9], 0, 10, 0)
    r2 = pk.kminmer_hash_from_mers([9, 2, 5], 3, 14, 1)
    assert r1.hash == r2.hash and r1 == r2
    assert r1.rev is False and r2.rev is True
    assert isinstance(r1, KminmerRecord)
    for width in WIDTHS:
        for n in (1, 3, 5, 7):
            for mers in (_mers(rng, width, n), [7] * n, list(range(n)) + list(range(n))[::-1]):
                args = (mers, int(rng.integers(0, 1000)), int(rng.integers(0, 1000)), n)
                mine = pk.kminmer_hash_from_mers(*args, mer_width=width)
                theirs = jk.kminmer_hash_from_mers(*args, mer_width=width)
                assert (mine.hash, mine.start, mine.end, mine.offset, mine.rev) == (
                    theirs.hash, theirs.start, theirs.end, theirs.offset, theirs.rev)


def test_nthash1_minimizer_space_equals_reference():
    rng = np.random.default_rng(5)
    for k in range(1, 9):
        for _ in range(20):
            mers = _mers(rng, 64, k)
            assert pk.nthash1_minimizer_space(mers) == oracle.nthash1_minimizer_space(mers)
        same = [int(rng.integers(0, 1 << 63))] * k  # f == r: rev is False
        assert pk.nthash1_minimizer_space(same) == oracle.nthash1_minimizer_space(same)


VEC_CASES = [(m, 32) for m in ("regular", "simd", "hpc", "hpcsimd")] + [
    (m, w) for m in ("regular", "hpc") for w in (16, 64)
]


def _vec_fields(vecs):
    return [(v.mers, v.start, v.end, v.offset, v.rev, v.mer_width) for v in vecs]


@pytest.mark.parametrize("mode,width", VEC_CASES)
def test_kminmers_vec_equals_reference(ecoli_seq, mode, width):
    """The port reads the minimizers from the pipeline's stream, the
    reference from its oracle: the records must be the same."""
    seq = ecoli_seq[:12000]
    for l, k, d, hm in ((21, 5, 0.02, port.HashMode(mode)), (10, 3, 0.05, mode)):
        mine = pk.kminmers_vec(seq, l, k, d, hm, hash_width=width, device="cpu")
        theirs = jk.kminmers_vec(seq, l, k, d, oracle.HashMode(mode), hash_width=width)
        assert len(mine) > 10
        assert _vec_fields(mine) == _vec_fields(theirs)
    assert pk.kminmers_vec(seq[:21], 21, 5, 0.5, mode, width, device="cpu") == []
    for n, d in ((22, 1.0), (60, 0.01), (60, 0.3)):  # short reads: few windows
        mine = pk.kminmers_vec(seq[:n], 21, 5, d, mode, width, device="cpu")
        theirs = jk.kminmers_vec(seq[:n], 21, 5, d, oracle.HashMode(mode), width)
        assert _vec_fields(mine) == _vec_fields(theirs)


def test_kminmers_vec_needs_a_gpu_by_default(ecoli_seq):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        pk.kminmers_vec(ecoli_seq[:1000], 10, 3, 0.1)


# The names the reference package's __init__ exports (its lines 10-22).
SURFACE = [
    "KminmersIterator", "KSizeTooBig", "kminmers_list", "encode_bases",
    "hash_bound_u32", "hash_bound_simd_u32", "encode_rle", "encode_rle_simd",
    "hpc", "KminmerVec", "fxhash32_of_mers", "fxhash64_of_mers",
    "kminmer_hash_from_mers", "kminmers_vec", "HashMode", "KminmerRecord",
    "nthash1_minimizer_space", "kminmers_long", "kminmers_long_batch",
    "KminmerBatch", "PipelineSpec", "kminmer_pipeline", "make_pipeline", "__version__",
]


@pytest.mark.parametrize("name", SURFACE)
def test_top_level_surface(name):
    assert hasattr(ref, name)
    assert hasattr(port, name)
    assert name.startswith("__") or name in port.__all__


def test_top_level_values_equal_reference():
    assert port.__version__ == ref.__version__
    assert [(m.name, m.value) for m in port.HashMode] == [
        (m.name, m.value) for m in ref.HashMode]
    rng = np.random.default_rng(6)
    raw = rng.integers(0, 256, size=3000, dtype=np.uint8)
    raw[:1000] = rng.choice(np.frombuffer(b"ACGTNacgtn", dtype=np.uint8), size=1000)
    for seq in (raw, raw.tobytes(), raw.tobytes().decode("latin-1"), b"", "acgtN"):
        mine, theirs = port.encode_bases(seq), ref.encode_bases(seq)
        assert mine.dtype == theirs.dtype
        np.testing.assert_array_equal(mine, theirs)
    for d in [0.0, 1e-6, 0.001, 0.01, 0.1, 0.5, 1.0] + list(rng.random(50)):
        assert port.hash_bound_u32(d) == ref.hash_bound_u32(d)
        assert port.hash_bound_simd_u32(d) == ref.hash_bound_simd_u32(d)
