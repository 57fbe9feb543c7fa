"""The port's numpy oracle (``rust_seq2kminmers_torch/oracle.py``) held
equal to the reference package's, function for function, across the four
modes, widths 16/32/64, nthash1 and nthash2, l in {1, 2, 31, 100, 255,
301}, the burn-in's five alphabets and lengths from 0 to a few kb; the
reference crate's golden hashes; and ``kminmers_list(backend="oracle")``.
Every value is an integer and every comparison exact."""

import jax  # noqa: F401  (the reference package's own import, made explicit)
import numpy as np
import pytest

from rust_seq2kminmers_torch import KminmersIterator, KSizeTooBig, api, kminmers_list
from rust_seq2kminmers_torch import oracle as po
from rust_seq2kminmers_torch.constants import code_table, encode_xcodes, family_of_mode
from rust_seq2kminmers_torch.scripts.burnin import ALPHABETS, gen_seq
from rust_seq2kminmers_tpu import oracle as jo
from rust_seq2kminmers_tpu.api import kminmers_list as jax_kminmers_list
from test_goldens import GOLDEN_HASHES_U32, GOLDEN_HASHES_U64

FIXTURE = "tests/data/ecoli.genome.100k.fa"
LS = [1, 2, 31, 100, 255, 301]
WIDTHS_VARIANTS = {
    "regular": [(16, "nthash1"), (32, "nthash1"), (64, "nthash1"), (32, "nthash2")],
    "hpc": [(16, "nthash1"), (32, "nthash1"), (64, "nthash1"), (32, "nthash2")],
    "simd": [(32, "nthash1"), (32, "nthash2")],
    "hpcsimd": [(32, "nthash1"), (32, "nthash2")],
}
CASES = [
    (mode, width, variant, l)
    for mode, wvs in WIDTHS_VARIANTS.items()
    for width, variant in wvs
    for l in LS
]


def _fields(records):
    return [(r.hash, r.start, r.end, r.offset, r.rev) for r in records]


def _equal_arrays(mine, ref):
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize(
    "mode,width,variant,l", CASES, ids=[f"{m}-u{w}-{v}-l{l}" for m, w, v, l in CASES]
)
def test_oracle_equals_reference(mode, width, variant, l):
    """Every public function of the port's oracle against the reference's
    on two sequences of this case: one at an edge length (0, 1, l or
    l + 1) and one of l + 1 to ~4 kb, in two of the five alphabets; the
    second passed as pre-encoded xcodes to the record-level functions."""
    i = CASES.index((mode, width, variant, l))
    rng = np.random.default_rng(1000 + i)
    k = 1 + i % 8
    d = (0.01, 0.05, 0.1, 0.3)[i % 4]
    pmode, jmode = po.HashMode(mode), jo.HashMode(mode)
    lengths = [(0, 1, l, l + 1)[i % 4], int(rng.integers(l + 1, 4000))]
    for j, n in enumerate(lengths):
        seq = gen_seq(rng, ALPHABETS[(i + j) % len(ALPHABETS)], n)
        codes = code_table(family_of_mode(mode))[np.frombuffer(seq.encode(), np.uint8)]
        _equal_arrays(po.sliding_nthash32(codes, l), jo.sliding_nthash32(codes, l))
        _equal_arrays(po.sliding_nthash(codes, l, width), jo.sliding_nthash(codes, l, width))
        _equal_arrays(po.sliding_nthash2_31(codes, l), jo.sliding_nthash2_31(codes, l))
        _equal_arrays(po.hpc_compress(codes), jo.hpc_compress(codes))
        arg = encode_xcodes(seq, family_of_mode(mode)) if j else seq
        mins = po.minimizers(arg, l, d, pmode, width, variant)
        assert mins == jo.minimizers(arg, l, d, jmode, width, variant)
        recs = po.kminmers(arg, l, k, d, pmode, width, variant)
        assert _fields(recs) == _fields(jo.kminmers(arg, l, k, d, jmode, width, variant))
        hashes = np.array([m[2] for m in mins], dtype=np.uint64)
        for fn in ("mixhash_u32", "mixhash_u16"):
            _equal_arrays([getattr(po, fn)(hashes)], [getattr(jo, fn)(hashes)])
        mixed = po.mixhash(hashes, width)
        _equal_arrays([mixed], [jo.mixhash(hashes, width)])
        for w in range(max(len(mixed) - k + 1, 0)):
            window = mixed[w : w + k]
            assert po.nthash1_minimizer_space(window) == jo.nthash1_minimizer_space(window)
            assert po.nthash1_minimizer_space(window) == (recs[w].hash, recs[w].rev)


@pytest.mark.parametrize(
    "width,goldens", [(32, GOLDEN_HASHES_U32), (64, GOLDEN_HASHES_U64)], ids=["u32", "u64"]
)
def test_oracle_reproduces_goldens(width, goldens):
    """The reference crate's golden hashes (tests/main.rs:18-57): regular,
    l=10, k=5, d=0.0001, on the fixture."""
    seq = open(FIXTURE).readlines()[1].strip()
    recs = po.kminmers(seq, 10, 5, 0.0001, po.HashMode.Regular, hash_width=width)
    assert [r.hash for r in recs] == goldens


API_CASES = [
    ("regular", 10, 32, "nthash1"),
    ("hpc", 15, 64, "nthash1"),
    ("simd", 31, 32, "nthash1"),
    ("hpcsimd", 12, 32, "nthash1"),
    ("regular", 45, 32, "nthash2"),
    ("hpc", 301, 16, "nthash1"),
    ("regular", 1, 64, "nthash1"),
]


@pytest.mark.parametrize("mode,l,width,variant", API_CASES)
def test_kminmers_list_oracle_backend(mode, l, width, variant):
    """backend="oracle" equals the reference package's oracle backend and
    the port's pipeline on the CPU, for str, bytes and xcodes; the
    iterator takes the same keyword; the oracle ignores ``device``."""
    rng = np.random.default_rng(l)
    seq = gen_seq(rng, ALPHABETS[l % len(ALPHABETS)], 3000)
    kw = dict(strict_limits=False, hash_width=width, variant=variant)
    want = _fields(jax_kminmers_list(seq, l, 3, 0.05, mode, backend="oracle", **kw))
    assert want
    for arg in (seq, seq.encode(), encode_xcodes(seq, family_of_mode(mode))):
        assert _fields(kminmers_list(arg, l, 3, 0.05, mode, backend="oracle", **kw)) == want
    assert _fields(kminmers_list(seq, l, 3, 0.05, mode, device="cpu", **kw)) == want
    assert _fields(kminmers_list(seq, l, 3, 0.05, po.HashMode(mode), "cuda",
                                 backend="oracle", **kw)) == want
    it = KminmersIterator(seq, l, 3, 0.05, mode, backend="oracle", **kw)
    assert _fields(it) == want and len(it) == len(want)


def test_strict_limits_raise_before_the_oracle(monkeypatch):
    def never(*args, **kwargs):
        raise AssertionError("the oracle ran")

    monkeypatch.setattr(api, "oracle_kminmers", never)
    for mode, l in (("simd", 32), ("hpcsimd", 40), ("hpc", 256)):
        with pytest.raises(KSizeTooBig):
            kminmers_list("ACGT" * 100, l, 3, 0.1, mode, backend="oracle")
        with pytest.raises(KSizeTooBig):
            KminmersIterator("ACGT" * 100, l, 3, 0.1, mode, backend="oracle")


@pytest.mark.parametrize("backend", ["jax", "numpy", "", None])
def test_unknown_backend_raises(backend):
    with pytest.raises(ValueError, match="backend"):
        kminmers_list("ACGT" * 100, 10, 3, 0.1, "regular", "cpu", backend=backend)
