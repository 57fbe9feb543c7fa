"""The port's general path (l = 1 or l > 255: HPC compaction, whole-row
hashing, K4 compaction of the minimizer stream, K3) against the reference
package's general path: with its K4 Pallas kernel in interpret mode, and
through its default XLA compaction over every mode and width.  Then the
API on both paths: record for record against the reference's numpy oracle,
the 20 u64 golden hashes, and the reference's l limits.  All 12
KminmerBatch fields are integers and compared exactly, dtypes included."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_seq2kminmers_torch import KminmersIterator, KSizeTooBig, kminmers_list
from rust_seq2kminmers_torch.api import kminmers_batch
from rust_seq2kminmers_torch.constants import XCODE_PAD, encode_xcodes, family_of_mode
from rust_seq2kminmers_torch.convert import batch_to_numpy, spec_from_jax
from rust_seq2kminmers_torch.ops.pipeline import (
    PipelineSpec,
    kminmer_pipeline,
    kminmer_pipeline_plain,
)
from rust_seq2kminmers_tpu.ops.pipeline import KminmerBatch as JaxBatch
from rust_seq2kminmers_tpu.ops.pipeline import PipelineSpec as JaxSpec
from rust_seq2kminmers_tpu.api import kminmers_list as jax_kminmers_list
from rust_seq2kminmers_tpu.ops.pipeline import kminmer_pipeline as jax_pipeline
from rust_seq2kminmers_tpu.oracle import HashMode
from rust_seq2kminmers_tpu.oracle import kminmers as oracle_kminmers
from test_goldens import GOLDEN_HASHES_U64

GOLDENS_U64 = Path(__file__).parent / "data" / "goldens_u64.json"
MODES = ["regular", "simd", "hpc", "hpcsimd"]
WIDTHS = [(32, "nthash1"), (16, "nthash1"), (64, "nthash1"), (32, "nthash2")]


def _valid(mode, hash_width):
    return hash_width == 32 or mode in ("regular", "hpc")


def _density(l):
    # l = 1 hashes single bases: few distinct values, so select densely.
    return 0.6 if l == 1 else 0.05


def _batch(seed, mode, B=2, L=1024, alphabet="AACCGGTTAANNacgtQ"):
    rng = np.random.default_rng(seed)
    codes = np.full((B, L), XCODE_PAD, dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    for b in range(B):
        n = int(rng.integers(L // 2, L - 1))
        s = "".join(rng.choice(list(alphabet), size=n))
        codes[b, :n] = encode_xcodes(s, family_of_mode(mode))
        lengths[b] = n
    return codes, lengths


def _assert_matches(mode, l, hash_width, variant, compaction, max_minimizers=None):
    codes, lengths = _batch(seed=l + hash_width + len(mode), mode=mode)
    jspec = JaxSpec(
        l=l, k=3, density=_density(l), mode=mode, max_minimizers=max_minimizers,
        hash_width=hash_width, variant=variant, compaction=compaction,
    )
    want = jax.jit(lambda c, n: jax_pipeline(c, n, jspec))(
        jnp.asarray(codes), jnp.asarray(lengths)
    )
    spec = spec_from_jax(jspec)
    assert not spec.fused
    got = batch_to_numpy(
        kminmer_pipeline(torch.from_numpy(codes), torch.from_numpy(lengths), spec)
    )
    assert int(got.n_kminmers.min()) > 0
    for name in JaxBatch._fields:
        have, ref = getattr(got, name), np.asarray(getattr(want, name))
        assert have.dtype == ref.dtype, name
        np.testing.assert_array_equal(have, ref, err_msg=name)
    return got


INTERPRET_CASES = [
    ("regular", 1, 32, "nthash1"),
    ("hpc", 1, 16, "nthash1"),
    ("hpcsimd", 1, 32, "nthash1"),
    ("simd", 256, 32, "nthash1"),
    ("hpc", 256, 64, "nthash1"),
    ("regular", 256, 32, "nthash2"),
    ("regular", 301, 16, "nthash1"),
    ("hpcsimd", 301, 32, "nthash2"),
]


@pytest.mark.parametrize("mode,l,hash_width,variant", INTERPRET_CASES)
def test_general_path_matches_reference_k4(mode, l, hash_width, variant):
    """Against the reference's TPU route: both compactions through its K4
    Pallas kernel, in interpret mode."""
    _assert_matches(mode, l, hash_width, variant, "pallas_interpret")


# l = 256 runs in the K4 cases above and in the API sweep below, as do
# the K4 cases' own configurations.
SWEEP = [
    (mode, l, w, v) for mode in MODES for l in (1, 301) for w, v in WIDTHS
    if _valid(mode, w) and (mode, l, w, v) not in INTERPRET_CASES
]


@pytest.mark.parametrize("mode,l,hash_width,variant", SWEEP)
def test_general_path_matches_reference(mode, l, hash_width, variant):
    """Every mode, width and variant against the reference's default XLA
    compaction, which equals its K4 route."""
    _assert_matches(mode, l, hash_width, variant, "auto")


def test_general_path_stream_overflow():
    """A stream capacity below the selected count: both drop the same
    minimizers past M and report the unclipped count."""
    got = _assert_matches("hpc", 1, 32, "nthash1", "auto", max_minimizers=40)
    assert (got.n_minimizers_raw > got.n_minimizers).all()


@pytest.mark.parametrize("l", [1, 256])
def test_general_plain_pipeline_is_the_cpu_path(l):
    codes, lengths = _batch(seed=8, mode="hpc")
    spec = PipelineSpec(l=l, k=4, density=_density(l), mode="hpc", hash_width=64)
    a = kminmer_pipeline(torch.from_numpy(codes), torch.from_numpy(lengths), spec)
    b = kminmer_pipeline_plain(
        torch.from_numpy(codes), torch.from_numpy(lengths), spec
    )
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _records(recs):
    return [(r.hash, r.start, r.end, r.offset, r.rev) for r in recs]


API_CASES = [
    (mode, l, w, v) for mode in MODES for l in (1, 31, 256, 301) for w, v in WIDTHS
    if _valid(mode, w)
]


@pytest.mark.parametrize("mode,l,hash_width,variant", API_CASES)
def test_kminmers_list_matches_oracle(ecoli_seq, mode, l, hash_width, variant):
    """Both paths through the API, record for record, on the E. coli
    fixture."""
    seq = ecoli_seq[:20000]
    d = 0.3 if l == 1 else 0.01
    got = kminmers_list(
        seq, l, 3, d, mode, device="cpu", strict_limits=False,
        hash_width=hash_width, variant=variant,
    )
    want = oracle_kminmers(seq, l, 3, d, HashMode(mode), hash_width, variant)
    assert len(want) > 0
    assert _records(got) == _records(want)


def test_u64_goldens(ecoli_seq):
    """The 20 u64 golden hashes (regular, l=10, k=5, d=0.0001,
    hash_width=64; the list of tests/test_goldens.py)."""
    g = json.loads(GOLDENS_U64.read_text())
    assert g["hashes"] == GOLDEN_HASHES_U64
    it = KminmersIterator(
        ecoli_seq, g["l"], g["k"], g["density"], g["mode"], device="cpu",
        hash_width=g["hash_width"],
    )
    assert [km.get_hash() for km in it] == g["hashes"]


@pytest.mark.parametrize("l", [1, 256, 301])
def test_l_outside_the_fused_range_returns_records(ecoli_seq, l):
    """l = 1 and l > 255 run the general path instead of raising."""
    seq = ecoli_seq[:5000]
    got = kminmers_list(seq, l, 2, _density(l), "regular", device="cpu")
    want = oracle_kminmers(seq, l, 2, _density(l), HashMode.Regular)
    assert len(got) > 0 and _records(got) == _records(want)


def test_ksize_limits_match_reference():
    """nthash1 under strict_limits: SIMD modes stop at l = 31 and hpc at
    l = 255; nthash2 and strict_limits=False lift both."""
    seq = "ACGTTGCA" * 80
    with pytest.raises(KSizeTooBig):
        kminmers_list(seq, 32, 3, 0.1, "hpcsimd", device="cpu")
    with pytest.raises(KSizeTooBig):
        kminmers_list(seq, 256, 3, 0.1, "hpc", device="cpu")
    with pytest.raises(KSizeTooBig):
        KminmersIterator(seq, 300, 3, 0.1, "hpc", device="cpu")
    assert kminmers_list(seq, 255, 2, 0.5, "hpc", device="cpu") is not None
    for kw in (dict(variant="nthash2"), dict(strict_limits=False)):
        for mode, l in (("simd", 40), ("hpc", 256)):
            recs = kminmers_list(seq, l, 2, 0.5, mode, device="cpu", **kw)
            want = oracle_kminmers(
                seq, l, 2, 0.5, HashMode(mode), 32, kw.get("variant", "nthash1")
            )
            assert _records(recs) == _records(want)


@pytest.mark.parametrize("seq", ["ACG", "ACGT" * 100])
def test_unknown_mode_raises_like_reference(seq):
    """An unknown mode raises ValueError before any length check, as the
    reference's HashMode(...) does, on a read shorter than l too."""
    with pytest.raises(ValueError):
        jax_kminmers_list(seq, 10, 3, 0.1, "foo")
    with pytest.raises(ValueError):
        kminmers_list(seq, 10, 3, 0.1, "foo", device="cpu")
    with pytest.raises(ValueError):
        KminmersIterator(seq, 10, 3, 0.1, "foo", device="cpu")
    assert kminmers_list(seq[:3], 10, 3, 0.1, HashMode.Hpc, device="cpu") == []


def test_general_path_rescue_is_lossless(ecoli_seq):
    """On the general path only the stream capacity M can overflow; the
    rescue raises it until nothing is lost."""
    seq = ecoli_seq[:20000]
    codes = np.full((1, 32768), XCODE_PAD, dtype=np.uint8)
    codes[0, : len(seq)] = encode_xcodes(seq, "scalar")
    lengths = torch.tensor([len(seq)], dtype=torch.int32)
    spec = PipelineSpec(l=301, k=3, density=0.05, mode="hpc", max_minimizers=64)
    out = kminmers_batch(torch.from_numpy(codes), lengths, spec)
    assert torch.equal(out.n_minimizers, out.n_minimizers_raw)
    want = oracle_kminmers(seq, 301, 3, 0.05, HashMode.Hpc)
    nk = int(out.n_kminmers[0])
    assert nk == len(want) > 64
    assert out.start[0, :nk].tolist() == [r.start for r in want]
