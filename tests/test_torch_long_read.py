"""The port's chunked long-read path (rust_seq2kminmers_torch/ops/
long_read.py) on the CPU, where every kernel runs its plain version,
against the reference package's in interpret mode and against the
oracle, in the cases of tests/test_long_read.py.  Every output is an
integer: equality is exact.  Each reference result is computed once, in a
module-scoped fixture."""

import numpy as np
import pytest
import torch

from rust_seq2kminmers_torch import kminmers_long, kminmers_long_batch
from rust_seq2kminmers_torch.constants import XCODE_PAD, encode_xcodes
from rust_seq2kminmers_torch.ops import long_read as port
from rust_seq2kminmers_torch.ops.pipeline import PipelineSpec
from rust_seq2kminmers_tpu.oracle import HashMode, minimizers
from rust_seq2kminmers_tpu.oracle import kminmers as oracle_kminmers
from rust_seq2kminmers_tpu.ops import long_read as jax_long
from rust_seq2kminmers_tpu.ops.pipeline import PipelineSpec as JaxSpec

KEYS = ("hash", "start", "end", "offset", "rev")


def _rand(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(list(alphabet), size=n))


def _runs_seq(seed):
    """Homopolymer runs of 800-3000 bases between short random stretches:
    chunks inside a run keep nothing in the hpc modes."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(14):
        parts.append(_rand(rng, int(rng.integers(30, 200))))
        parts.append(str(rng.choice(list("ACGT"))) * int(rng.integers(800, 3000)))
    return "".join(parts)


def _batch_seqs(seed):
    """Rows of 9000, 5200 and 7 bases with runs and N's."""
    rng = np.random.default_rng(seed)
    seqs = []
    for n in (9000, 5200, 7):
        parts, m = [], 0
        while m < n:
            if rng.random() < 0.25:
                p = str(rng.choice(list("ACGT"))) * int(rng.integers(2, 400))
            else:
                p = _rand(rng, int(rng.integers(30, 300)), "ACGTN")
            parts.append(p)
            m += len(p)
        seqs.append("".join(parts)[:n])
    return seqs


SEQS = {
    "mixed": lambda: _rand(np.random.default_rng(1), 9000, "AACCGGTTAAAANN"),
    "runs": lambda: _runs_seq(2),
    "acgt6000": lambda: _rand(np.random.default_rng(3), 6000),
    "acgt700": lambda: _rand(np.random.default_rng(4), 700),
}


@pytest.fixture(scope="module")
def jax_records():
    """(seq name, kminmers_long keyword arguments) -> the reference's
    records, computed once."""
    cache = {}

    def get(name, **kw):
        key = (name, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = jax_long.kminmers_long(SEQS[name](), interpret=True, **kw)
        return cache[key]

    return get


def _assert_records(got, want):
    assert len(got["hash"]) == len(want["hash"])
    for key in KEYS:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _assert_oracle(got, seq, l, k, d, mode, hash_width=32, variant="nthash1"):
    ref = oracle_kminmers(seq, l, k, d, HashMode(mode), hash_width, variant)
    assert len(got["hash"]) == len(ref) > 0
    assert [int(h) for h in got["hash"]] == [r.hash for r in ref]
    assert got["start"].tolist() == [r.start for r in ref]
    assert got["end"].tolist() == [r.end for r in ref]
    assert got["offset"].tolist() == [r.offset for r in ref]
    assert got["rev"].tolist() == [r.rev for r in ref]


def _check(jax_records, name, l, k, d, mode, chunk, hash_width=32, variant="nthash1"):
    kw = dict(l=l, k=k, density=d, mode=mode, chunk=chunk, hash_width=hash_width,
              variant=variant)
    got = kminmers_long(SEQS[name](), device="cpu", **kw)
    _assert_records(got, jax_records(name, **kw))
    _assert_oracle(got, SEQS[name](), l, k, d, mode, hash_width, variant)


@pytest.mark.parametrize("mode", ["regular", "simd", "hpc", "hpcsimd"])
def test_long_read_multichunk_matches_reference(jax_records, mode):
    _check(jax_records, "mixed", 11, 3, 0.05, mode, 2048)


@pytest.mark.parametrize("mode", ["hpc", "hpcsimd"])
@pytest.mark.parametrize("l,k,d", [(13, 3, 0.15), (31, 2, 0.3)])
def test_long_read_runs_spanning_whole_chunks(jax_records, mode, l, k, d):
    """Chunks inside a run keep no base: the carry passes through them."""
    _check(jax_records, "runs", l, k, d, mode, 1024)


@pytest.mark.parametrize("mode,d", [("regular", 0.05), ("hpc", 0.1)])
def test_long_read_nthash2_variant(jax_records, mode, d):
    _check(jax_records, "acgt6000", 45, 2, d, mode, 2048, variant="nthash2")


@pytest.mark.parametrize("hash_width", [16, 64])
@pytest.mark.parametrize("mode", ["regular", "hpc"])
def test_long_read_widths(jax_records, mode, hash_width):
    _check(jax_records, "mixed", 11, 3, 0.05, mode, 2048, hash_width=hash_width)


def test_long_read_single_chunk_and_short(jax_records):
    _check(jax_records, "acgt700", 9, 2, 0.2, "hpcsimd", 1024)
    got = kminmers_long("ACGTACG", l=10, k=2, density=0.5, device="cpu")
    assert all(len(got[key]) == 0 for key in KEYS)
    assert got["hash"].dtype == np.uint64 and got["rev"].dtype == bool


def test_long_read_batch_matches_per_read():
    """Rows of different lengths ride the same launches, one shorter than
    l: each row equals its own kminmers_long run, the reference's batch
    and the oracle."""
    seqs = _batch_seqs(5)
    kw = dict(l=13, k=3, density=0.08, mode="hpcsimd", chunk=2048)
    batch = kminmers_long_batch(seqs, device="cpu", **kw)
    want = jax_long.kminmers_long_batch(seqs, interpret=True, **kw)
    assert len(batch) == 3 and len(batch[2]["hash"]) == 0
    for seq, got, ref in zip(seqs, batch, want):
        _assert_records(got, ref)
        _assert_records(got, kminmers_long(seq, device="cpu", **kw))
    for seq, got in zip(seqs[:2], batch[:2]):
        _assert_oracle(got, seq, 13, 3, 0.08, "hpcsimd")


def _oracle_stream(seq, l, d, mode):
    return [tuple(int(x) for x in m) for m in minimizers(seq, l, d, HashMode(mode))]


def test_minimizer_stream_overflow_rescue(monkeypatch):
    """128 survivor slots a tile at d = 0.9 overflow every chunk: phase C
    reruns them on the lossless capacity and loses nothing."""
    seq = "ACGT" * 1500
    codes = encode_xcodes(seq, "scalar")
    spec = PipelineSpec(l=5, k=2, density=0.9, mode="regular", tile_cap=128)
    rescues, real = [], port.rescue_spec

    def rescue_spec(s, needed):
        rescues.append(needed)
        return real(s, needed)

    monkeypatch.setattr(port, "rescue_spec", rescue_spec)
    st, en, hs = port.minimizer_stream_long(codes, spec, chunk=1024, device="cpu")
    assert len(rescues) == 1 and rescues[0] > 128
    jst, jen, jhs = jax_long.minimizer_stream_long(
        codes, JaxSpec(l=5, k=2, density=0.9, mode="regular", rows_out=8, slots=8),
        chunk=1024, interpret=True,
    )
    for g, w in ((st, jst), (en, jen), (hs, jhs)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    got = list(zip(st.tolist(), en.tolist(), hs.tolist()))
    assert got == _oracle_stream(seq, 5, 0.9, "regular")


def test_minimizer_stream_capacity_far_above_chunk():
    """max_minimizers far above the chunk: the stream is exact and only its
    valid prefixes come back."""
    seq = _rand(np.random.default_rng(6), 50000)
    codes = encode_xcodes(seq, "simd")
    spec = PipelineSpec(l=13, k=3, density=0.05, mode="hpcsimd", max_minimizers=200000)
    st, en, hs = port.minimizer_stream_long(codes, spec, chunk=8192, device="cpu")
    jst, jen, jhs = jax_long.minimizer_stream_long(
        codes, JaxSpec(l=13, k=3, density=0.05, mode="hpcsimd", max_minimizers=200000),
        chunk=8192, interpret=True,
    )
    for g, w in ((st, jst), (en, jen), (hs, jhs)):
        np.testing.assert_array_equal(g, w)
    got = list(zip(st.tolist(), en.tolist(), hs.tolist()))
    assert got == _oracle_stream(seq, 13, 0.05, "hpcsimd")


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32, np.uint64])
def test_assemble_stream_tiling(dtype):
    """The port's one [1, M] row gives the same windows as the reference's
    assembly over rows of 256 overlapping by k - 1, at every mix."""
    rng = np.random.default_rng(7)
    m = rng.integers(0, np.iinfo(dtype).max, size=1337, dtype=np.uint64).astype(dtype)
    k = 5
    got = port.assemble_stream(m, k, device="cpu")
    want = jax_long.assemble_stream(m, k, interpret=True, tile=256)
    assert got[0].dtype == np.uint64 and got[1].dtype == bool
    assert got[0].shape == (1337 - k + 1,)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert port.assemble_stream(m[:4], k, device="cpu")[0].shape == (0,)


def test_staging_and_limits():
    """The staged chunks carry every read's codes unchanged, padded with
    XCODE_PAD past its end; reads of 2^31 bases and l outside K1's carry
    are refused."""
    codes = encode_xcodes(SEQS["mixed"](), "scalar")
    spec = PipelineSpec(l=11, k=3, density=0.05, mode="hpc")
    rows = [codes, codes[:3000]]
    staging = port._Staging(rows, 2048, torch.device("cpu"))
    staged = np.concatenate([staging.upload(ci).numpy() for ci in range(5)], axis=1)
    for row, got in zip(rows, staged):
        np.testing.assert_array_equal(got[: len(row)], row)
        assert (got[len(row) :] == XCODE_PAD).all()
    huge = np.broadcast_to(np.uint8(9), (1 << 31,))  # no memory behind it
    with pytest.raises(ValueError, match="exceeds"):
        port.minimizer_stream_long(huge, spec, device="cpu")
    with pytest.raises(ValueError, match="carry"):
        port.minimizer_stream_long(codes, PipelineSpec(l=301, k=3, density=0.05), device="cpu")


def test_prof_long_read_device_busy():
    """The long-read profiler counts overlapping device spans once."""
    from types import SimpleNamespace

    from rust_seq2kminmers_torch.scripts.prof_long_read import device_busy

    def ev(s, e):
        return SimpleNamespace(time_range=SimpleNamespace(start=s, end=e))

    spans = [ev(0, 100), ev(50, 150), ev(300, 400), ev(310, 320)]
    assert device_busy(spans) == (250 / 1e6, 310 / 1e6)
    assert device_busy([]) == (0, 0)
