"""The port's chunked long-read path (rust_seq2kminmers_torch/ops/
long_read.py) on the CPU, where every kernel runs its plain version,
against the reference package's in interpret mode and against the
oracle, in the cases of tests/test_long_read.py.  Every output is an
integer: equality is exact.  Each reference result is computed once, in a
module-scoped fixture."""

import threading

import numpy as np
import pytest
import torch

from rust_seq2kminmers_torch import kminmers_long, kminmers_long_batch
from rust_seq2kminmers_torch.constants import XCODE_PAD, encode_xcodes, family_of_mode
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
    """The producer thread stages every chunk in order, each read's codes
    unchanged and padded with XCODE_PAD past its end (a read that ended
    before a chunk is all padding there); reads of 2^31 bases and l
    outside K1's carry are refused."""
    codes = encode_xcodes(SEQS["mixed"](), "scalar")
    spec = PipelineSpec(l=11, k=3, density=0.05, mode="hpc")
    rows = [codes, codes[:3000], codes[:0]]
    staging = port._Staging(rows, 2048, torch.device("cpu"))
    seen = []
    staging.run(range(5), lambda ci, t: seen.append((ci, t.numpy().copy())))
    assert [ci for ci, _ in seen] == list(range(5))
    staged = np.concatenate([t for _, t in seen], axis=1)
    for row, got in zip(rows, staged):
        np.testing.assert_array_equal(got[: len(row)], row)
        assert (got[len(row) :] == XCODE_PAD).all()
    seen.clear()
    staging.run(np.array([3, 1]), lambda ci, t: seen.append((ci, t.numpy().copy())))
    assert [ci for ci, _ in seen] == [3, 1]
    np.testing.assert_array_equal(seen[1][1], staged[:, 2048:4096])
    huge = np.broadcast_to(np.uint8(9), (1 << 31,))  # no memory behind it
    with pytest.raises(ValueError, match="exceeds"):
        port.minimizer_stream_long(huge, spec, device="cpu")
    with pytest.raises(ValueError, match="carry"):
        port.minimizer_stream_long(codes, PipelineSpec(l=301, k=3, density=0.05), device="cpu")


def _threads_after(fn):
    """Run fn, which must raise; -> the threads it left behind."""
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="injected"):
        fn()
    return set(threading.enumerate()) - before


def test_producer_exception_reaches_caller(monkeypatch):
    """An exception in the producer thread (here in its fill of chunk 2)
    is raised to the caller, and the thread is joined."""
    real = port._Staging._fill

    def fill(self, ci, buf):
        if ci == 2:
            raise RuntimeError("injected fill fault")
        return real(self, ci, buf)

    monkeypatch.setattr(port._Staging, "_fill", fill)
    codes = encode_xcodes(SEQS["mixed"](), "scalar")
    spec = PipelineSpec(l=11, k=3, density=0.05, mode="regular")
    left = _threads_after(
        lambda: port.minimizer_stream_long(codes, spec, chunk=1024, device="cpu"))
    assert not left


def test_consumer_exception_stops_producer(monkeypatch):
    """An exception in the dispatching thread (the chunk step raising on
    chunk 2 of 9) stops the producer before it stages every chunk, and
    joins it."""
    real_step, real_fill = port._chunk_step, port._Staging._fill
    filled = []

    def chunk_step(spec, chunk):
        step, calls = real_step(spec, chunk), []

        def failing(*args):
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("injected step fault")
            return step(*args)

        return failing

    def fill(self, ci, buf):
        filled.append(ci)
        return real_fill(self, ci, buf)

    monkeypatch.setattr(port, "_chunk_step", chunk_step)
    monkeypatch.setattr(port._Staging, "_fill", fill)
    codes = encode_xcodes(SEQS["mixed"](), "scalar")
    spec = PipelineSpec(l=11, k=3, density=0.05, mode="regular")
    left = _threads_after(
        lambda: port.minimizer_stream_long(codes, spec, chunk=1024, device="cpu"))
    assert not left
    assert filled == sorted(filled) and 3 <= len(filled) < 9


@pytest.mark.parametrize("mode,hash_width", [("hpcsimd", 32), ("regular", 64), ("hpc", 16)])
def test_chunk_step_counts_are_outputs(mode, hash_width):
    """The chunk step returns each chunk's (n_min, n_raw) as outputs: they
    equal the rows K2 wrote in place into the counts tensor before, and
    the stream and carry are those of K1 and K2 called directly."""
    from rust_seq2kminmers_torch.ops.cuda.fused_scan import TILE, fused_minimizer_scan
    from rust_seq2kminmers_torch.ops.cuda.slot_compact import slot_compact_counts

    spec = PipelineSpec(l=11, k=3, density=0.05, mode=mode, hash_width=hash_width)
    fam = "simd" if mode in ("simd", "hpcsimd") else "scalar"
    rows = [encode_xcodes(_rand(np.random.default_rng(s), 6000), fam) for s in (8, 9)]
    chunk, nchunks, B = 2048, 3, 2
    lengths = np.array([6000, 6000])
    step = port._chunk_step(spec, chunk)
    m_cap = spec.capacity_for(chunk)
    limit = torch.full((B,), port.HPC_LIMIT if spec.is_hpc else 6000 - spec.l,
                       dtype=torch.int32)
    base, carry = torch.zeros(B, dtype=torch.int32), torch.zeros((B, spec.l), dtype=torch.int32)
    cacc = torch.full((nchunks, 2, B), -1, dtype=torch.int32)
    staging = port._Staging(rows, chunk, torch.device("cpu"))
    for ci in range(nchunks):
        codes = torch.from_numpy(staging._fill(ci, np.empty((B, chunk), np.uint8)))
        local = torch.from_numpy(np.clip(lengths - ci * chunk, 0, chunk).astype(np.int32))
        *cols, n_min, n_raw, base_next, carry_next = step(codes, local, limit, base, carry)
        st, en, hs, counts, carry_out = fused_minimizer_scan(
            codes, local, limit, spec.l, spec.bound, spec.strict_threshold, spec.is_hpc,
            spec.mode == "hpc", TILE, spec.cap_per_tile(TILE), spec.hash_width,
            spec.variant, base0=base, carry0=carry, emit_carry=True)
        (mst, men, mhs), _, _ = slot_compact_counts(
            st, en, hs, counts, m_cap, fill=False, n_min=cacc[ci, 0], n_raw=cacc[ci, 1])
        assert torch.equal(n_min, cacc[ci, 0]) and torch.equal(n_raw, cacc[ci, 1])
        want = [mst, men, *((mhs[1], mhs[0]) if hash_width == 64 else (mhs,))]
        assert len(cols) == len(want)
        for b in range(B):
            n = int(n_min[b])
            for g, w in zip(cols, want):
                assert torch.equal(g[b, :n], w[b, :n])
        assert torch.equal(base_next, base + counts[:, :, 2].sum(dim=1, dtype=torch.int32))
        assert torch.equal(carry_next, carry_out - (chunk << 3))
        base, carry = base_next, carry_next
    assert (cacc >= 0).all() and int(cacc[:, 0].sum()) > 0


def _short_tail_seqs():
    """A 6000-base read, one of 36 bases (a stream of 2 minimizers, fewer
    than k = 5, at d = 0.3, l = 31) and one of 20 (not longer than l)."""
    rng = np.random.default_rng(12)
    return [_rand(rng, 6000), _rand(rng, 36), _rand(rng, 20)]


DEVICE_ASSEMBLY_CASES = {
    "unequal-batch": (lambda: _batch_seqs(5), dict(l=13, k=3, density=0.08, mode="hpcsimd")),
    "few-minimizers": (_short_tail_seqs, dict(l=31, k=5, density=0.3, mode="regular")),
    "u16": (lambda: [SEQS["mixed"](), SEQS["acgt700"]()],
            dict(l=11, k=3, density=0.05, mode="hpc", hash_width=16)),
    "u64": (lambda: [SEQS["mixed"](), SEQS["acgt700"]()],
            dict(l=11, k=3, density=0.05, mode="regular", hash_width=64)),
    "nthash2": (lambda: [SEQS["acgt6000"](), SEQS["acgt700"]()],
                dict(l=45, k=2, density=0.05, mode="regular", variant="nthash2")),
}


@pytest.mark.parametrize("case", list(DEVICE_ASSEMBLY_CASES))
def test_device_stream_assembly(case):
    """K3 on the flat device-resident stream (the windows that straddle two
    reads dropped) gives each read the records of ``assemble_stream`` over
    its own minimizer stream, and the reference's."""
    make, kw = DEVICE_ASSEMBLY_CASES[case]
    seqs = make()
    got = kminmers_long_batch(seqs, chunk=2048, device="cpu", **kw)
    spec = PipelineSpec(**{k: v for k, v in kw.items()})
    streams = port.minimizer_stream_long_batch(
        [encode_xcodes(s, family_of_mode(spec.mode)) for s in seqs], spec, chunk=2048,
        device="cpu")
    want = jax_long.kminmers_long_batch(seqs, chunk=2048, interpret=True, **kw)
    k = kw["k"]
    for g, (st, en, mh), ref in zip(got, streams, want):
        kh, rev = port.assemble_stream(mh, k, device="cpu")
        nk = len(kh)
        _assert_records(g, {"hash": kh, "start": st[:nk], "end": en[k - 1 :],
                            "offset": np.arange(nk, dtype=np.int64), "rev": rev})
        _assert_records(g, ref)
    assert len(got[0]["hash"]) > 0
    if case == "few-minimizers":
        assert 0 < len(streams[1][0]) < k and len(got[1]["hash"]) == 0
        assert len(streams[2][0]) == 0


def test_prof_long_read_device_busy():
    """The long-read profiler counts overlapping device spans once."""
    from types import SimpleNamespace

    from rust_seq2kminmers_torch.scripts.common import device_busy

    def ev(s, e):
        return SimpleNamespace(time_range=SimpleNamespace(start=s, end=e))

    spans = [ev(0, 100), ev(50, 150), ev(300, 400), ev(310, 320)]
    assert device_busy(spans) == (250 / 1e6, 310 / 1e6)
    assert device_busy([]) == (0, 0)
