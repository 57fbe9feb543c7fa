"""The port's streaming runner (``io/stream.py``) against the reference
package's on the CPU: the bucket plan, ``collect()`` column for column,
the ``.npz`` writer, a single record and a forced overflow."""

import jax  # noqa: F401  (the reference package's own import, made explicit)
import numpy as np
import pytest
import torch

from rust_seq2kminmers_torch import api
from rust_seq2kminmers_torch.io import stream as ps
from rust_seq2kminmers_torch.ops.pipeline import PipelineSpec
from rust_seq2kminmers_tpu.io import stream as js
from rust_seq2kminmers_tpu.oracle import HashMode, kminmers
from rust_seq2kminmers_tpu.ops.pipeline import PipelineSpec as JaxSpec

COLUMNS = ["hash", "start", "end", "offset", "rev", "read"]
STAT_FIELDS = ["total_kminmers", "total_bases", "num_records", "batches", "buckets"]


def _write_fasta(path, seqs):
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))


@pytest.fixture(scope="module")
def mixed_file(tmp_path_factory):
    """Three buckets (1k / 2k / 4k), several batches each at 2^14 cells; a
    few reads shorter than l and empty ones."""
    rng = np.random.default_rng(7)
    seqs = []
    for _ in range(41):
        n = int(rng.choice([0, 8, 60, 400, 1100, 1900, 2500, 3900]))
        seqs.append("".join(rng.choice(list("ACGTNacgt"), size=n,
                                       p=[0.22] * 4 + [0.04] + [0.02] * 4)))
    p = tmp_path_factory.mktemp("stream") / "mixed.fa"
    _write_fasta(p, seqs)
    return p, seqs


def _run(module, path, spec, **kw):
    with module.StreamingRunner(path, spec, target_cells=1 << 14, **kw) as r:
        stats = r.run()
        return stats, r.collect()


def _same(mine, theirs):
    assert sorted(mine) == sorted(theirs) == sorted(COLUMNS)
    for c in COLUMNS:
        assert mine[c].dtype == theirs[c].dtype, c
        np.testing.assert_array_equal(mine[c], theirs[c], err_msg=c)


def test_plan_buckets_equals_reference():
    rng = np.random.default_rng(3)
    for n, hi, cells in ((1, 100, 1 << 25), (50, 5000, 1 << 14), (2000, 300_000, 1 << 20),
                         (300, 5_000_000, 1 << 25), (0, 10, 1 << 25)):
        lens = rng.integers(0, hi, size=n)
        mine, theirs = ps.plan_buckets(lens, cells), js.plan_buckets(lens, cells)
        assert [(p, r) for p, r, _ in mine] == [(p, r) for p, r, _ in theirs]
        for (_, _, a), (_, _, b) in zip(mine, theirs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


CASES = [
    ("regular", 13, 4, 0.05),
    ("simd", 9, 3, 0.05),
    ("hpc", 11, 3, 0.1),
    ("hpcsimd", 13, 4, 0.05),
    ("hpc", 301, 3, 0.05),  # the general path
]


@pytest.mark.parametrize("mode,l,k,d", CASES)
def test_collect_equals_reference(mixed_file, mode, l, k, d):
    path, _ = mixed_file
    kw = dict(l=l, k=k, density=d, mode=mode)
    stats, mine = _run(ps, path, PipelineSpec(**kw), device="cpu")
    jstats, theirs = _run(js, path, JaxSpec(**kw))
    _same(mine, theirs)
    for f in STAT_FIELDS:
        assert getattr(stats, f) == getattr(jstats, f), f
    assert stats.buckets >= 3 and stats.batches > stats.buckets
    assert stats.warm_s == 0.0 and stats.first_result_s > 0 and stats.pack_s > 0
    assert len(mine["hash"]) == stats.total_kminmers > 0


@pytest.mark.parametrize("mode,l,width,variant", [
    ("regular", 301, 64, "nthash1"), ("hpc", 31, 16, "nthash1"), ("hpcsimd", 40, 32, "nthash2"),
])
def test_collect_equals_kminmers_list(mixed_file, mode, l, width, variant):
    """Other widths and the nthash2 variant: each read's slice of the
    stream equals the port's own per-read call (held to the reference in
    tests/test_torch_widths.py and test_torch_general.py)."""
    path, seqs = mixed_file
    _, got = _run(ps, path, PipelineSpec(l=l, k=4, density=0.05, mode=mode, hash_width=width,
                                         variant=variant), device="cpu")
    for i, s in enumerate(seqs):
        recs = api.kminmers_list(s, l, 4, 0.05, mode, device="cpu", strict_limits=False,
                                 hash_width=width, variant=variant)
        rows = np.nonzero(got["read"] == i)[0]
        assert [(int(got["hash"][j]), int(got["start"][j]), int(got["end"][j]),
                 int(got["offset"][j]), bool(got["rev"][j])) for j in rows] == [
            (r.hash, r.start, r.end, r.offset, r.rev) for r in recs]
    assert len(got["hash"]) > 0


@pytest.mark.parametrize("mode", ["regular", "hpcsimd"])
def test_collect_in_oracle_order(mixed_file, mode):
    """The stream is each read's k-min-mers in read order, as the oracle
    gives them (the reference's sequential iterator order)."""
    path, seqs = mixed_file
    _, got = _run(ps, path, PipelineSpec(l=13, k=4, density=0.05, mode=mode), device="cpu")
    p = 0
    for i, s in enumerate(seqs):
        for rec in kminmers(s, 13, 4, 0.05, HashMode(mode)):
            assert (got["read"][p], got["hash"][p], got["start"][p], got["end"][p],
                    got["offset"][p], got["rev"][p]) == (
                i, rec.hash, rec.start, rec.end, rec.offset, rec.rev)
            p += 1
    assert p == len(got["hash"])


def test_stream_file_npz_equals_reference(mixed_file, tmp_path):
    path, _ = mixed_file
    kw = dict(l=9, k=3, density=0.05, mode="simd")
    mine, theirs = tmp_path / "mine.npz", tmp_path / "theirs.npz"
    st = ps.stream_file(path, PipelineSpec(**kw), out=str(mine), target_cells=1 << 14,
                        device="cpu")
    jst = js.stream_file(path, JaxSpec(**kw), out=str(theirs), target_cells=1 << 14)
    assert st.total_kminmers == jst.total_kminmers
    a, b = np.load(mine), np.load(theirs)
    _same(dict(a), dict(b))
    reads, offs = a["read"], a["offset"]
    assert (np.diff(reads) >= 0).all()
    firsts = np.nonzero(np.r_[True, np.diff(reads) > 0])[0]
    assert (offs[firsts] == 0).all()
    # without out, no records are kept
    with ps.StreamingRunner(path, PipelineSpec(**kw), keep_records=False, device="cpu") as r:
        assert r.run().total_kminmers == st.total_kminmers
        with pytest.raises(RuntimeError, match="keep_records"):
            r.collect()


def test_single_record(tmp_path):
    rng = np.random.default_rng(3)
    s = "".join(rng.choice(list("ACGT"), size=777))
    p = tmp_path / "one.fa"
    _write_fasta(p, [s])
    kw = dict(l=11, k=3, density=0.1, mode="hpc")
    st, mine = _run(ps, p, PipelineSpec(**kw), device="cpu")
    _, theirs = _run(js, p, JaxSpec(**kw))
    _same(mine, theirs)
    assert st.batches == st.buckets == st.num_records == 1
    assert [int(h) for h in mine["hash"]] == [r.hash for r in kminmers(s, 11, 3, 0.1,
                                                                        HashMode.Hpc)]


def test_overflow_is_rescued(tmp_path, monkeypatch):
    """max_minimizers=8 overflows every read: the batch reruns through
    kminmers_batch's rescue, losslessly and equal to the reference."""
    rng = np.random.default_rng(11)
    seqs = ["".join(rng.choice(list("ACGT"), size=900)) for _ in range(5)]
    p = tmp_path / "dense.fa"
    _write_fasta(p, seqs)
    kw = dict(l=9, k=3, density=0.2, mode="regular", max_minimizers=8)
    calls, real = [], api.rescue_spec

    def rescue_spec(spec, needed=0):
        calls.append(needed)
        return real(spec, needed)

    monkeypatch.setattr(api, "rescue_spec", rescue_spec)
    _, mine = _run(ps, p, PipelineSpec(**kw), device="cpu")
    _, theirs = _run(js, p, JaxSpec(**kw))
    assert calls
    _same(mine, theirs)
    for i, s in enumerate(seqs):
        assert (mine["read"] == i).sum() == len(kminmers(s, 9, 3, 0.2, HashMode.Regular)) > 50


def test_needs_a_gpu_by_default(mixed_file):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ps.StreamingRunner(mixed_file[0], PipelineSpec(l=13, k=4, density=0.05))


def test_producer_error_reaches_the_caller(mixed_file, monkeypatch):
    """A packing failure on the producer thread is raised by run(), and the
    thread is gone."""
    with ps.StreamingRunner(mixed_file[0], PipelineSpec(l=13, k=4, density=0.05),
                            target_cells=1 << 14, device="cpu") as r:
        def broken(*a, **kw):
            raise OSError("disk gone")

        monkeypatch.setattr(r.file, "pack_indices", broken)
        with pytest.raises(OSError, match="disk gone"):
            r.run()
