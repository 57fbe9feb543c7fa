"""The port's FASTA/FASTQ reader (``io/fasta.py``), native and Python,
against the reference package's ``FastaFile``; its build."""

import threading

import jax  # noqa: F401  (the reference package's own import, made explicit)
import numpy as np
import pytest

from rust_seq2kminmers_torch.constants import XCODE_PAD
from rust_seq2kminmers_torch.io import fasta as pf
from rust_seq2kminmers_tpu.io.fasta import FastaFile as JaxFasta

FASTA_WRAPPED = """stray line before the first record
>r1 first record
ACGTACGTNNACGT
>r2 wrapped over three lines
ACGTAC
GTTTTT
acgQQ
>empty
>r3
A
>also empty

>r4 last, no newline at the end
TTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTacgtNNNN*CCC"""

FASTQ = """@q1 desc
ACGTTTACG
+
IIIIIIIII
@q2
NNACGTacgt
+
!!!!!!!!!!
@empty

+

@q3
GGGGGGGGGGGGGGGGGGGGCA
+
IIIIIIIIIIIIIIIIIIIIII
"""


def _random_fasta(rng, n):
    """Reads of 0-400 bases over ACGTN, both cases and a few other bytes,
    wrapped at 60 columns."""
    alphabet = list("ACGTNacgtnRY*")
    out = []
    for i in range(n):
        s = "".join(rng.choice(alphabet, size=int(rng.integers(0, 400)),
                               p=[0.2] * 4 + [0.04] + [0.02] * 8))
        out.append(f">s{i}\n" + "".join(s[j : j + 60] + "\n" for j in range(0, len(s), 60)))
    return "".join(out)


@pytest.fixture(scope="module", params=["fasta_wrapped", "fastq", "random"])
def text_file(request, tmp_path_factory):
    text = {"fasta_wrapped": FASTA_WRAPPED, "fastq": FASTQ,
            "random": _random_fasta(np.random.default_rng(1), 37)}[request.param]
    p = tmp_path_factory.mktemp("io") / f"{request.param}.txt"
    p.write_text(text)
    return p


@pytest.fixture(params=[True, False], ids=["native", "python"])
def native(request):
    return request.param


def _same_arrays(mine, theirs):
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_index_equals_reference(text_file, native):
    with pf.FastaFile(text_file, prefer_native=native) as f, JaxFasta(text_file) as ref:
        assert f.native == native and ref.native
        assert len(f) == len(ref) > 2
        assert f.max_seq_len() == ref.max_seq_len()
        _same_arrays([f.seq_lens()], [ref.seq_lens()])
        for i in range(len(ref)):
            assert f.name(i) == ref.name(i)
            assert f.seq_len(i) == ref.seq_len(i)


@pytest.mark.parametrize("family", ["scalar", "simd", None])
def test_pack_equals_reference(text_file, native, family):
    with pf.FastaFile(text_file, prefer_native=native) as f, JaxFasta(text_file) as ref:
        n = len(ref)
        _same_arrays(f.pack(family=family), ref.pack(family=family))
        for first, count, max_len in ((1, 2, 8), (0, None, 3), (n - 1, 5, 70), (n, 1, 4),
                                      (2, 0, 16)):
            _same_arrays(f.pack(first, count, max_len, 2, family),
                         ref.pack(first, count, max_len, 2, family))


@pytest.mark.parametrize("family", ["scalar", "simd"])
def test_pack_indices_equals_reference(text_file, native, family):
    with pf.FastaFile(text_file, prefer_native=native) as f, JaxFasta(text_file) as ref:
        n = len(ref)
        ids = np.array([n - 1, 0, -1, n, 1, n + 5, 2, 0], dtype=np.int64)  # out of range: empty
        for max_len in (1, 13, 512):
            want = ref.pack_indices(ids, max_len, 3, family)
            _same_arrays(f.pack_indices(ids, max_len, 3, family), want)
            out = (np.full((len(ids), max_len), 99, np.uint8), np.full(len(ids), -7, np.int64))
            got = f.pack_indices(ids, max_len, 0, family, out=out)
            assert got[0] is out[0] and got[1] is out[1]
            _same_arrays(out, want)
            assert (out[0][2] == XCODE_PAD).all() and out[1][2] == 0
        _same_arrays(f.pack_indices([], 8, 0, family), ref.pack_indices([], 8, 0, family))


def test_pack_indices_rejects_bad_out(text_file):
    with pf.FastaFile(text_file) as f:
        ids = [0, 1]
        for codes, lengths in (
            (np.empty((2, 8), np.int32), np.empty(2, np.int64)),
            (np.empty((3, 8), np.uint8), np.empty(2, np.int64)),
            (np.empty((2, 16), np.uint8)[:, ::2], np.empty(2, np.int64)),
            (np.empty((2, 8), np.uint8), np.empty(2, np.int32)),
        ):
            with pytest.raises(ValueError, match="out"):
                f.pack_indices(ids, 8, 0, "scalar", out=(codes, lengths))


def test_batches_equal_reference(text_file, native):
    with pf.FastaFile(text_file, prefer_native=native) as f, JaxFasta(text_file) as ref:
        for batch, max_len in ((1, None), (3, 32), (100, 7)):
            mine = list(f.batches(batch, max_len, 2))
            theirs = list(ref.batches(batch, max_len, 2))
            assert [m[2] for m in mine] == [t[2] for t in theirs]
            for m, t in zip(mine, theirs):
                _same_arrays(m[:2], t[:2])


def test_empty_file_goes_to_the_python_parser(tmp_path):
    p = tmp_path / "empty.fa"
    p.write_text("")
    with pf.FastaFile(p) as f, JaxFasta(p) as ref:
        assert not f.native and not ref.native
        assert len(f) == len(ref) == 0
        _same_arrays(f.seq_lens()[None], ref.seq_lens()[None])


def test_missing_file_raises(tmp_path):
    for native in (True, False):
        with pytest.raises(FileNotFoundError):
            pf.FastaFile(tmp_path / "absent.fa", prefer_native=native)


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """The reader's build pointed at an empty directory; the process's
    loaded library is restored afterwards."""
    monkeypatch.setattr(pf, "BUILD_DIR", tmp_path / "build")
    pf.native_library.cache_clear()
    yield tmp_path
    monkeypatch.undo()
    pf.native_library.cache_clear()


def test_failed_build_raises(fresh_build, monkeypatch, tmp_path):
    """A reader that does not build raises with g++'s message; only
    prefer_native=False selects the Python parser."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(pf, "SOURCE", bad)
    p = tmp_path / "x.fa"
    p.write_text(">a\nACGT\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*\n.*error"):
        pf.FastaFile(p)
    with pf.FastaFile(p, prefer_native=False) as f:
        assert not f.native and len(f) == 1
    assert not list((tmp_path / "build").glob("*.so"))  # nothing half-built left


def test_concurrent_builds(fresh_build, tmp_path):
    """Builds started at once each write a file of their own and rename it
    into place: every caller loads a whole library."""
    p = tmp_path / "x.fa"
    p.write_text(">a\nACGTTT\n>b\nAC\n")
    libs, errors = [], []

    def build():
        try:
            libs.append(pf.native_library.__wrapped__())
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(libs) == 4
    for lib in libs:
        h = lib.s2k_open(str(p).encode())
        assert lib.s2k_num_records(h) == 2 and lib.s2k_max_seq_len(h) == 6
        lib.s2k_close(h)
    built = list((tmp_path / "build").iterdir())
    assert len(built) == 1 and built[0].suffix == ".so", built
