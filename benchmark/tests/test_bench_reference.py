"""The plain NumPy reference against the reference crate's golden hashes
and against the port's plain CPU path, and the generators' repeatability
from a seed."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import generate
from benchmark.reference import kminmers as reference
from benchmark.tests.conftest import ROOT

# rust-seq2kminmers tests/main.rs: KminmersIterator(l=10, k=5, d=0.0001,
# Regular) on the E. coli fixture, with H=u32 (:41-57) and H=u64 (:18-39).
GOLDEN_U32 = [
    143479479014703, 1415094313937202, 7085699921625713, 2731023262850893,
    3529660833839258, 2520689800435504, 3515165585325381, 2855190423625803,
    5122855536061684, 244022361441902, 2856446528761135, 906939906227534,
    2115341643533671, 246274980452770, 159737436030657,
]
GOLDEN_U64 = [
    6097375827354318, 5077268723048817, 17093614815813553, 13932651659877218,
    2254626575123847, 4725847317728813, 10971942364167709, 1406844240705087,
    15284878278949327, 13429516156719180, 10760699289819902, 11244197813995113,
    6993910349997344, 22098843726082404, 4944933674400292, 14212811059278321,
    9310664830401458, 11232758307960192, 9720472733789719, 13210101786532125,
]


@pytest.fixture(scope="module")
def ecoli() -> np.ndarray:
    line = (ROOT / "tests" / "data" / "ecoli.genome.100k.fa").read_text().split("\n")[1]
    return np.frombuffer(line.encode(), dtype=np.uint8)


@pytest.mark.parametrize("width,golden", [(32, GOLDEN_U32), (64, GOLDEN_U64)],
                         ids=["u32", "u64"])
def test_golden_hashes(ecoli, width, golden):
    got = reference.kminmers(ecoli, 10, 5, 0.0001, "regular", width)
    assert got["hash"].tolist() == golden
    assert np.all(np.diff(got["start"]) > 0)


CASES = [(mode, width) for mode in ("regular", "hpc") for width in (16, 32, 64)]
CASES += [("simd", 32), ("hpcsimd", 32)]


@pytest.mark.parametrize("mode,width", CASES)
def test_agrees_with_the_ports_plain_cpu_path(mode, width):
    """Random text with lowercase, N and other bytes, through the port's
    ``kminmers_list`` on the CPU (its plain versions), record for record."""
    from rust_seq2kminmers_torch import kminmers_list

    rng = np.random.default_rng(width * 7 + len(mode))
    alphabet = np.frombuffer(b"ACGTACGTacgtNNX", dtype=np.uint8)
    for n, l, k, d in [(20000, 31, 5, 0.05), (5000, 14, 21, 0.2), (300, 7, 3, 0.5)]:
        seq = alphabet[rng.integers(0, len(alphabet), n)]
        want = reference.kminmers(seq, l, k, d, mode, width)
        got = kminmers_list(seq.tobytes(), l, k, d, mode, device="cpu", hash_width=width)
        assert [r.hash for r in got] == want["hash"].tolist()
        assert [r.start for r in got] == want["start"].tolist()
        assert [r.end for r in got] == want["end"].tolist()
        assert [r.rev for r in got] == want["rev"].tolist()
        assert [r.offset for r in got] == list(range(len(got)))


@pytest.mark.parametrize("mode,l,k,d", [("hpcsimd", 31, 5, 0.01), ("hpc", 14, 21, 0.003)],
                         ids=["s2k_bench_hpcsimd", "mdbg_hg002_hifi"])
def test_xcodes_and_text_agree(mode, l, k, d):
    """The batch cells' xcodes (keep bit = the code differs from the one
    before) give the text's records, in each configuration's mode."""
    import torch

    xcodes = generate.draw_pool(3, 1, 1, 200000, torch.device("cpu"))[0, 0].numpy()
    text = np.frombuffer(b"ACGT", dtype=np.uint8)[xcodes & 3]
    a = reference.kminmers(xcodes, l, k, d, mode, xcodes=True)
    b = reference.kminmers(text, l, k, d, mode)
    assert len(a["hash"]) > 100
    assert all(np.array_equal(a[f], b[f]) for f in a)


def test_generators_repeat_from_a_seed():
    import torch

    cpu = torch.device("cpu")
    p = generate.draw_pool(2**40 + 1, 2, 3, 1000, cpu)
    assert torch.equal(p, generate.draw_pool(2**40 + 1, 2, 3, 1000, cpu))
    assert not torch.equal(p, generate.draw_pool(2**40 + 2, 2, 3, 1000, cpu))
    assert int(p.max()) <= 11 and bool(((p & 8) != 0)[..., 0].all())
    keep = (p[..., 1:] & 8) != 0
    assert torch.equal(keep, (p[..., 1:] & 3) != (p[..., :-1] & 3))
    assert generate.rng_of(2**40 + 1).integers(1 << 30) == generate.rng_of(2**40 + 1).integers(
        1 << 30)
