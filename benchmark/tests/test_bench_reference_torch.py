"""The plain PyTorch reference (``reference/kminmers_torch.py``) against the
NumPy reference, the crate's golden hashes and the port's plain CPU path;
what importing it loads; and whole CPU runs of the u64 cell, correct, and
not correct under its control."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import generate, harness
from benchmark.reference import kminmers as numpy_reference
from benchmark.reference import kminmers_torch as reference
from benchmark.tests.conftest import ROOT
from benchmark.tests.test_bench_reference import GOLDEN_U32, GOLDEN_U64

CELL = "batch64.s2k_hpc_u64"
SEED = 2**31 + 17
PARAMS = [(31, 5, 0.01), (14, 21, 0.2), (7, 3, 0.5)]
CASES = [(mode, width, *p) for mode in reference.MODES for width in reference.WIDTHS
         for p in PARAMS]


def host(rec: dict) -> dict:
    return {"hash": rec["hash"].numpy().view(np.uint64), "start": rec["start"].numpy(),
            "end": rec["end"].numpy(), "rev": rec["rev"].numpy()}


def ragged_text(seed: int, lengths) -> torch.Tensor:
    """uint8[len(lengths), max] rows of text with lowercase, N and other
    bytes, each row's bytes past its length random too."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTACGTacgtNNX", dtype=np.uint8)
    rows = alphabet[rng.integers(0, len(alphabet), (len(lengths), max(lengths)))]
    return torch.from_numpy(rows)


@pytest.mark.parametrize("mode,width,l,k,d", CASES)
def test_agrees_with_the_numpy_reference(mode, width, l, k, d):
    """Every row of a ragged block, record for record, against the NumPy
    reference of that row alone."""
    lengths = [20000, 5000, 300, l, l + 1, 0, 12001]
    seqs = ragged_text(width + l, lengths)
    got = reference.kminmers_rows(seqs, torch.tensor(lengths), l, k, d, mode, width,
                                  block_rows=3)
    assert len(got) == len(lengths)
    total = 0
    for row, n, rec in zip(seqs.numpy(), lengths, got):
        want = numpy_reference.kminmers(row[:n], l, k, d, mode, width)
        rec = host(rec)
        for f in want:
            assert np.array_equal(rec[f], want[f]), f
        total += len(want["hash"])
    assert total > 100


@pytest.mark.parametrize("width,golden", [(32, GOLDEN_U32), (64, GOLDEN_U64)],
                         ids=["u32", "u64"])
def test_golden_hashes(width, golden):
    """rust-seq2kminmers tests/main.rs: l=10, k=5, d=0.0001, Regular, on the
    E. coli fixture, at H=u32 and H=u64."""
    line = (ROOT / "tests" / "data" / "ecoli.genome.100k.fa").read_text().split("\n")[1]
    seq = torch.frombuffer(bytearray(line.encode()), dtype=torch.uint8)[None]
    rec = reference.kminmers_rows(seq, torch.tensor([seq.shape[1]]), 10, 5, 0.0001, "regular",
                                  width)[0]
    assert host(rec)["hash"].tolist() == golden


def test_agrees_with_the_ports_plain_path_at_hpc_u64():
    """``kminmers_batch`` on the CPU (the port's plain versions) at the u64
    cell's spec, on xcode rows of ragged lengths padded past each length."""
    from rust_seq2kminmers_torch import PipelineSpec
    from rust_seq2kminmers_torch.api import kminmers_batch
    from rust_seq2kminmers_torch.constants import XCODE_PAD

    lengths = torch.tensor([30000, 1, 32, 17000, 9000, 30000], dtype=torch.int32)
    codes = generate.draw_pool(SEED, 1, len(lengths), int(lengths.max()), torch.device("cpu"))[0]
    codes[torch.arange(codes.shape[1])[None, :] >= lengths[:, None].long()] = XCODE_PAD
    spec = PipelineSpec(l=31, k=5, density=0.01, mode="hpc", hash_width=64)
    out = kminmers_batch(codes, lengths, spec)
    want = reference.kminmers_rows(codes, lengths, 31, 5, 0.01, "hpc", 64, xcodes=True)
    got_hash = (out.hash_hi.to(torch.int64) << 32) | (out.hash_lo.to(torch.int64) & 0xFFFFFFFF)
    for r, w in enumerate(want):
        n = int(out.n_kminmers[r])
        assert n == len(w["hash"]), r
        assert torch.equal(got_hash[r, :n], w["hash"])
        assert torch.equal(out.start[r, :n].long(), w["start"])
        assert torch.equal(out.end[r, :n].long(), w["end"])
        assert torch.equal(out.rev[r, :n].bool(), w["rev"])
    assert int(out.n_kminmers.sum()) > 500


@pytest.mark.parametrize("mode,width", [("simd", 64), ("hpc", 16)])
def test_refuses_what_it_does_not_compute(mode, width):
    with pytest.raises(ValueError):
        reference.kminmers_rows(torch.zeros((1, 100), dtype=torch.uint8), torch.tensor([100]),
                                5, 3, 0.5, mode, width)


def test_importing_it_loads_torch_and_nothing_of_the_program():
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from benchmark.reference import kminmers_torch
print(sorted({{m.split(".")[0] for m in sys.modules}} & {{"torch", "jax", "jaxlib",
      "rust_seq2kminmers_torch", "rust_seq2kminmers_tpu"}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['torch']"


@pytest.fixture
def root64(root):
    """The small checkout with the u64 cell's traffic cut as the batch
    cells' is."""
    path = root / "benchmark" / "traffic" / "batch64.json"
    traffic = json.loads(path.read_text())
    traffic.update(batches=3, rows=4, length=8192, check={"sample_calls": 2, "rows_per_call": 2})
    path.write_text(json.dumps(traffic))
    return root


def test_the_u64_cell_is_correct_and_its_control_is_not(root64):
    sound = harness.run_cell(CELL, SEED, 0.2, False, device="cpu", root=root64)
    assert sound["correct"], sound["checks"]
    assert sound["checks"]["mismatched_records"]["value"] == 0
    assert sound["checks"]["compared_records"]["value"] > 100
    assert set(sound["metrics"]) == {"batch_gbps", "batch_p95_ms", "setup_s"}
    control = harness.run_cell(CELL, SEED, 0.2, False, control=True, device="cpu", root=root64)
    assert not control["correct"]
    assert control["checks"]["mismatched_records"]["value"] > 100


def test_the_u64_cell_catches_an_altered_record(root64, monkeypatch):
    """A fault under the timed path: the first record of every row gets
    another hash."""
    from rust_seq2kminmers_torch import api

    real = api._cached_pipeline

    def cached(spec):
        step = real(spec)

        def altered(codes, lengths):
            out = step(codes, lengths)
            first = (torch.arange(out.hash_hi.shape[1]) == 0).to(out.hash_hi.dtype)
            return out._replace(hash_hi=out.hash_hi ^ first)
        return altered

    monkeypatch.setattr(api, "_cached_pipeline", cached)
    out = harness.run_cell(CELL, SEED, 0.2, False, device="cpu", root=root64)
    assert not out["correct"]
