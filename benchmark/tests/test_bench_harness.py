"""Whole runs of the harness on the CPU at small sizes: each cell comes out
correct; its control (the reference at the next lower hash width in the
program's place) and each fault planted under the timed path come out not
correct; and with no card the harness fails without a result."""

from __future__ import annotations

import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import ROOT

CELLS = ["batch.s2k_bench_hpcsimd", "batch.mdbg_hg002_hifi"]
SEED = 2**31 + 17


def run(root, cell, **kw):
    out = harness.run_cell(cell, SEED, 0.2, False, device="cpu", root=root, **kw)
    assert out["checks"]["compared_records"]["value"] > 0
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_and_its_control_is_not(root, cell):
    sound = run(root, cell)
    assert sound["correct"], sound["checks"]
    assert sound["checks"]["mismatched_records"]["value"] == 0
    control = run(root, cell, control=True)
    assert not control["correct"]
    assert control["checks"]["mismatched_records"]["value"] > 0


def _half_rows(out):
    """A KminmerBatch whose second half of rows lost its records."""
    n = out.n_kminmers.clone()
    n[n.shape[0] // 2:] = 0
    return out._replace(n_kminmers=n)


def _altered(out):
    """A KminmerBatch whose first record of every row has another hash."""
    lo = out.hash_lo.clone()
    lo[:, 0] ^= 1
    return out._replace(hash_lo=lo)


def _broken_pipeline(real, fault):
    def cached(spec):
        step = real(spec)
        return lambda codes, lengths: fault(step(codes, lengths))
    return cached


@pytest.mark.parametrize("fault", [_half_rows, _altered], ids=["half_left_out", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_in_the_batch_step_is_caught(root, monkeypatch, cell, fault):
    from rust_seq2kminmers_torch import api

    monkeypatch.setattr(api, "_cached_pipeline", _broken_pipeline(api._cached_pipeline, fault))
    assert not run(root, cell)["correct"]


def _run_py(cwd, *args):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], capture_output=True,
                          text=True, timeout=300, cwd=cwd)


def test_no_card_no_result():
    """Without a card the command fails and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run_py(ROOT, "--workload", "batch.s2k_bench_hpcsimd", "--seed", "1",
                  "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""
    assert "no result" in out.stderr


def test_without_the_program_no_result(tmp_path, cuda):
    """In a directory that holds only BENCHMARK.json and the benchmark, the
    command fails and prints no result line."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run_py(tmp_path, "--workload", "batch.s2k_bench_hpcsimd", "--seed", "1",
                  "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""


def test_without_the_program_run_cell_raises(tmp_path):
    """The program is imported from the checkout the harness lies in, never
    from elsewhere on the path."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = f"""
import sys
sys.path.insert(0, {str(tmp_path)!r})
sys.path.append({str(ROOT)!r})
from benchmark import harness
assert harness.ROOT == __import__("pathlib").Path({str(tmp_path)!r})
harness.run_cell("batch.s2k_bench_hpcsimd", 1, 0.1, False, device="cpu")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert "outside the checkout" in out.stderr


@pytest.mark.cuda
def test_a_small_cell_on_the_card(root, cuda):
    out = harness.run_cell("batch.s2k_bench_hpcsimd", SEED, 0.5, True, root=root)
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
