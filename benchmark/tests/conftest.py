"""Shared fixtures of the benchmark's tests: a copy of the benchmark's data
files with small traffic, which the harness runs on the CPU."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Each mix at a size the CPU's plain versions run in a second or two.
SMALL = {
    "batch": {"batches": 3, "rows": 4, "length": 8192,
              "check": {"sample_calls": 2, "rows_per_call": 2}},
}


def small_root(tmp: Path) -> Path:
    """A directory laid out as a checkout, holding BENCHMARK.json and the
    benchmark's configurations, traffic (cut to SMALL) and readers."""
    shutil.copytree(ROOT / "benchmark" / "configs", tmp / "benchmark" / "configs")
    shutil.copytree(ROOT / "benchmark" / "metrics", tmp / "benchmark" / "metrics")
    (tmp / "benchmark" / "traffic").mkdir()
    for f in (ROOT / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update(SMALL.get(f.stem, {}))
        (tmp / "benchmark" / "traffic" / f.name).write_text(json.dumps(t))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return tmp


@pytest.fixture
def root(tmp_path) -> Path:
    return small_root(tmp_path)


@pytest.fixture
def cuda():
    """Skips where there is no card (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
