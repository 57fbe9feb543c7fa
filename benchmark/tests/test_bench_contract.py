"""BENCHMARK.json against the benchmark's contract, and the harness's
lookup by name: a cell added from new files alone runs."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(TEXT.match(w) for w in bench["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units_use_the_allowed_characters(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [w[k] for w in bench["workloads"] for k in ("config", "traffic")]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    bad = [n for n in names if not NAME.match(n)]
    assert not bad
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    texts = [c["source"] for c in bench["configs"]] + [w["why"] for w in bench["workloads"]]
    texts += [c["why"] for c in bench["configs"]] + [m["layer"] for m in bench["per_layer"]]
    assert all(TEXT.match(t) for t in texts)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in bench[group]}) == len(bench[group])


def test_entries_have_just_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        if "roofline" in m["name"]:
            assert m["unit"] == "%" and m["name"].split(".")[0].endswith("_roofline")


def test_every_cell_finds_its_files_and_reports_enough(bench):
    cells = {w["name"] for w in bench["workloads"]}
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        config = ROOT / "benchmark" / "configs" / f"{w['config']}.json"
        traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        assert config.is_file()
        assert (ROOT / "benchmark" / "drivers" / f"{traffic['driver']}.py").is_file()
        e2e = {m["name"] for m in harness.cell_metrics(bench, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(bench, w["name"], True)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", [])) <= cells
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)


def test_a_cell_added_from_new_files_alone(root):
    """A configuration, a traffic mix and a per-layer metric added as new
    files, with new entries in BENCHMARK.json, run without any other file
    changing."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    config = json.loads((root / "benchmark/configs/s2k_bench_hpcsimd.json").read_text())
    config.update(name="s2k_cli_regular")
    config["spec"].update(mode="regular")
    (root / "benchmark/configs/s2k_cli_regular.json").write_text(json.dumps(config))
    traffic = json.loads((root / "benchmark/traffic/batch.json").read_text())
    traffic.update(rows=2, length=4096)
    (root / "benchmark/traffic/tiny.json").write_text(json.dumps(traffic))
    (root / "benchmark/metrics/calls.tiny.py").write_text(
        "def read(run):\n    return float(run.steps)\n")
    cell = "tiny.s2k_cli_regular"
    bench["configs"].append({"name": "s2k_cli_regular", "source": "x",
                             "file": "benchmark/configs/s2k_cli_regular.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": cell, "config": "s2k_cli_regular",
                               "traffic": "tiny", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] in ("batch_gbps", "batch_p95_ms"):
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": "calls.tiny", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "harness",
                               "moves": "batch_gbps", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    plain = harness.run_cell(cell, 7, 0.2, False, device="cpu", root=root)
    assert plain["correct"] and set(plain["metrics"]) == {"batch_gbps", "batch_p95_ms",
                                                          "setup_s"}
    traced = harness.run_cell(cell, 7, 0.2, True, device="cpu", root=root)
    assert traced["metrics"]["calls.tiny"]["value"] >= 1


def test_nothing_loads_jax_or_the_jax_package():
    """After the harness, every driver, every reader and the program are
    imported, no module whose top-level name is jax, jaxlib, flax or the
    JAX package is loaded (names compared whole)."""
    code = f"""
import importlib, sys
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from benchmark import harness, generate, judge, readers, roofline, trace
from benchmark.reference import kminmers
harness.program()
for f in sorted(Path({str(ROOT)!r}, "benchmark", "drivers").glob("[!_]*.py")):
    importlib.import_module("benchmark.drivers." + f.stem)
for f in sorted(Path({str(ROOT)!r}, "benchmark", "metrics").glob("*.py")):
    harness.load_module(f, "m_" + f.stem)
import rust_seq2kminmers_torch.io.stream, rust_seq2kminmers_torch.api
print(harness.forbidden_modules())
print(sorted(m for m in sys.modules if m.split(".")[0] == "rust_seq2kminmers_torch")[:1])
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[-2] == "[]"
    assert lines[-1] == "['rust_seq2kminmers_torch']"


def test_the_reference_imports_nothing_of_the_program():
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from benchmark.reference import kminmers
print(sorted({{m.split(".")[0] for m in sys.modules}} & {{"torch", "jax",
      "rust_seq2kminmers_torch", "rust_seq2kminmers_tpu"}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
