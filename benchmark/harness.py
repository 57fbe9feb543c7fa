"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

Everything is found by name: the cell's configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<traffic>.json``,
the driver that the mix names in ``drivers/<driver>.py`` (the module
``benchmark.drivers.<driver>``) and each metric's reader in
``metrics/<metric>.py``.  A driver makes the inputs from the
seed, builds and warms the program, runs one unit of work a ``step()``
(a call) and, once the window has closed and the
program's state is freed, compares a seeded sample of what the window
produced with the plain reference (``reference/``).

The run: set-up (from the start of ``run.py`` to the first timed step),
then a closed loop of steps until ``--seconds`` have passed (the last
step closes the window), under the profiler with ``--trace 1``.  The peak
of device memory is read, the program is freed, the outputs are judged,
and the last line of standard output is the result; the numbers compared,
each with its limit, are the last lines of standard error and the
result's last key.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PROGRAM = "rust_seq2kminmers_torch"
# Top-level modules that may not be loaded in the process that prints.
FORBIDDEN = ("jax", "jaxlib", "flax", "rust_seq2kminmers_tpu")


class NoDevice(RuntimeError):
    """The cell's cards are not there."""


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    seed: int
    control: bool  # judge the control in the program's place
    device: str  # "cuda" on the card; "cpu" only where a test drives the harness


@dataclasses.dataclass
class Run:
    """What a reader reads: the window, its steps and the driver's spans
    and counters, and with ``--trace 1`` the device trace."""

    setup_s: float
    window_s: float
    steps: int
    bases: int
    latencies_s: List[float]
    spans: list
    counters: Dict[str, float]
    trace: object = None  # trace.DeviceTrace


def load_module(path: Path, name: str) -> ModuleType:
    """A module of the benchmark loaded from its file (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def cell_metrics(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics the cell reports: its end-to-end metrics, or with a
    trace its per-layer metrics.  A metric without a ``workloads`` list
    belongs to every cell (a per-layer one: every cell reporting the
    end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in names else [])]


def program():
    """The program, imported from this checkout and nowhere else."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import rust_seq2kminmers_torch as pkg

    where = Path(pkg.__file__).resolve()
    if ROOT not in where.parents:
        raise ImportError(f"{PROGRAM} came from {where}, outside the checkout {ROOT}")
    return pkg


def check_devices(chips: int) -> str:
    """The card's name; raises NoDevice where the cell's cards are missing."""
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false: no card to measure on")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} cards, torch sees "
                       f"{torch.cuda.device_count()}")
    return torch.cuda.get_device_name(0)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def devices(cell: Cell, kind: str) -> dict:
    """The result's ``device``: the card and the peak of device memory."""
    if cell.device != "cuda":
        return {"platform": "cpu", "kind": kind, "count": 0, "memory_peak_bytes": 0}
    import torch

    peak = torch.cuda.max_memory_allocated()
    return {"platform": "gpu", "kind": kind, "count": cell.chips,
            "memory_peak_bytes": int(peak)}


def window(driver, seconds: float, run: Run) -> float:
    """The closed loop: steps until ``seconds`` have passed -> its wall."""
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        run.bases += driver.step()
        te = time.perf_counter()
        run.latencies_s.append(te - ts)
        run.steps += 1
        if te - t0 >= seconds:
            return te - t0


def read_metrics(metrics: List[dict], run: Run, root: Path) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        reader = load_module(root / "benchmark" / "metrics" / f"{m['name']}.py",
                             f"bench_metric_{m['name']}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, control: bool = False,
             device: str = "cuda", t_start: Optional[float] = None,
             root: Path = ROOT) -> dict:
    """One run of a cell -> the result line's object.  ``root`` holds
    BENCHMARK.json and the benchmark's data files and readers; ``device``
    "cpu" runs the program's plain versions, for the tests only."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_benchmark(root)
    w = find_cell(bench, workload)
    cell = Cell(
        name=workload,
        config=json.loads((root / "benchmark" / "configs" / f"{w['config']}.json").read_text()),
        traffic=json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text()),
        chips=w["chips"], seed=seed, control=control, device=device,
    )
    kind = "not measured"
    if device == "cuda":
        kind = check_devices(cell.chips)
    program()
    driver = importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}").Driver(cell)
    try:
        run = Run(setup_s=0.0, window_s=0.0, steps=0, bases=0, latencies_s=[], spans=[],
                  counters={})
        driver.prepare()
        run.setup_s = time.perf_counter() - t_start

        def measured() -> float:
            run.bases, run.steps = 0, 0
            run.latencies_s, run.spans, run.counters = [], [], {}
            driver.begin(run)
            return window(driver, seconds, run)

        if trace and device == "cuda":
            from . import trace as tracing

            run.trace = tracing.traced(measured)
            run.window_s = run.trace.window_s if run.trace else 0.0
        else:
            run.window_s = measured()
        device_info = devices(cell, kind)
        driver.release()
        gc.collect()
        checks = driver.check()
    finally:
        driver.close()
    metrics = read_metrics(cell_metrics(bench, workload, trace), run, root)
    lat = sorted(run.latencies_s)
    print(f"window: {run.steps} steps in {run.window_s:.3f} s, a step min {lat[0]:.6f} s, "
          f"median {lat[len(lat) // 2]:.6f} s, max {lat[-1]:.6f} s", file=sys.stderr)
    result = {
        "correct": all(c["ok"] for c in checks.values()),
        "attempted": run.steps,
        "failed": 0,  # a step that raises ends the run without a result
        "metrics": metrics,
        "device": device_info,
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in run.trace.device_ops],
            "idle_gaps": [[n, s] for n, s in run.trace.idle_gaps],
        }
    result["checks"] = {n: {k: c[k] for k in ("value", "limit", "rule")}
                        for n, c in checks.items()}
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="judge the control (the reference at the next lower hash "
                    "width) in the program's place; for setting limits, never a result")
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          bool(args.control), t_start=t_start)
    except NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"no result: the process holds {found}, which the benchmark may not load",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['rule']} {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
