"""The u64 cell's byte counts (``drivers/resident_batches64.py``) on
synthetic inputs, the driver's counters, and the contract that ties each
roofline metric's kernels to the hash width of its cells."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import harness, roofline
from benchmark.drivers import resident_batches64
from benchmark.tests.conftest import ROOT

HBM = roofline.HBM_BYTES_PER_S


def test_k2_bound64_counts_the_high_column():
    assert resident_batches64.k2_bound64_s(2, 4, 10, 100) == pytest.approx(
        (10 * 16 + 2 * 4 * 8 + 2 * 100 * 16 + 2 * 8) / HBM)
    # Against the u32 count: 4 bytes more a survivor read and a slot written.
    rows, tiles, survivors, capacity = 32, 64, 32 * 7900, 31_616
    extra = resident_batches64.k2_bound64_s(rows, tiles, survivors, capacity) - \
        roofline.k2_bound_s(rows, tiles, survivors, capacity)
    assert extra == pytest.approx((survivors + rows * capacity) * 4 / HBM)


def test_k3_bound64_counts_both_halves_of_a_word():
    assert resident_batches64.k3_bound64_s(2, [10, 3], 5, 100) == pytest.approx(
        (13 * 8 + 6 * 8 + 2 * 96 * 17 + 2 * 8) / HBM)
    n_min, k, capacity = [7900] * 32, 5, 31_616
    extra = resident_batches64.k3_bound64_s(32, n_min, k, capacity) - \
        roofline.k3_bound_s(32, n_min, k, capacity)
    assert extra == pytest.approx(sum(n_min) * 4 / HBM)
    # The operations' time stays far below the bytes'.
    assert 12 * sum(n_min) / roofline.OPS_PER_S < sum(n_min) * 8 / HBM


def test_the_driver_counts_every_bound():
    cell = harness.Cell(
        name="batch64.s2k_hpc_u64",
        config=json.loads((ROOT / "benchmark/configs/s2k_hpc_u64.json").read_text()),
        traffic={"driver": "resident_batches64", "batches": 2, "rows": 3, "length": 20000,
                 "check": {"sample_calls": 1, "rows_per_call": 1}},
        chips=1, seed=5, control=False, device="cpu")
    driver = resident_batches64.Driver(cell)
    driver.prepare()
    try:
        for b in driver.bounds:
            assert set(b) == {"k1_bound_s", "k2_bound_s", "k3_bound_s", "k2_bound64_s",
                              "k3_bound64_s"}
            assert b["k2_bound64_s"] > b["k2_bound_s"] > 0
            assert b["k3_bound64_s"] > b["k3_bound_s"] > 0
    finally:
        driver.close()


# The hash width a reader's suffix stands for, and the widths its kernels'
# names state (scan_kernel<s2k::H64>, assemble_kernel<64>).
SUFFIX_WIDTH = {"batch": 32, "batch64": 64}
NAMED_WIDTH = re.compile(r"s2k::H(\d+)>|assemble_kernel<(\d+)>")


def roofline_metrics():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [m for m in bench["per_layer"] if "roofline" in m["name"]]


@pytest.mark.parametrize("metric", roofline_metrics(), ids=lambda m: m["name"])
def test_roofline_cells_have_the_width_their_kernels_name(metric):
    """A roofline share read in a cell of another width would find only part
    of its kernels, or none, and read far above 100% or nothing."""
    width = SUFFIX_WIDTH[metric["name"].split(".", 1)[1]]
    reader = harness.load_module(ROOT / "benchmark" / "metrics" / f"{metric['name']}.py",
                                 f"bench_metric_{metric['name']}")
    named = {int(a or b) for name in reader.KERNELS for a, b in NAMED_WIDTH.findall(name)}
    assert named <= {width}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs = {w["name"]: w["config"] for w in bench["workloads"]}
    for cell in metric["workloads"]:
        config = json.loads((ROOT / "benchmark" / "configs" / f"{configs[cell]}.json").read_text())
        assert config["spec"]["hash_width"] == width, cell


def test_every_roofline_kernel_set_names_a_width_where_the_kernels_have_one():
    """K1's scan and K3 are templates on the width, so their readers name
    it; K2's two kernels take the high column as a pointer and name none."""
    for m in roofline_metrics():
        reader = harness.load_module(ROOT / "benchmark" / "metrics" / f"{m['name']}.py",
                                     f"bench_metric_{m['name']}")
        named = [n for n in reader.KERNELS if NAMED_WIDTH.search(n)]
        assert bool(named) == (not m["name"].startswith("k2_")), m["name"]

