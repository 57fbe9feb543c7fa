"""The reads cell (``drivers/resident_reads.py``) on the CPU: its pool's
shapes, lengths and padding, the bases a step counts, K1's bound counted on
the reads, and whole runs of the cell at a tiny size, correct, and not
correct under its control or a fault under the timed path."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import generate, harness, roofline
from benchmark.drivers import resident_reads
from benchmark.tests.conftest import ROOT

CELL = "reads.s2k_cli_regular_hifi"
SEED = 2**33 + 29
XCODE_PAD = 14  # the program's XCODE_PAD, held equal to it below
TRAFFIC = json.loads((ROOT / "benchmark" / "traffic" / "reads.json").read_text())
# The cell's traffic at a tiny size: few rows, small pads, and lengths
# drawn so that every bin of these pads holds some.
TINY = {"rows": 4, "buckets": [{"pad": 2048, "batches": 1}, {"pad": 4096, "batches": 2},
                               {"pad": 8192, "batches": 1}],
        "lengths": {"mean": 3000, "sd": 1500, "min": 100, "max": 8192},
        "check": {"sample_calls": 2, "rows_per_call": 2}}


def test_pad_code_is_the_programs():
    from rust_seq2kminmers_torch.constants import XCODE_PAD as program_pad

    assert XCODE_PAD == program_pad


def pool_of(seed: int, rows: int = 8) -> list:
    traffic = dict(TRAFFIC, rows=rows)
    return resident_reads.draw_reads(seed, traffic, torch.device("cpu"), XCODE_PAD)


def test_the_pool_has_the_same_shapes_for_every_seed():
    a, b = pool_of(SEED), pool_of(7)
    shapes = [tuple(codes.shape) for codes, _ in a]
    assert shapes == [tuple(codes.shape) for codes, _ in b]
    assert shapes == [(8, 8192)] + [(8, 16384)] * 12 + [(8, 32768)] * 3
    assert sum(bucket["batches"] for bucket in TRAFFIC["buckets"]) == 16
    assert not all(torch.equal(x[1], y[1]) for x, y in zip(a, b))


def test_lengths_lie_in_their_bins_and_the_padding_is_xcode_pad():
    for codes, lengths in pool_of(SEED):
        pad = codes.shape[1]
        assert lengths.dtype == torch.int32
        assert bool(((lengths > pad // 2) & (lengths <= pad)).all()), pad
        past = torch.arange(pad)[None, :] >= lengths[:, None]
        assert bool((codes[past] == XCODE_PAD).all())
        assert bool(((codes[~past] & 7) < 4).all())


def test_the_lengths_follow_the_stated_distribution():
    """The real traffic's batches hold the bins' share of a normal(13,500,
    3,000): lengths near the mean in the [1024, 16384] batches."""
    rng = generate.rng_of(SEED)
    x = resident_reads.draw_lengths(rng, 20000, 8192, 16384, TRAFFIC["lengths"])
    assert 12500 < float(x.mean()) < 13200
    assert x.min() > 8192 and x.max() <= 16384
    with pytest.raises(ValueError):
        resident_reads.draw_lengths(rng, 1, 64, 128, TRAFFIC["lengths"])


def cell_of() -> harness.Cell:
    return harness.Cell(
        name=CELL,
        config=json.loads((ROOT / "benchmark/configs/s2k_cli_regular_hifi.json").read_text()),
        traffic=dict(TRAFFIC, **TINY), chips=1, seed=SEED, control=False,
        device="cpu")


def test_a_step_counts_the_reads_bases():
    driver = resident_reads.Driver(cell_of())
    driver.prepare()
    try:
        run = harness.Run(setup_s=0.0, window_s=0.0, steps=0, bases=0, latencies_s=[],
                          spans=[], counters={})
        driver.begin(run)
        for codes, lengths in driver.batches:
            assert driver.step() == int(lengths.sum()) < codes.numel()
        assert set(run.counters) == {"k1_bound_s", "k2_bound_s", "k3_bound_s"}
        assert all(v > 0 for v in run.counters.values())
    finally:
        driver.close()


def test_k1_bound_counts_the_reads_and_not_the_padding():
    """Three rows of a [3, 32768] batch: 100 bases, one past a tile's edge
    and none; 50 survivors."""
    lengths = [100, roofline.K1_TILE + 1, 0]
    bases = 100 + roofline.K1_TILE + 1
    tiles = 1 + 2 + 0
    nbytes = bases + 3 * 8 + 50 * 12 + tiles * 12
    got = resident_reads.k1_bound_reads_s(lengths, 50, bases, 32)
    assert got == pytest.approx(max(nbytes / roofline.HBM_BYTES_PER_S,
                                    (3 * bases + 12 * bases) / roofline.OPS_PER_S))
    # At width 64 a survivor writes 16 bytes.
    assert resident_reads.k1_bound_reads_s(lengths, 50, bases, 64) == pytest.approx(
        (nbytes + 50 * 4) / roofline.HBM_BYTES_PER_S)


def test_the_driver_refuses_the_hpc_modes():
    """Its K1 bound counts every base as a stream element."""
    cell = cell_of()
    cell.config = dict(cell.config, spec=dict(cell.config["spec"], mode="hpc"))
    with pytest.raises(ValueError):
        resident_reads.Driver(cell).prepare()


def test_on_full_rows_k1_bound_is_the_yardstick_of_the_full_row_cells():
    rows, length, survivors = 32, 1 << 20, 32 * 5000
    tiles = length // roofline.K1_TILE
    for width in (32, 64):
        assert resident_reads.k1_bound_reads_s([length] * rows, survivors, rows * length,
                                               width) == pytest.approx(
            roofline.k1_bound_s(rows, length, tiles, survivors, rows * length, width))


@pytest.fixture
def tiny_root(root):
    """The small checkout with the reads cell's traffic cut to TINY."""
    path = root / "benchmark" / "traffic" / "reads.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), **TINY)))
    return root


def test_the_cell_is_correct_and_its_control_is_not(tiny_root):
    sound = harness.run_cell(CELL, SEED, 0.2, False, device="cpu", root=tiny_root)
    assert sound["correct"], sound["checks"]
    assert sound["checks"]["mismatched_records"]["value"] == 0
    assert sound["checks"]["compared_records"]["value"] > 50
    assert set(sound["metrics"]) == {"batch_gbps", "batch_p95_ms", "setup_s"}
    control = harness.run_cell(CELL, SEED, 0.2, False, control=True, device="cpu",
                               root=tiny_root)
    assert not control["correct"]
    assert control["checks"]["mismatched_records"]["value"] > 50


def test_the_cell_catches_a_record_past_a_reads_end(tiny_root, monkeypatch):
    """A fault under the timed path: every row keeps one record more than
    it has, as a program that read past the length might."""
    from rust_seq2kminmers_torch import api

    real = api._cached_pipeline

    def cached(spec):
        step = real(spec)

        def one_more(codes, lengths):
            out = step(codes, lengths)
            return out._replace(n_kminmers=out.n_kminmers + 1)
        return one_more

    monkeypatch.setattr(api, "_cached_pipeline", cached)
    assert not harness.run_cell(CELL, SEED, 0.2, False, device="cpu", root=tiny_root)["correct"]
