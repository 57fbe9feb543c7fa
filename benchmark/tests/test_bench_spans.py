"""The API layer's readers (``metrics/api.*.batch.py``,
``metrics/step.captures.batch.py``) on synthetic buffers of the program's
recorder: each reads its definition over the window's calls, the window
is the last ``run.steps`` calls (an earlier session's spans are left
out), and without spans, or without the recorder, each reads None."""

from __future__ import annotations

import sys

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT

READERS = ["api.issue_us.batch", "api.check_us.batch", "api.host_share.batch",
           "step.captures.batch", "api.rescue_share.batch"]
US = 1000  # ns


def reader(name):
    return harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                               f"bench_metric_{name}")


def run_of(steps, window_s):
    return harness.Run(setup_s=0.0, window_s=window_s, steps=steps, bases=0,
                       latencies_s=[], spans=[], counters={})


class Buffer:
    """Records laid out as ``kminmers_batch`` calls lay them."""

    def __init__(self, tracing):
        self.tracing, self.records, self.next_id, self.t = tracing, [], 1, 10**18

    def call(self, issue_us, wait_us, check_us, captures=0, rescues=0):
        R = self.tracing.Record
        root, t0 = self.next_id, self.t
        end = t0 + (wait_us + check_us) * US
        ids = iter(range(root + 1, root + 100))
        self.records += [R("step.capture", t0 + US, t0 + 2 * US, next(ids), root + 1, root)
                         for _ in range(captures)]
        self.records += [
            R("step.handoff", t0 + issue_us * US - US, t0 + issue_us * US, next(ids),
              root + 1, root),
            R("batch.step", t0, t0 + issue_us * US, next(ids), root, root),
            R("batch.wait", t0 + issue_us * US, t0 + wait_us * US, next(ids), root, root),
            R("batch.check", t0 + wait_us * US, end, next(ids), root, root),
        ]
        self.records += [R("batch.rescue", end - US, end, next(ids), root, root)
                         for _ in range(rescues)]
        self.records.append(R("batch.call", t0, end, root, 0, root))
        self.next_id, self.t = root + 100, end + 50 * US


@pytest.fixture
def buffer(monkeypatch):
    """The program's recorder replaced by an empty one for the test."""
    from rust_seq2kminmers_torch import tracing

    rec = tracing.Recorder()
    monkeypatch.setattr(tracing, "RECORDER", rec)
    return Buffer(tracing)


def read_all(buf, run):
    buf.tracing.RECORDER.records.extend(buf.records)
    return {name: reader(name).read(run) for name in READERS}


def test_each_reader_on_the_windows_calls(buffer):
    buffer.call(100, 500, 20, captures=1)
    buffer.call(300, 650, 60, rescues=1)
    buffer.call(200, 550, 40)
    got = read_all(buffer, run_of(3, 0.01))
    assert got["api.issue_us.batch"] == pytest.approx(200.0)
    assert got["api.check_us.batch"] == pytest.approx(40.0)
    # (100 + 300 + 200) + (20 + 60 + 40) us of 10 ms
    assert got["api.host_share.batch"] == pytest.approx(7.2)
    assert got["step.captures.batch"] == 1.0
    assert got["api.rescue_share.batch"] == pytest.approx(100 / 3)


def test_the_window_is_the_last_steps_calls(buffer):
    """An earlier session's calls (a profiler session that came back empty
    and was run again) lie before the window's and are left out."""
    for _ in range(4):
        buffer.call(5000, 9000, 900, captures=2, rescues=1)
    buffer.call(100, 400, 30)
    buffer.call(120, 450, 50)
    got = read_all(buffer, run_of(2, 0.001))
    assert got["api.issue_us.batch"] == pytest.approx(110.0)
    assert got["api.check_us.batch"] == pytest.approx(40.0)
    assert got["api.host_share.batch"] == pytest.approx(30.0)
    assert got["step.captures.batch"] == 0.0
    assert got["api.rescue_share.batch"] == 0.0


def test_none_without_spans(buffer):
    assert read_all(buffer, run_of(5, 1.0)) == dict.fromkeys(READERS)


def test_none_from_a_program_without_the_recorder(buffer, monkeypatch):
    buffer.call(100, 400, 30)
    buffer.tracing.RECORDER.records.extend(buffer.records)
    import rust_seq2kminmers_torch as program

    monkeypatch.delattr(program, "tracing")
    monkeypatch.setitem(sys.modules, "rust_seq2kminmers_torch.tracing", None)
    assert {name: reader(name).read(run_of(1, 1.0)) for name in READERS} == \
        dict.fromkeys(READERS)
