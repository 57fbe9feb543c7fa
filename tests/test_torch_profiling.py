"""The profiler reads the port's measuring scripts share
(``scripts/common.py``): a session that records no device event is run
again, and after ``PROFILE_TRIES`` empty sessions the device time is
reported as not measured instead of failing.

torch.profiler is replaced by a stub here (the CPU has no device events to
record); the scripts' real sessions run on the card."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from rust_seq2kminmers_torch.scripts import common, prof_stream


def _event(start, end, name="scan_kernel", device=DeviceType.CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


class _Profiler:
    """Stands in for torch.profiler.profile: one event list a session."""

    def __init__(self, sessions):
        self.sessions = list(sessions)
        self.opened = 0

    def __call__(self, activities=None):
        self.opened += 1
        return _Session(self.sessions.pop(0))


class _Session:
    def __init__(self, events):
        self._events = events

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        return self._events


@pytest.fixture
def stub_profiler(monkeypatch):
    import torch.profiler

    def install(sessions):
        prof = _Profiler(sessions)
        monkeypatch.setattr(torch.profiler, "profile", prof)
        return prof

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    return install


@pytest.mark.parametrize("empty_first", [0, 1, common.PROFILE_TRIES - 1])
def test_device_events_retries_an_empty_session(stub_profiler, empty_first):
    host_only = [_event(0, 5, "aten::add", DeviceType.CPU)]
    device = [_event(0, 10), _event(5, 20), _event(30, 40, "Memcpy HtoD")]
    prof = stub_profiler([host_only] * empty_first + [host_only + device])
    calls = []
    events, wall = common.device_events(lambda: calls.append(1))
    assert [e.name for e in events] == [e.name for e in device]
    assert prof.opened == len(calls) == empty_first + 1 and wall >= 0
    assert common.device_busy(events) == (30 / 1e6, 35 / 1e6)


def test_no_device_event_is_reported_not_measured(stub_profiler, capsys):
    tries = common.PROFILE_TRIES
    prof = stub_profiler([[]] * tries)
    calls = []
    assert common.device_events(lambda: calls.append(1))[0] == []
    assert prof.opened == len(calls) == tries
    assert capsys.readouterr().err.count("recorded no device event") == tries

    stub_profiler([[]] * tries)
    assert common.profile(lambda i: None) is None
    prof = stub_profiler([[]] * tries)
    assert common.profile(lambda i: None, 2, keys=("scan_kernel",)) is None
    assert prof.opened == tries
    prof = stub_profiler([[]])
    assert common.profile(lambda i: None, 2, tries=1) is None and prof.opened == 1
    assert prof_stream.describe_profile(()) == common.NOT_MEASURED
    assert str(common.PROFILE_TRIES) in common.NOT_MEASURED


def test_profile_call_and_graph_profile_read_the_events(stub_profiler):
    device = [_event(0, 2000, "scan_kernel"),
              _event(1000, 3000, "Memcpy DtoD (Device -> Device)"),
              _event(4000, 5000, "CatArrayBatchedCopy")]
    stub_profiler([[], device])
    p = common.profile(lambda i: None)
    assert (p.busy_ms, p.summed_ms, p.events, p.kernels) == (4.0, 5.0, 3, 2)
    assert p.by_kernel["scan_kernel"] == (1, 2.0) and 0 <= p.wall_ms
    # Two calls of the compiled step: busy and kernels a call, and the
    # graph's input copy and handoff by name.
    stub_profiler([device])
    p = common.profile(lambda i: None, 2)
    assert p.busy_ms == pytest.approx(4000 / 1e6 / 2 * 1e3) and p.kernels == 1.0
    assert p.by_kernel["Memcpy DtoD (Device -> Device)"] == (0.5, pytest.approx(1.0))
    assert p.by_kernel["CatArrayBatchedCopy"] == (0.5, pytest.approx(0.5))
    # keys keeps the events whose names hold one of them, and reads only those.
    stub_profiler([device])
    p = common.profile(lambda i: None, 2, keys=("Cat", "scan"))
    assert set(p.by_kernel) == {"scan_kernel", "CatArrayBatchedCopy"}
    assert (p.events, p.kernels, p.busy_ms, p.summed_ms) == (1.0, 1.0, 1.5, 1.5)


def test_profile_drops_each_result(stub_profiler):
    """A call's result is dropped before the next call starts, so the
    allocator can reuse its memory inside the traced window."""
    import gc
    import weakref

    class Result:
        pass

    last, alive = [], []

    def call(i):
        gc.collect()
        alive.append(any(r() is not None for r in last))
        out = Result()
        last.append(weakref.ref(out))
        return out

    stub_profiler([[_event(0, 10)]])
    assert common.profile(call, 3) is not None
    assert alive == [False, False, False]


def test_prof_parallel_main_prints_the_cards(monkeypatch, capsys):
    """``prof_parallel.main`` on a stubbed host of four GPUs: the cards'
    lines come first, then a world of 2 and of 4 runs on one FASTA."""
    from rust_seq2kminmers_torch.scripts import prof_parallel, prof_stream

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(prof_parallel, "cards", lambda: ["GPU A, 700.00 W", "GPU B, 700.00 W"])
    monkeypatch.setattr(prof_stream, "make_reads", lambda: None)
    monkeypatch.setattr(prof_stream, "write_fasta", lambda path, reads: 0)
    worlds = []
    monkeypatch.setattr(prof_parallel, "run", lambda w, path: worlds.append(w) or True)
    assert prof_parallel.main([]) == 0
    assert worlds == [2, 4]
    assert capsys.readouterr().out.startswith("GPU A, 700.00 W\nGPU B, 700.00 W\n")
