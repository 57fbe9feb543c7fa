"""The profiler reads of the port's measuring scripts: a session that
records no device event is run again, and after ``PROFILE_TRIES`` empty
sessions the device time is reported as not measured instead of failing.

torch.profiler is replaced by a stub here (the CPU has no device events to
record); the scripts' real sessions run on the card."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from rust_seq2kminmers_torch.scripts import prof_graph, prof_long_read, prof_stream


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


@pytest.mark.parametrize("empty_first", [0, 1, prof_long_read.PROFILE_TRIES - 1])
def test_device_events_retries_an_empty_session(stub_profiler, empty_first):
    host_only = [_event(0, 5, "aten::add", DeviceType.CPU)]
    device = [_event(0, 10), _event(5, 20), _event(30, 40, "Memcpy HtoD")]
    prof = stub_profiler([host_only] * empty_first + [host_only + device])
    calls = []
    events, wall = prof_long_read.device_events(lambda: calls.append(1))
    assert [e.name for e in events] == [e.name for e in device]
    assert prof.opened == len(calls) == empty_first + 1 and wall >= 0
    assert prof_long_read.device_busy(events) == (30 / 1e6, 35 / 1e6)


def test_no_device_event_is_reported_not_measured(stub_profiler, capsys):
    tries = prof_long_read.PROFILE_TRIES
    prof = stub_profiler([[]] * tries)
    calls = []
    assert prof_long_read.device_events(lambda: calls.append(1))[0] == []
    assert prof.opened == len(calls) == tries
    assert capsys.readouterr().err.count("recorded no device event") == tries

    stub_profiler([[]] * tries)
    assert prof_long_read.profile_call(lambda: None) is None
    stub_profiler([[]] * tries)
    assert prof_graph.profiled(lambda i: None, reps=2) is None
    assert prof_stream.describe_profile(()) == prof_long_read.NOT_MEASURED
    r = {"capture_s": 0.1, "pool_mib": 1.0, "event_ms": [("eager", 1.0)],
         "host_ms": [("eager", 1.0)], "profile": {"eager": None, "graph": None}}
    assert prof_graph.describe("main", r).count(prof_long_read.NOT_MEASURED) == 2


def test_profile_call_and_graph_profile_read_the_events(stub_profiler):
    device = [_event(0, 2000, "scan_kernel"),
              _event(1000, 3000, "Memcpy DtoD (Device -> Device)"),
              _event(4000, 5000, "CatArrayBatchedCopy")]
    stub_profiler([[], device])
    wall, union, summed, n, by_name = prof_long_read.profile_call(lambda: None)
    assert (union, summed, n) == (4000 / 1e6, 5000 / 1e6, 3)
    assert by_name["scan_kernel"] == (1, 2.0)
    stub_profiler([device])
    out = prof_graph.profiled(lambda i: None, reps=2)
    assert out["busy_ms"] == pytest.approx(4000 / 1e6 / 2 * 1e3)
    assert out["kernels"] == 1.0 and out["input copy_ms"] == pytest.approx(1.0)
    assert out["handoff_ms"] == pytest.approx(0.5)
