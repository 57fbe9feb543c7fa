"""The port's span recorder (``rust_seq2kminmers_torch/tracing.py``): off,
nothing is kept; under ``recording()`` or a ``torch.profiler`` session,
spans nest with their parents and call ids, the ring keeps its bound and
counts what it dropped, and ``kminmers_batch`` and the long read record
their spans (the producer thread's too).

The ``cuda`` test checks the shared clock on the card, under the profiler
with CUDA activity only, as the benchmark traces a window.  This file
imports no jax, so it also runs without the repo's conftest:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_tracing.py
"""

import threading

import numpy as np
import pytest
import torch

from rust_seq2kminmers_torch import api, kminmers_long, tracing
from rust_seq2kminmers_torch.api import kminmers_batch
from rust_seq2kminmers_torch.constants import with_keep_bits
from rust_seq2kminmers_torch.ops.pipeline import PipelineSpec

SPEC = PipelineSpec(l=31, k=5, density=0.01, mode="hpcsimd")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _batch(B=2, L=4096, seed=5, device="cpu"):
    rng = np.random.default_rng(seed)
    codes = with_keep_bits(rng.integers(0, 4, size=(B, L)).astype(np.uint8))
    return (torch.from_numpy(codes).to(device),
            torch.full((B,), L, dtype=torch.int32, device=device))


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_off_nothing_is_recorded():
    mark = tracing.RECORDER.kept
    with tracing.span("outer"):
        with tracing.span("inner"):
            pass
    kminmers_batch(*_batch(), SPEC)
    assert tracing.current_call() == 0
    assert tracing.RECORDER.kept == mark


def test_spans_nest_with_parents_and_call_ids():
    with tracing.recording() as got:
        with tracing.span("a"):
            with tracing.span("b"):
                with tracing.span("c"):
                    call = tracing.current_call()
            with tracing.span("d"):
                pass
        with tracing.span("e"):
            pass
    assert [r.name for r in got] == ["c", "b", "d", "a", "e"]
    r = _by_name(got)
    a, b, c, d, e = (r[n][0] for n in "abcde")
    assert a.parent == 0 and a.call == a.id == call
    assert b.parent == a.id and c.parent == b.id and d.parent == a.id
    assert {b.call, c.call, d.call} == {a.id}
    assert e.parent == 0 and e.call == e.id != a.id
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= d.start_ns
    assert d.end_ns <= a.end_ns <= e.start_ns <= e.end_ns
    assert tracing.current_call() == 0


def test_a_working_thread_records_in_the_callers_call():
    """A thread that cannot see the caller's session records as a root of
    its own, in the call it was handed; handed 0, it records nothing."""
    with tracing.recording() as got:
        with tracing.span("root"):
            call = tracing.current_call()

            def work(c, name):
                with tracing.span(name, call=c):
                    with tracing.span(name + ".inner"):
                        pass

            threads = [threading.Thread(target=work, args=(call, "w")),
                       threading.Thread(target=work, args=(0, "none"))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
    r = _by_name(got)
    assert r["w"][0].parent == 0 and r["w"][0].call == r["root"][0].id
    assert r["w.inner"][0].parent == r["w"][0].id and r["w.inner"][0].call == call
    assert "none" not in r


def test_the_profilers_session_turns_the_recorder_on():
    from torch.profiler import ProfilerActivity, profile

    mark = tracing.RECORDER.kept
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("in.session"):
            pass
    with tracing.span("after.session"):
        pass
    assert [r.name for r in tracing.RECORDER.since(mark)] == ["in.session"]


def test_the_ring_keeps_its_bound_and_counts_what_it_dropped():
    rec = tracing.Recorder(capacity=4)
    with rec.recording() as got:
        for i in range(10):
            with rec.span(f"s{i}"):
                pass
    assert len(rec.records) == 4 and rec.kept == 10 and rec.dropped == 6
    assert [r.name for r in rec.spans()] == ["s6", "s7", "s8", "s9"]
    assert got == rec.spans()
    assert [r.name for r in rec.since(8)] == ["s8", "s9"]
    assert [r.name for r in rec.since(0)] == ["s6", "s7", "s8", "s9"]


def test_self_seconds_take_the_children_out():
    R = tracing.Record
    records = [R("b", 10, 30, 2, 1, 1), R("c", 40, 45, 3, 1, 1), R("a", 0, 100, 1, 0, 1),
               R("b", 200, 210, 5, 4, 4), R("a", 190, 220, 4, 0, 4),
               R("fill", 0, 500, 6, 0, 1)]
    got = tracing.self_seconds(records)
    assert list(got) == ["b", "c", "a", "fill"]
    assert got == pytest.approx({"b": 30e-9, "c": 5e-9, "a": 95e-9, "fill": 500e-9})


def test_a_batch_call_records_its_spans():
    with tracing.recording() as got:
        out = kminmers_batch(*_batch(), SPEC)
    assert bool((out.n_minimizers == out.n_minimizers_raw).all())
    r = _by_name(got)
    (root,) = r.pop("batch.call")
    assert root.parent == 0 and root.call == root.id
    assert sorted(r) == ["batch.check", "batch.step", "batch.wait"]
    for name, spans in r.items():
        assert len(spans) == 1, name
        s = spans[0]
        assert s.parent == root.id and s.call == root.id
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    assert r["batch.step"][0].end_ns <= r["batch.wait"][0].start_ns
    assert r["batch.wait"][0].end_ns <= r["batch.check"][0].start_ns


def test_a_forced_overflow_gives_a_rescue_span_a_rerun(monkeypatch):
    attempts = []
    real = api._cached_pipeline

    def counted(spec):
        attempts.append(spec)
        return real(spec)

    monkeypatch.setattr(api, "_cached_pipeline", counted)
    tight = PipelineSpec(l=31, k=5, density=0.5, mode="hpcsimd", max_minimizers=128)
    with tracing.recording() as got:
        out = kminmers_batch(*_batch(), tight)
    assert bool((out.n_minimizers == out.n_minimizers_raw).all())
    r = _by_name(got)
    reruns = len(attempts) - 1
    assert reruns >= 1
    assert len(r["batch.call"]) == 1
    assert len(r["batch.rescue"]) == reruns
    assert len(r["batch.step"]) == len(r["batch.wait"]) == len(r["batch.check"]) == reruns + 1
    assert {s.call for s in got} == {r["batch.call"][0].id}


def test_the_long_read_records_its_spans_and_its_producers():
    rng = np.random.default_rng(11)
    seq = "".join(rng.choice(list("ACGT"), 20_000))
    chunk = 4096
    with tracing.recording() as got:
        recs = kminmers_long(seq, 31, 5, 0.01, "hpcsimd", chunk=chunk, device="cpu")
    assert len(recs["hash"]) > 0
    r = _by_name(got)
    (root,) = r["long.call"]
    nchunks = -(-len(seq) // chunk)
    for name in ("long.setup", "long.counts", "long.gather", "long.assemble", "long.fetch",
                 "long.records"):
        assert len(r[name]) == 1 and r[name][0].parent == root.id, name
    for name in ("long.fill", "long.wait_staged", "long.dispatch"):
        assert len(r[name]) == nchunks, name
    assert all(s.parent == 0 for s in r["long.fill"])  # the producer thread's roots
    assert {s.call for s in got} == {root.id}
    parts = tracing.self_seconds(got)
    main = sum(v for k, v in parts.items() if k != "long.fill")
    assert main == pytest.approx((root.end_ns - root.start_ns) / 1e9)


@pytest.mark.cuda
def test_spans_fall_on_the_device_traces_clock(cuda):
    """Under a profiler session with CUDA activity only, as the benchmark
    traces its window: the calls record their spans, every ``step.replay``
    holds exactly one ``cudaGraphLaunch`` of the session, and every
    ``batch.wait`` a device-to-host ``cudaMemcpyAsync``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    codes, lengths = _batch(B=4, L=1 << 16, device=cuda)
    kminmers_batch(codes, lengths, SPEC)  # the capture, outside the session
    torch.cuda.synchronize()
    mark = tracing.RECORDER.kept
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            kminmers_batch(codes, lengths, SPEC)
        torch.cuda.synchronize()
    r = _by_name(tracing.RECORDER.since(mark))
    assert len(r["batch.call"]) == 5 and "step.capture" not in r
    assert len(r["step.replay"]) == 5 and len(r["batch.wait"]) == 5

    events = list(prof.profiler.kineto_results.events())
    device = {}
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            device[e.correlation_id()] = e.name()
    host = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e.correlation_id())
            for e in events if e.device_type() != DeviceType.CUDA and e.name().startswith("cuda")]
    launches = [h for h in host if h[2] == "cudaGraphLaunch"]
    assert len(launches) == 5, sorted({h[2] for h in host})
    for s in r["step.replay"]:
        inside = [h for h in launches if s.start_ns <= h[0] and h[1] <= s.end_ns]
        nearest = min(launches, key=lambda h: abs(h[0] - s.start_ns))
        assert len(inside) == 1, (
            f"step.replay [{s.start_ns}, {s.end_ns}] holds {len(inside)} launches; the "
            f"nearest starts {nearest[0] - s.start_ns} ns after it and ends "
            f"{nearest[1] - s.end_ns} ns after it")
    for s in r["batch.wait"]:
        copies = [device.get(h[3], "") for h in host
                  if h[2] == "cudaMemcpyAsync" and s.start_ns <= h[0] and h[1] <= s.end_ns]
        assert any("DtoH" in name for name in copies), (copies, sorted(set(device.values())))
