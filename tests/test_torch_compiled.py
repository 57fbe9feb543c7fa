"""The port's compiled step on the CPU: ``make_pipeline`` against the
reference package's jitted ``make_pipeline``, the cached pipeline and
``precompile_rescue`` against the reference's rescue, the entry points
that reach the cached pipeline, the launch counters of a capture, and the
twin of ``bench.py``.  On the CPU the compiled step is ``kminmer_pipeline``
itself (as jit on the CPU is the function); the captured graphs are held
to the eager step on the card (``tests/test_torch_cuda.py``).  All fields
are integers and compared exactly, dtypes included."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rust_seq2kminmers_torch as port
from rust_seq2kminmers_torch import api, bench_suite
from rust_seq2kminmers_torch.constants import encode_xcodes
from rust_seq2kminmers_torch.convert import spec_from_jax
from rust_seq2kminmers_torch.io import stream
from rust_seq2kminmers_torch.ops.cuda import build
from rust_seq2kminmers_torch.ops.cuda.graph import CapturedStep
from rust_seq2kminmers_torch.ops.pipeline import CompiledPipeline, PipelineSpec, kminmer_pipeline
from rust_seq2kminmers_torch.scripts import bench as twin
from rust_seq2kminmers_tpu import api as jax_api
from rust_seq2kminmers_tpu.ops.pipeline import PipelineSpec as JaxSpec
from rust_seq2kminmers_tpu.ops.pipeline import make_pipeline as jax_make_pipeline
from test_torch_pipeline import _assert_batches_equal, _batch

# The fused hpcsimd l=31 u32, the general nthash2 l=301 and the regular u64
# l=31 specs of chip_smoke.py, at a density that gives a 4 kb read records.
SPECS = {
    "fused hpcsimd l=31 u32": dict(l=31, k=5, density=0.05, mode="hpcsimd"),
    "general hpcsimd nthash2 l=301": dict(l=301, k=5, density=0.05, mode="hpcsimd",
                                          variant="nthash2"),
    "regular u64 l=31": dict(l=31, k=5, density=0.05, mode="regular", hash_width=64),
}


@pytest.mark.parametrize("what", list(SPECS))
def test_make_pipeline_matches_reference(what):
    kw = SPECS[what]
    jspec = JaxSpec(**kw)
    codes, lengths = _batch(seed=len(what), mode=kw["mode"], L=4096)
    want = jax_make_pipeline(jspec)(jnp.asarray(codes), jnp.asarray(lengths))
    fn = port.make_pipeline(spec_from_jax(jspec))
    got = fn(torch.from_numpy(codes), torch.from_numpy(lengths))
    assert int(got.n_kminmers.min()) > 0
    _assert_batches_equal(got, want)
    # A second call on other inputs returns its own batch.
    codes2, lengths2 = _batch(seed=len(what) + 1, mode=kw["mode"], L=4096)
    again = fn(torch.from_numpy(codes2), torch.from_numpy(lengths2))
    _assert_batches_equal(got, want)
    _assert_batches_equal(again, jax_make_pipeline(jspec)(jnp.asarray(codes2),
                                                          jnp.asarray(lengths2)))


def test_cached_pipeline_is_shared_per_spec():
    a = api._cached_pipeline(PipelineSpec(l=21, k=4, density=0.02, mode="hpc"))
    b = api._cached_pipeline(PipelineSpec(l=21, k=4, density=0.02, mode="hpc"))
    c = api._cached_pipeline(PipelineSpec(l=21, k=4, density=0.03, mode="hpc"))
    assert a is b and a is not c and isinstance(a, CompiledPipeline)
    assert a.spec == PipelineSpec(l=21, k=4, density=0.02, mode="hpc")
    assert api._cached_pipeline.cache_info().maxsize == 64


def _overflowing_batch(seed, B=2, L=1024):
    """Random ACGT rows at d = 0.6: more survivors than 8 slots hold (the
    reference's own rescue test, test_overflow_recovery.py)."""
    r = np.random.default_rng(seed)
    rows = ["".join(r.choice(list("ACGT"), size=L)) for _ in range(B)]
    return np.stack([encode_xcodes(s, "scalar") for s in rows]), np.full(B, L, np.int32)


def test_precompile_rescue_then_overflow_matches_reference(monkeypatch):
    """After precompile_rescue, a forced tile overflow is rescued in one
    retry on the precompiled spec, and kminmers_batch equals the
    reference's kminmers_batch (its Pallas kernel in interpret mode, its
    slots overflowing) in all 12 fields."""
    jspec = JaxSpec(l=9, k=2, density=0.6, mode="regular", compaction="fused_interpret",
                    slots=8, rows_out=8, max_minimizers=2048)
    spec = dataclasses.replace(spec_from_jax(jspec), tile_cap=8)
    codes, lengths = _overflowing_batch(0)
    jax_api.precompile_rescue(jspec, codes.shape)
    want = jax_api.kminmers_batch(codes, lengths, jspec)

    api.precompile_rescue(spec, codes.shape, "cpu")
    calls, real = [], api.rescue_spec
    monkeypatch.setattr(api, "rescue_spec", lambda s, n=0: calls.append(n) or real(s, n))
    first = kminmer_pipeline(torch.from_numpy(codes), torch.from_numpy(lengths), spec)
    assert bool((first.n_minimizers < first.n_minimizers_raw).any())
    got = api.kminmers_batch(torch.from_numpy(codes), torch.from_numpy(lengths), spec)
    assert len(calls) == 1 and real(spec, calls[0]) == real(spec)
    assert torch.equal(got.n_minimizers, got.n_minimizers_raw)
    _assert_batches_equal(got, want)


def test_entry_points_reach_the_cached_pipeline(monkeypatch, tmp_path):
    """kminmers_batch and the streaming runner run their batches through
    api._cached_pipeline, as the reference's run through its jitted
    pipelines."""
    seen = []
    real = api._cached_pipeline

    def spy(spec):
        seen.append(spec)
        return real(spec)

    monkeypatch.setattr(api, "_cached_pipeline", spy)
    monkeypatch.setattr(stream, "_cached_pipeline", spy)
    spec = PipelineSpec(l=11, k=3, density=0.05, mode="hpc")
    codes, lengths = _batch(seed=3, mode="hpc", L=2048)
    api.kminmers_batch(torch.from_numpy(codes), torch.from_numpy(lengths), spec)
    assert seen == [spec]
    fasta = tmp_path / "two.fa"
    rng = np.random.default_rng(4)
    fasta.write_text("".join(f">{i}\n" + "".join(rng.choice(list("ACGT"), n)) + "\n"
                             for i, n in enumerate((2400, 1400))))
    stats = stream.stream_file(fasta, spec, device="cpu")
    assert seen[1:] == [spec] and stats.total_kminmers > 0 and stats.warm_s == 0.0


def test_capture_counts_are_taken_back():
    """What wrappers count inside a capture is not a launch: it is taken
    back out of build.launches and kept for the replays to add."""
    saved = build.launches.copy()
    try:
        build.launches.clear()
        build.launches["fused_scan"] = 5
        with build.counted_as_captured() as rise:
            build.launches["fused_scan"] += 1
            build.launches["assemble"] += 2
        assert dict(rise) == {"fused_scan": 1, "assemble": 2}
        assert dict(build.launches) == {"fused_scan": 5}
        with pytest.raises(ValueError):
            with build.counted_as_captured() as rise:
                build.launches["slot_compact"] += 1
                raise ValueError("a failed capture")
        assert dict(build.launches) == {"fused_scan": 5} and dict(rise) == {"slot_compact": 1}
    finally:
        build.launches.clear()
        build.launches.update(saved)


def test_capture_needs_a_gpu(monkeypatch):
    with pytest.raises(ValueError, match="CUDA"):
        CapturedStep(lambda x: (x,), (torch.zeros(4),), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        api.precompile_rescue(PipelineSpec(l=11, k=3, density=0.1), (2, 1024), "cuda")


def test_timed_units_sum_every_step():
    pool = bench_suite.make_pool(1, 1 << 14, "cpu", 3)

    def step(codes):
        return codes.sum(), codes[0, :7].sum()

    dt, sums = bench_suite.timed_units(step, pool, 5)
    want = [sum(int(step(pool[i % 3])[j]) for i in range(5)) for j in range(2)]
    assert dt > 0 and sums == want


# bench.py's JSON line (its lines 121-137).
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
BENCH_DETAIL = {"mode", "l", "k", "density", "batch", "steps_per_sync", "step_ms",
                "kminmers_per_s", "device"}


def test_twin_prints_the_bench_line(capsys):
    assert twin.main(["--device", "cpu", "--size", str(1 << 14), "--steps", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == BENCH_KEYS and set(rec["detail"]) == BENCH_DETAIL
    assert rec["metric"] == "hpc_nthash_kminmers_throughput" and rec["unit"] == "GB/s/chip"
    assert rec["vs_baseline"] is None and rec["value"] > 0
    d = rec["detail"]
    assert (d["mode"], d["l"], d["k"], d["density"]) == ("hpcsimd", 31, 5, 0.01)
    assert d["batch"] == [1, 1 << 14] and d["steps_per_sync"] == 2
    assert d["device"] == "cpu" and d["kminmers_per_s"] > 0 and d["step_ms"] > 0


def test_twin_defaults_are_the_bench_shape(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_suite.batch_shape(twin.SIZE) == (32, 1 << 20)
    assert (twin.POOL, twin.STEPS) == (16, 256)
    with pytest.raises(RuntimeError, match="cuda"):
        twin.main([])


def test_handoff_copies_every_dtype_and_shape():
    """A graph's outputs leave in one copy: each comes back with its
    dtype, shape and values, and later writes to the originals (the next
    replay) leave the copies alone."""
    from rust_seq2kminmers_torch.ops.cuda.graph import Handoff

    g = torch.Generator().manual_seed(3)
    outs = [
        torch.randint(-9, 9, (3, 5), generator=g, dtype=torch.int32),
        torch.randint(0, 2, (3, 5), generator=g).bool(),
        torch.randint(-9, 9, (3,), generator=g, dtype=torch.int32),
        torch.randint(-9, 9, (3, 5), generator=g, dtype=torch.int32),
        torch.tensor(2**40, dtype=torch.int64),  # a 0-d sum
        torch.zeros((3, 0), dtype=torch.int32),
        torch.randint(-9, 9, (3, 7), generator=g, dtype=torch.int32),
        torch.tensor([True, False, True]),
    ]
    hand = Handoff(outs)
    got = hand()
    for o in outs:
        o.add_(1) if o.dtype != torch.bool else o.logical_not_()
    again = hand()
    for o, a, b in zip(outs, got, again):
        assert a.dtype == o.dtype and a.shape == o.shape and a.is_contiguous()
        assert torch.equal(b, o) and not (o.numel() and torch.equal(a, o))
    with pytest.raises(ValueError):
        Handoff([])
    with pytest.raises(ValueError):
        Handoff([torch.zeros(4, 4).t()])
