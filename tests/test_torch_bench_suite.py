"""The port's per-stage benchmark suite (``rust_seq2kminmers_torch/
bench_suite.py``) on the CPU: the reference suite's case names in its
order, the command line's rows, its pool, its dense hash stage against
the oracle, and no fall-back to the CPU when a GPU is asked for."""

import json

import jax  # noqa: F401  (the reference package's own import, made explicit)
import numpy as np
import pytest
import torch

from rust_seq2kminmers_torch import bench_suite as bs
from rust_seq2kminmers_torch import oracle
from rust_seq2kminmers_torch.constants import with_keep_bits
from rust_seq2kminmers_torch.io import native_ext
from rust_seq2kminmers_tpu import bench_suite as jbs

# The reference suite's device cases, in its order (its bench_suite.py:
# device_cases); running them would compile nine jax pipelines.
DEVICE_CASES = [
    "nthash32_dense_l31",
    "kminmers_regular_l31_k5_d0.01",
    "kminmers_simd_l31_k5_d0.01",
    "kminmers_hpc_l31_k5_d0.01",
    "kminmers_hpcsimd_l31_k5_d0.01",
    "kminmers_regular_nthash2_l45",
    "kminmers_hpc_l100_k5",
    "kminmers_regular_u64_l31",
    "kminmers_regular_u16_l31",
]


def test_host_cases_are_the_reference_cases():
    """The nine rows of the reference suite, in its order, its three
    in-library loop rows included (it yields those where its extension
    loads, as it does here), each labelled with the host library that
    served it."""
    rows = list(bs.host_cases(1000))
    want = [r["case"] for r in jbs.host_cases(1000)]
    assert [r["case"] for r in rows] == want and len(rows) == 9
    assert all(r["case"].endswith("_native_loop") for r in rows[6:])
    label = bs.host_backend()
    assert label.startswith("host-native-c++ (avx512; " if native_ext.avx512()["rle"]
                            else "host-native-c++ (scalar; ")
    assert [r["backend"] for r in rows] == [label] * 6 + [f"{label}, in-library loop"] * 3
    assert all(r["value"] > 0 and r["size"] == 1000 for r in rows)


def test_device_cases_on_the_cpu():
    rows = list(bs.device_cases(size=1 << 16, steps=2, device="cpu"))
    assert [r["case"] for r in rows] == DEVICE_CASES
    for r in rows:
        assert r["value"] > 0 and r["step_ms"] > 0
        assert r["batch"] == [1, 1 << 16] and r["steps_per_sync"] == 2
        assert r["backend"] == "cpu" and r["power_limit"] is None
    for r in rows[1:]:
        assert r["m_cap"] == int((1 << 16) * 0.02) + 256 and r["k"] == 5


def test_command_line_prints_host_and_device_rows(capsys):
    bs.main(["--device", "cpu", "--size", "65536", "--steps", "2", "--host-size", "1000"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["case"] for r in rows[9:]] == DEVICE_CASES
    assert len(rows) == 18 and all(r["value"] > 0 for r in rows)


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        list(bs.device_cases(1 << 16, 1, "cuda"))
    with pytest.raises(RuntimeError, match="cuda"):
        bs.main(["--size", "65536", "--steps", "1", "--host-size", "100"])


def test_pool_is_seeded_xcodes():
    pool = bs.make_pool(2, 4096, "cpu")
    assert pool.shape == (bs.POOL, 2, 4096) and pool.dtype == torch.uint8
    assert torch.equal(pool, bs.make_pool(2, 4096, "cpu"))
    assert len({bytes(p.numpy()) for p in pool}) == bs.POOL
    for p in pool:
        np.testing.assert_array_equal(p.numpy(), with_keep_bits(p.numpy() & 7))
        assert int((p & 7).max()) <= 3


def test_dense_hash_equals_the_oracle():
    pool = bs.make_pool(2, 4096, "cpu")
    got = bs.dense_hash(pool[3]).numpy()
    assert got.shape == (2, 4096 - 30)
    for row, codes in zip(got, pool[3].numpy() & 7):
        fh, rh = oracle.sliding_nthash32(codes, 31)
        np.testing.assert_array_equal(row, np.minimum(fh, rh))


def test_pipeline_cases_checksum():
    """Each case's spec is the reference suite's (M = int(L * 0.02) +
    256), and the checksum is n_kminmers + hash_lo + start summed."""
    cases = bs.pipeline_cases(1 << 14)
    assert [c for c, _ in cases] == DEVICE_CASES[1:]
    assert {s.max_minimizers for _, s in cases} == {int((1 << 14) * 0.02) + 256}
    assert [(s.mode, s.l, s.hash_width, s.variant) for _, s in cases][4:] == [
        ("regular", 45, 32, "nthash2"), ("hpc", 100, 32, "nthash1"),
        ("regular", 31, 64, "nthash1"), ("regular", 31, 16, "nthash1")]
    from rust_seq2kminmers_torch.ops.pipeline import kminmer_pipeline

    pool = bs.make_pool(1, 1 << 14, "cpu")
    out = kminmer_pipeline(pool[0], torch.tensor([1 << 14], dtype=torch.int32), cases[3][1])
    want = (int(out.n_kminmers.sum()) + int(out.hash_lo.to(torch.int64).sum())
            + int(out.start.to(torch.int64).sum()))
    assert int(out.n_kminmers[0]) > 0 and int(bs.checksum(out)) == want
