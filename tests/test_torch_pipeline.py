"""The port's pipeline (rust_seq2kminmers_torch/ops/pipeline.py) and API
(api.py) on the CPU.  The pipeline is held against the reference
package's kminmer_pipeline: the fused path with its Pallas kernels in
interpret mode, and the default XLA path; all 12 KminmerBatch fields are
integers and compared exactly, dtypes included.  The API reproduces the
15 u32 golden hashes, equals the reference's numpy oracle record for
record in all four modes, rescues overflows losslessly, and never runs a
GPU request on the CPU."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_seq2kminmers_torch import KminmersIterator, KSizeTooBig, kminmers_list
from rust_seq2kminmers_torch.api import kminmers_batch
from rust_seq2kminmers_torch.constants import XCODE_PAD, encode_xcodes, family_of_mode
from rust_seq2kminmers_torch.convert import batch_to_numpy, spec_from_jax
from rust_seq2kminmers_torch.ops.pipeline import (
    PipelineSpec,
    kminmer_pipeline,
    kminmer_pipeline_plain,
)
from rust_seq2kminmers_tpu.ops.pipeline import KminmerBatch as JaxBatch
from rust_seq2kminmers_tpu.ops.pipeline import PipelineSpec as JaxSpec
from rust_seq2kminmers_tpu.ops.pipeline import kminmer_pipeline as jax_pipeline
from rust_seq2kminmers_tpu.oracle import HashMode
from rust_seq2kminmers_tpu.oracle import kminmers as oracle_kminmers
from test_goldens import GOLDEN_HASHES_U32

GOLDENS = Path(__file__).parent / "data" / "goldens_u32.json"


def _batch(seed, mode, B=2, L=4096, alphabet="AACCGGTTAANNacgtQ"):
    rng = np.random.default_rng(seed)
    codes = np.full((B, L), XCODE_PAD, dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    for b in range(B):
        n = int(rng.integers(L // 2, L - 1))
        s = "".join(rng.choice(list(alphabet), size=n))
        codes[b, :n] = encode_xcodes(s, family_of_mode(mode))
        lengths[b] = n
    return codes, lengths


def _assert_batches_equal(port_out, jax_out):
    got = batch_to_numpy(port_out)
    for name in JaxBatch._fields:
        want = np.asarray(getattr(jax_out, name))
        have = getattr(got, name)
        assert have.dtype == want.dtype, name
        np.testing.assert_array_equal(have, want, err_msg=name)


@pytest.mark.parametrize("compaction", ["fused_interpret", "auto"])
@pytest.mark.parametrize("mode", ["regular", "simd", "hpc", "hpcsimd"])
def test_pipeline_matches_reference(mode, compaction):
    codes, lengths = _batch(seed=len(mode), mode=mode)
    jspec = JaxSpec(
        l=7, k=3, density=0.02, mode=mode, max_minimizers=256,
        compaction=compaction,
    )
    want = jax.jit(lambda c, n: jax_pipeline(c, n, jspec))(
        jnp.asarray(codes), jnp.asarray(lengths)
    )
    got = kminmer_pipeline(
        torch.from_numpy(codes), torch.from_numpy(lengths), spec_from_jax(jspec)
    )
    assert int(got.n_kminmers.min()) > 0
    _assert_batches_equal(got, want)


def test_plain_pipeline_is_the_cpu_path():
    """On CPU tensors the kernel wrappers take their plain versions, so
    the two entry points agree field for field."""
    codes, lengths = _batch(seed=5, mode="hpcsimd", L=8192)
    spec = spec_from_jax(JaxSpec(l=31, k=5, density=0.01, mode="hpcsimd"))
    a = kminmer_pipeline(torch.from_numpy(codes), torch.from_numpy(lengths), spec)
    b = kminmer_pipeline_plain(
        torch.from_numpy(codes), torch.from_numpy(lengths), spec
    )
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _records(recs):
    return [(r.hash, r.start, r.end, r.offset, r.rev) for r in recs]


def test_goldens(ecoli_seq):
    """The 15 u32 golden hashes (KminmersIterator(l=10, k=5, d=0.0001,
    Regular); the list of tests/test_goldens.py)."""
    g = json.loads(GOLDENS.read_text())
    assert g["hashes"] == GOLDEN_HASHES_U32
    it = KminmersIterator(
        ecoli_seq, g["l"], g["k"], g["density"], g["mode"], device="cpu"
    )
    assert [km.get_hash() for km in it] == g["hashes"]
    assert [km.offset for km in it] == list(range(len(g["hashes"])))


@pytest.mark.parametrize("mode", list(HashMode))
@pytest.mark.parametrize("l,k,d", [(10, 5, 0.0005), (31, 5, 0.01)])
def test_matches_oracle(ecoli_seq, mode, l, k, d):
    got = kminmers_list(ecoli_seq, l, k, d, mode, device="cpu")
    want = oracle_kminmers(ecoli_seq, l, k, d, mode)
    assert len(want) > 0
    assert _records(got) == _records(want)


def test_overflow_rescue_is_lossless(ecoli_seq):
    """Tiny per-tile and stream capacities overflow; the rescue reruns
    until no survivor is lost, and the result is the oracle's."""
    seq = ecoli_seq[:20000]
    codes = np.full((1, 32768), XCODE_PAD, dtype=np.uint8)
    codes[0, : len(seq)] = encode_xcodes(seq, "simd")
    lengths = torch.tensor([len(seq)], dtype=torch.int32)
    spec = PipelineSpec(
        l=11, k=3, density=0.05, mode="hpcsimd", max_minimizers=64, tile_cap=8
    )
    first = kminmer_pipeline(torch.from_numpy(codes), lengths, spec)
    assert int(first.n_minimizers[0]) < int(first.n_minimizers_raw[0])
    out = kminmers_batch(torch.from_numpy(codes), lengths, spec)
    assert torch.equal(out.n_minimizers, out.n_minimizers_raw)
    want = oracle_kminmers(seq, 11, 3, 0.05, HashMode.HpcSimd)
    nk = int(out.n_kminmers[0])
    assert nk == len(want)
    assert out.start[0, :nk].tolist() == [r.start for r in want]


def test_cuda_request_never_runs_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        kminmers_list("ACGT" * 50, 10, 3, 0.1, "regular", device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        KminmersIterator("ACGT" * 50, 10, 3, 0.1, "hpc")  # the default device


def test_limits_and_short_reads():
    with pytest.raises(KSizeTooBig):
        kminmers_list("ACGT" * 50, 32, 3, 0.1, "simd", device="cpu")
    assert kminmers_list("ACGTA", 5, 2, 1.0, "regular", device="cpu") == []
