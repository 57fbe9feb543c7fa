"""Hash widths 16/64 and the nthash2 variant in the port: the plain
sliding hashes, the u16 murmur mix, the pre-mixed assembly, K1's plain
version, and the fused pipeline (K1 -> K2 -> K3), against the reference
package (its XLA stages, and its fused Pallas kernels in interpret mode).
All values are integers: equality is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_seq2kminmers_torch.convert import batch_to_numpy, spec_from_jax
from rust_seq2kminmers_torch.ops import nthash as port_nthash
from rust_seq2kminmers_torch.ops import u64 as port_u64
from rust_seq2kminmers_torch.ops.assemble import assemble_plain
from rust_seq2kminmers_torch.ops.cuda.assemble_kernel import assemble_kminmers_cuda
from rust_seq2kminmers_torch.ops.pipeline import kminmer_pipeline
from rust_seq2kminmers_tpu.constants import XCODE_PAD, encode_xcodes, family_of_mode
from rust_seq2kminmers_tpu.ops import nthash as jax_nthash
from rust_seq2kminmers_tpu.ops import u64 as jax_u64
from rust_seq2kminmers_tpu.ops.assemble import assemble_kminmers_mixed
from rust_seq2kminmers_tpu.ops.pipeline import KminmerBatch as JaxBatch
from rust_seq2kminmers_tpu.ops.pipeline import PipelineSpec as JaxSpec
from rust_seq2kminmers_tpu.ops.pipeline import kminmer_pipeline as jax_pipeline

HASHES = ["sliding_nthash16", "sliding_nthash64", "sliding_nthash2_31"]


def _u64(x):
    """A hash output as numpy uint64: a (hi, lo) pair, a uint32 array, or
    the port's int64 (bit patterns at width 64)."""
    if isinstance(x, tuple):
        return jax_u64.to_py_u64(x)
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint64)
    return np.asarray(x).astype(np.uint64)


@pytest.mark.parametrize("l", [1, 2, 31, 32, 64, 255, 301])
@pytest.mark.parametrize("name", HASHES)
def test_sliding_hash_matches_reference(name, l):
    rng = np.random.default_rng(l)
    codes = rng.integers(0, 16, size=(2, 700)).astype(np.uint8)  # keep bits too
    got = getattr(port_nthash, name)(torch.from_numpy(codes), l)
    want = getattr(jax_nthash, name)(jnp.asarray(codes), l)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u64(g), _u64(w))


def test_murmur_mix_exhaustive():
    """All 65,536 u16 inputs, plus inputs whose high bits the mix drops."""
    x = np.arange(1 << 16, dtype=np.uint32)
    want = jax_u64.to_py_u64(jax_u64.mix64_murmur_from_u16(jnp.asarray(x)))
    got = port_u64.mix64_murmur_from_u16(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    high = torch.from_numpy((x.astype(np.int64) | (0xBEEF << 16)).view(np.int64))
    assert torch.equal(port_u64.mix64_murmur_from_u16(high), got)


@pytest.mark.parametrize("k", [1, 2, 5, 8])
@pytest.mark.parametrize("hash_width", [16, 64])
def test_assemble_mixed_matches_reference(hash_width, k):
    """The assembly after the u16 murmur mix, and on u64 (hi, lo) hashes
    (identity mix), through K3's wrapper on the CPU."""
    rng = np.random.default_rng(k)
    lo = rng.integers(0, 2**32, size=(3, 300), dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 2**32, size=(3, 300), dtype=np.uint64).astype(np.uint32)
    hi[:, ::3] = 0xFFFFFFFF  # near the top of u64
    if hash_width == 16:
        lo &= 0xFFFF
        mixed = jax_u64.mix64_murmur_from_u16(jnp.asarray(lo))
        hi_t = None
    else:
        mixed = (jnp.asarray(hi), jnp.asarray(lo))
        hi_t = torch.from_numpy(hi.view(np.int32))
    lo_t = torch.from_numpy(lo.view(np.int32))
    (phi, plo), prev = assemble_kminmers_cuda(lo_t, k, hash_width, hi_t)
    (jhi, jlo), jrev = assemble_kminmers_mixed(mixed, k)
    np.testing.assert_array_equal(
        port_u64.to_py_u64((phi, plo)), jax_u64.to_py_u64((jhi, jlo))
    )
    np.testing.assert_array_equal(prev.numpy(), np.asarray(jrev))
    again = assemble_plain(lo_t, k, hash_width, hi_t)
    assert torch.equal(again[0][1], plo) and torch.equal(again[1], prev)


def _batch(seed, mode, B=2, L=2048, alphabet="AACCGGTTAANNacgtQ"):
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


FUSED_CASES = [
    ("regular", 31, 16, "nthash1"),
    ("hpc", 11, 16, "nthash1"),
    ("regular", 21, 64, "nthash1"),
    ("hpc", 31, 64, "nthash1"),
    ("regular", 45, 32, "nthash2"),
    ("simd", 31, 32, "nthash2"),
    ("hpc", 200, 32, "nthash2"),
    ("hpcsimd", 64, 32, "nthash2"),
]


@pytest.mark.parametrize("mode,l,hash_width,variant", FUSED_CASES)
def test_fused_path_widths_match_reference(mode, l, hash_width, variant):
    """The fused path (2 <= l <= 255) at every new width and variant
    against the reference's fused Pallas route, all 12 fields."""
    codes, lengths = _batch(seed=l + hash_width, mode=mode)
    jspec = JaxSpec(
        l=l, k=3, density=0.03, mode=mode, max_minimizers=256,
        hash_width=hash_width, variant=variant, compaction="fused_interpret",
    )
    want = jax.jit(lambda c, n: jax_pipeline(c, n, jspec))(
        jnp.asarray(codes), jnp.asarray(lengths)
    )
    spec = spec_from_jax(jspec)
    assert spec.fused
    got = kminmer_pipeline(torch.from_numpy(codes), torch.from_numpy(lengths), spec)
    assert int(got.n_kminmers.min()) > 0
    if hash_width == 64:
        assert int(got.min_hash_hi.abs().sum()) > 0
    _assert_batches_equal(got, want)
