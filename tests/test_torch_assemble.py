"""K3's plain version (rust_seq2kminmers_torch/ops/assemble.py, taken by
ops/cuda/assemble_kernel.py on CPU tensors) against the reference
package's assembly Pallas kernel in interpret mode and its XLA assembly.
All values are integers: equality is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_seq2kminmers_torch.ops import u64 as port_u64
from rust_seq2kminmers_torch.ops.cuda.assemble_kernel import assemble_kminmers_cuda
from rust_seq2kminmers_tpu.ops import u64 as jax_u64
from rust_seq2kminmers_tpu.ops.assemble import assemble_kminmers
from rust_seq2kminmers_tpu.ops.pallas.assemble_kernel import (
    assemble_kminmers_pallas,
)
from rust_seq2kminmers_tpu.oracle import mixhash_u32


def _hashes(seed, B=3, M=300):
    """u32 hashes, a third of them within 2^16 of 2^32 - 1."""
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 2**32, size=(B, M), dtype=np.uint64)
    near = rng.random((B, M)) < 0.33
    h[near] = 2**32 - 1 - rng.integers(0, 2**16, size=int(near.sum()))
    return h.astype(np.uint32)


@pytest.mark.parametrize("k", [1, 2, 5, 8])
def test_assemble_matches_reference(k):
    h = _hashes(seed=k)
    (phi, plo), prev = assemble_kminmers_cuda(torch.from_numpy(h.view(np.int32)), k)
    got = port_u64.to_py_u64((phi, plo))
    for (jhi, jlo), jrev in (
        assemble_kminmers_pallas(jnp.asarray(h), k, interpret=True),
        assemble_kminmers(jnp.asarray(h), k),
    ):
        np.testing.assert_array_equal(got, jax_u64.to_py_u64((jhi, jlo)))
        np.testing.assert_array_equal(prev.numpy(), np.asarray(jrev))


def test_mix_and_rotates_match_reference():
    """mix64_from_u32, rol64 and the unsigned compare on u64 patterns
    near the sign bit."""
    h = _hashes(seed=99, B=1, M=500)[0]
    mixed = port_u64.mix64_from_u32(port_u64.u32(torch.from_numpy(h.view(np.int32))))
    np.testing.assert_array_equal(mixed.numpy().view(np.uint64), mixhash_u32(h))
    x = torch.from_numpy(mixhash_u32(h).view(np.int64)) ^ port_u64.I64_MIN
    r = torch.arange(500) % 64
    rot = port_u64.rol64(x, r).numpy().view(np.uint64)
    xu, ru = x.numpy().view(np.uint64), r.numpy().astype(np.uint64)
    want = (xu << ru) | np.where(ru == 0, 0, xu >> ((64 - ru) % 64)).astype(np.uint64)
    np.testing.assert_array_equal(rot, want)
    y = torch.roll(x, 1)
    np.testing.assert_array_equal(
        port_u64.ult64(x, y).numpy(), xu < y.numpy().view(np.uint64)
    )
