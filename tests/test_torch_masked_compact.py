"""K4's plain versions (rust_seq2kminmers_torch/ops/cuda/masked_compact.py,
which takes ops/compact.py and ops/hpc.py on CPU tensors) against the
reference package's masked_compact Pallas kernel and hpc_compress in
interpret mode.  The reference leaves its slots past
the count undefined, so it is compared up to the count; the port's fills
past it are checked on their own.  All values are integers: equality is
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_seq2kminmers_torch.ops import hpc as port_hpc
from rust_seq2kminmers_torch.ops.compact import compact
from rust_seq2kminmers_torch.ops.cuda.masked_compact import hpc_compact, masked_compact
from rust_seq2kminmers_tpu.constants import XCODE_PAD, encode_xcodes
from rust_seq2kminmers_tpu.ops import hpc as jax_hpc
from rust_seq2kminmers_tpu.ops.pallas.compact_kernel import GROUP
from rust_seq2kminmers_tpu.ops.pallas.compact_kernel import (
    masked_compact as jax_masked_compact,
)

FILLS = [-7, 0, 255]


def _columns(rng, B, N):
    """An int32 column, a uint32 column (as int32 bits) and a uint8 one."""
    a = rng.integers(-(2**31), 2**31, size=(B, N), dtype=np.int64).astype(np.int32)
    b = rng.integers(0, 2**32, size=(B, N), dtype=np.uint64).astype(np.uint32)
    c = rng.integers(0, 256, size=(B, N), dtype=np.uint8)
    return [a, b.view(np.int32), c]


def _assert_matches_reference(mask, cols, m):
    """The port against the reference kernel, which needs N padded to a
    multiple of 1024 (as its own compact() pads it)."""
    B, N = mask.shape
    outs, count = masked_compact(
        torch.from_numpy(mask), [torch.from_numpy(c) for c in cols], m, FILLS
    )
    npad = -(-N // GROUP) * GROUP - N
    jcols = [jnp.asarray(np.pad(c, ((0, 0), (0, npad)))) for c in cols]
    jouts, jcount = jax_masked_compact(
        jnp.asarray(np.pad(mask, ((0, 0), (0, npad)))), jcols, m, interpret=True
    )
    count = count.numpy()
    np.testing.assert_array_equal(count, np.asarray(jcount))
    np.testing.assert_array_equal(count, mask.sum(axis=1))
    n = np.minimum(count, m)
    for o, j, c, fill in zip(outs, jouts, cols, FILLS):
        o, j = o.numpy(), np.asarray(j)
        assert o.dtype == c.dtype and o.shape == (B, m)
        for b in range(B):
            np.testing.assert_array_equal(o[b, : n[b]], j[b, : n[b]])
            np.testing.assert_array_equal(o[b, : n[b]], c[b][mask[b]][: n[b]])
            assert (o[b, n[b] :] == fill).all()
    return count


@pytest.mark.parametrize("density", [0.0, 0.01, 0.5, 1.0])
def test_masked_compact_matches_reference(density):
    rng = np.random.default_rng(int(density * 100))
    mask = rng.random((3, 2048)) < density
    count = _assert_matches_reference(mask, _columns(rng, 3, 2048), 2048)
    if density in (0.0, 1.0):
        assert (count == 2048 * density).all()


@pytest.mark.parametrize("N,m", [(1500, 40), (1000, 1), (1200, 1200)])
def test_masked_compact_ragged_and_overflow(N, m):
    """N no multiple of 1024; m below the count (the loss shows as count
    > m); m = 1."""
    rng = np.random.default_rng(N + m)
    mask = rng.random((2, N)) < 0.3
    count = _assert_matches_reference(mask, _columns(rng, 2, N), m)
    if m < N:
        assert (count > m).all()


def test_masked_compact_cpu_is_the_plain_version():
    rng = np.random.default_rng(5)
    mask = torch.from_numpy(rng.random((2, 777)) < 0.4)
    cols = [torch.from_numpy(c) for c in _columns(rng, 2, 777)]
    got, n = masked_compact(mask, cols, 300, FILLS)
    want, wn = compact(mask, cols, 300, FILLS)
    assert torch.equal(n, wn)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_masked_compact_rejects_bad_input():
    mask = torch.zeros((2, 8), dtype=torch.bool)
    col = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        masked_compact(mask, [col.to(torch.int64)], 4, [0])
    with pytest.raises(TypeError):
        masked_compact(mask.to(torch.uint8), [col], 4, [0])
    with pytest.raises(ValueError):
        masked_compact(mask, [col] * 5, 4, [0] * 5)
    with pytest.raises(ValueError):
        masked_compact(mask, [col], 0, [0])
    with pytest.raises(ValueError):
        masked_compact(mask, [col[:, :4]], 4, [0])


@pytest.mark.parametrize("family", ["scalar", "simd"])
def test_hpc_compress_matches_reference(family):
    """K4's HPC form on the CPU (one (pos << 3) | code column, m = L): its
    codes, positions and pads, and the count, against the reference's K4
    route."""
    rng = np.random.default_rng(len(family))
    B, L = 3, 2048
    codes = np.full((B, L), XCODE_PAD, dtype=np.uint8)
    lengths = np.array([L, 1500, 0], dtype=np.int32)
    for b in range(B):
        s = "".join(rng.choice(list("AAACCGGTTTNacgQ"), size=int(lengths[b])))
        codes[b, : lengths[b]] = encode_xcodes(s, family)
    pk, count = hpc_compact(torch.from_numpy(codes), torch.from_numpy(lengths))
    got = ((pk & 7).to(torch.uint8), pk >> 3, count)
    want = jax_hpc.hpc_compress(
        jnp.asarray(codes), jnp.asarray(lengths), "pallas_interpret"
    )
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2][2]) == 0 and 0 < int(got[2][1]) < 1500
    with pytest.raises(ValueError, match="2\\^28"):
        port_hpc.hpc_compress_packed(
            torch.zeros((1, 1), dtype=torch.uint8).expand(1, 1 << 28),
            torch.zeros(1, dtype=torch.int32),
        )
