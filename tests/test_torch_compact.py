"""K2's plain version (rust_seq2kminmers_torch/ops/cuda/slot_compact.py)
and the port's ordered compaction (ops/compact.py) against the reference
package's slot_compact Pallas kernel in interpret mode and its XLA
compaction.  All values are integers: equality is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_seq2kminmers_torch.ops import compact as port_compact
from rust_seq2kminmers_torch.ops.cuda import fused_scan as port_scan
from rust_seq2kminmers_torch.ops.cuda.slot_compact import slot_compact
from rust_seq2kminmers_tpu.constants import XCODE_PAD, encode_xcodes
from rust_seq2kminmers_tpu.ops.compact import compact as jax_compact
from rust_seq2kminmers_tpu.ops.pallas.slot_compact import (
    slot_compact as jax_slot_compact,
)
from rust_seq2kminmers_tpu.ops.pipeline import PipelineSpec


def _tile_rows(seed, mode, B=3, L=4096, density=0.05, cap=None):
    """Per-tile survivor rows from the port's plain K1."""
    rng = np.random.default_rng(seed)
    codes = np.full((B, L), XCODE_PAD, dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    for b in range(B):
        n = int(rng.integers(L // 2, L - 1))
        codes[b, :n] = encode_xcodes(
            "".join(rng.choice(list("AACCGGTTAN"), size=n)), "scalar"
        )
        lengths[b] = n
    spec = PipelineSpec(l=11, k=3, density=density, mode=mode)
    limit = np.where(lengths > 11, 1 << 30 if spec.is_hpc else lengths - 11, -1)
    return port_scan.fused_minimizer_scan(
        torch.from_numpy(codes),
        torch.from_numpy(lengths),
        torch.from_numpy(limit.astype(np.int32)),
        spec.l,
        spec.bound,
        spec.strict_threshold,
        spec.is_hpc,
        spec.mode == "hpc",
        tile=1024,
        cap=cap,
    )


@pytest.mark.parametrize("mode", ["regular", "hpc", "hpcsimd"])
@pytest.mark.parametrize("m", [40, 300])
def test_slot_compact_matches_reference(mode, m):
    st, en, hs, counts = _tile_rows(seed=m, mode=mode, cap=256)
    kept = counts[:, :, 0].contiguous()
    (pst, pen, phs), pn = slot_compact(st, en, hs, kept, m)
    B, nt, cap = st.shape

    # The reference's slot mask, as its pipeline builds it.
    kept_np = kept.numpy()
    sv = (np.arange(cap)[None, None, :] < kept_np[:, :, None]).reshape(B, -1)
    cols = [jnp.asarray(c.numpy().reshape(B, -1)) for c in (st, en, hs)]
    jpacked, jn = jax_slot_compact(jnp.asarray(sv), cols, m, interpret=True)
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    n_min = np.minimum(pn.numpy(), m)
    for p, j in zip((pst, pen, phs), jpacked):
        j = np.asarray(j)[:, :m]
        for b in range(B):
            np.testing.assert_array_equal(p[b, : n_min[b]].numpy(), j[b, : n_min[b]])
            assert (p[b, n_min[b] :] == 0).all()

    # And the reference's XLA compaction, fills included.
    xla, xn = jax_compact(jnp.asarray(sv), cols, m, [0, 0, 0], method="bsearch")
    np.testing.assert_array_equal(pn.numpy(), np.asarray(xn))
    for p, x in zip((pst, pen, phs), xla):
        np.testing.assert_array_equal(p.numpy(), np.asarray(x))


@pytest.mark.parametrize("m", [1, 37, 1000])
def test_compact_matches_reference(m):
    """ops/compact.compact against the reference's ordered compaction, on
    random masks with and without overflow."""
    rng = np.random.default_rng(m)
    mask = rng.random((4, 777)) < 0.3
    vals = rng.integers(-(2**31), 2**31, size=(2, 4, 777), dtype=np.int64)
    vals = vals.astype(np.int32)
    pouts, pn = port_compact.compact(
        torch.from_numpy(mask), [torch.from_numpy(v) for v in vals], m, [0, -7]
    )
    jouts, jn = jax_compact(
        jnp.asarray(mask), [jnp.asarray(v) for v in vals], m, [0, -7],
        method="scatter",
    )
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    for p, j in zip(pouts, jouts):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
