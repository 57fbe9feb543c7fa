"""K2's plain version (rust_seq2kminmers_torch/ops/cuda/slot_compact.py),
in its kept-count and K1-counts forms, and the port's ordered compaction
(ops/compact.py) against the reference package's slot_compact Pallas
kernel in interpret mode and its XLA compaction.  All values are
integers: equality is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_seq2kminmers_torch.ops import compact as port_compact
from rust_seq2kminmers_torch.ops.cuda import fused_scan as port_scan
from rust_seq2kminmers_torch.ops.cuda.slot_compact import (
    slot_compact,
    slot_compact_counts,
)
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


@pytest.mark.parametrize("wide", [False, True], ids=["u32", "hash_hi"])
@pytest.mark.parametrize(
    "case,m", [("past_m", 300), ("empty_tiles", 5000), ("kept_over_cap", 2000)]
)
def test_slot_compact_counts_matches_reference(case, m, wide):
    """The counts form (K1's [B, nt, 3] counts read in place, n_min and
    n_raw returned) against the reference's slot_compact in interpret mode
    plus its pipeline's clip of the count to m and sum of the raw counts
    (rust_seq2kminmers_tpu/ops/pipeline.py:317-318, 363): survivors past
    m, tiles with no survivors, and kept counts above the tile capacity."""
    B, nt, cap = 3, 8, 128
    rng = np.random.default_rng(len(case) + m + wide)
    cols = rng.integers(-(2**31), 2**31, (4 if wide else 3, B, nt, cap), dtype=np.int64)
    cols = cols.astype(np.int32)
    kept = rng.integers(0, cap + 1, (B, nt))
    if case == "empty_tiles":
        kept[:, ::2] = 0
        kept[1] = 0  # a read with no survivor at all
    if case == "kept_over_cap":
        kept[:, 1::3] = cap + rng.integers(1, 50, (B, len(range(1, nt, 3))))
    raw = kept + rng.integers(0, 4, (B, nt))
    counts = np.stack([kept, raw, rng.integers(0, 1 << 14, (B, nt))], axis=2)
    counts = torch.from_numpy(counts.astype(np.int32))
    t = [torch.from_numpy(c) for c in cols]
    hsh = (t[3], t[2]) if wide else t[2]
    outs = torch.full((2, B), -1, dtype=torch.int32)  # n_min, n_raw written here
    (pst, pen, phs), pn_min, pn_raw = slot_compact_counts(
        t[0], t[1], hsh, counts, m, n_min=outs[0], n_raw=outs[1]
    )
    assert pn_min.data_ptr() == outs[0].data_ptr()
    assert pn_raw.data_ptr() == outs[1].data_ptr()

    kept_c = np.minimum(counts.numpy()[:, :, 0], cap)
    sv = (np.arange(cap)[None, None, :] < kept_c[:, :, None]).reshape(B, -1)
    jcols = [jnp.asarray(c.reshape(B, -1)) for c in cols]
    jpacked, jn = jax_slot_compact(jnp.asarray(sv), jcols, m, interpret=True)
    j_min = np.asarray(jnp.minimum(jn, m))
    j_raw = np.asarray(jnp.asarray(counts.numpy())[:, :, 1].sum(axis=1))
    np.testing.assert_array_equal(pn_min.numpy(), j_min)
    np.testing.assert_array_equal(pn_raw.numpy(), j_raw)
    assert (j_min == m).any() if case == "past_m" else (j_min < m).all()
    port = [pst, pen, *(phs[::-1] if wide else (phs,))]  # the reference's column order
    for p, j in zip(port, jpacked):
        j = np.asarray(j)[:, :m]
        for b in range(B):
            np.testing.assert_array_equal(p[b, : j_min[b]].numpy(), j[b, : j_min[b]])
            assert (p[b, j_min[b] :] == 0).all()
    # The kept form gives the same columns and the unclipped count.
    (kst, ken, khs), kn = slot_compact(t[0], t[1], hsh, counts[:, :, 0].contiguous(), m)
    np.testing.assert_array_equal(kn.numpy(), np.asarray(jn))
    for a, b_ in zip([kst, ken, *(khs if wide else (khs,))],
                     [pst, pen, *(phs if wide else (phs,))]):
        assert torch.equal(a, b_)
