"""Carries state between the reference package and the port.

The system has no weights: its parameters are the spec and the encoded
batch.  These functions touch only plain attributes and numpy arrays, so
this module imports neither jax nor the reference package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.pipeline import KminmerBatch, PipelineSpec

# The reference's K1 carry: 8 rows of 128 lanes per read, the last l
# elements right-aligned at flat indices [1024 - l, 1024).
_JAX_PEND = (8, 128)


def spec_from_jax(jax_spec) -> PipelineSpec:
    """The port's PipelineSpec for a reference ``PipelineSpec``, read
    through its dataclass fields, hash width and variant included.  Its
    TPU capacities (``slots``, ``rows_out``) and ``compaction`` have no
    counterpart, except that ``rows_out == 0`` (the lossless rescue) maps
    to ``tile_cap = 0``."""
    f = {fld.name: getattr(jax_spec, fld.name) for fld in dataclasses.fields(jax_spec)}
    return PipelineSpec(
        l=f["l"],
        k=f["k"],
        density=f["density"],
        mode=f["mode"],
        max_minimizers=f["max_minimizers"],
        tile_cap=0 if f.get("rows_out") == 0 else None,
        hash_width=f["hash_width"],
        variant=f["variant"],
    )


def batch_to_numpy(batch: KminmerBatch) -> KminmerBatch:
    """A KminmerBatch of numpy arrays in the reference's dtypes: uint32
    hashes, bool rev, int32 positions and counts."""
    out = {}
    for name, t in batch._asdict().items():
        a = t.detach().cpu().numpy()
        if name in ("hash_hi", "hash_lo", "min_hash", "min_hash_hi"):
            a = a.view(np.uint32)
        out[name] = a
    return KminmerBatch(**out)


def carry_from_jax(base0, pend0, l: int):
    """The reference's K1 carry (``base0`` int32[B], ``pend0`` int32[B, 8,
    128]) -> the port's (base int32[B], carry int32[B, l]) CPU tensors.
    Both pack each element as (pos << 3) | code."""
    pend = np.asarray(pend0, dtype=np.int32)
    B = pend.shape[0]
    flat = pend.reshape(B, _JAX_PEND[0] * _JAX_PEND[1])
    return (
        torch.from_numpy(np.asarray(base0, dtype=np.int32).copy()),
        torch.from_numpy(np.ascontiguousarray(flat[:, flat.shape[1] - l :])),
    )


def carry_to_jax(base, carry):
    """The port's (base int32[B], carry int32[B, l]) -> the reference's
    (base0 int32[B], pend0 int32[B, 8, 128]), zero before the carry: the
    reference resumes a read from the port's carry with it."""
    c = carry.detach().cpu().numpy().astype(np.int32)
    B, l = c.shape
    n = _JAX_PEND[0] * _JAX_PEND[1]
    pend = np.zeros((B, n), dtype=np.int32)
    pend[:, n - l :] = c
    return base.detach().cpu().numpy().astype(np.int32), pend.reshape(B, *_JAX_PEND)
