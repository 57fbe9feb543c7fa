"""Carries state between the reference package and the port.

The system has no weights: its parameters are the spec and the encoded
batch.  These functions touch only plain attributes and numpy arrays, so
this module imports neither jax nor the reference package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .ops.pipeline import KminmerBatch, PipelineSpec


def spec_from_jax(jax_spec) -> PipelineSpec:
    """The port's PipelineSpec for a reference ``PipelineSpec``, read
    through its dataclass fields.  Its TPU capacities (``slots``,
    ``rows_out``) and ``compaction`` have no counterpart, except that
    ``rows_out == 0`` (the lossless rescue) maps to ``tile_cap = 0``."""
    f = {fld.name: getattr(jax_spec, fld.name) for fld in dataclasses.fields(jax_spec)}
    if f.get("hash_width", 32) != 32 or f.get("variant", "nthash1") != "nthash1":
        raise ValueError(
            "only hash_width=32 with variant='nthash1' is ported, got "
            f"hash_width={f.get('hash_width')} variant={f.get('variant')!r}"
        )
    return PipelineSpec(
        l=f["l"],
        k=f["k"],
        density=f["density"],
        mode=f["mode"],
        max_minimizers=f["max_minimizers"],
        tile_cap=0 if f.get("rows_out") == 0 else None,
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
