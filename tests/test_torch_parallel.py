"""The port's data-parallel step and ordered merge (rust_seq2kminmers_torch/
parallel/driver.py) and its mesh (parallel/mesh.py) on the CPU, in a gloo
world of 4 ranks running the kernels' plain versions, against the
reference package's make_dp_pipeline and merge_ordered on its virtual CPU
mesh.  Every field is an integer: equality is exact.

The ranks import this module to find their function, so the reference
package is imported only inside the fixtures, in the pytest process."""

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from rust_seq2kminmers_torch.constants import XCODE_PAD, with_keep_bits
from rust_seq2kminmers_torch.ops.pipeline import KminmerBatch, PipelineSpec
from rust_seq2kminmers_torch.parallel import driver
from rust_seq2kminmers_torch.parallel.launch import run_world
from rust_seq2kminmers_torch.parallel.mesh import batch_sharding, make_mesh, row_sharding

WORLD = 4
MODES = ["regular", "simd", "hpc", "hpcsimd"]
SPEC = dict(l=10, k=3, density=0.05, max_minimizers=128)


def _batch():
    """16 reads of 200-1023 random bases padded to 1024 (as in
    tests/test_parallel.py)."""
    rng = np.random.default_rng(0x5E12)
    B, L = 16, 1024
    codes = with_keep_bits(rng.integers(0, 4, size=(B, L)))
    lengths = rng.integers(200, L, size=B).astype(np.int32)
    for b in range(B):
        codes[b, lengths[b] :] = XCODE_PAD
    return codes, lengths


def _piece(res):
    """A rank's ShardedKminmers as numpy."""
    return driver.ShardedKminmers(
        batch=KminmerBatch(*(t.numpy() for t in res.batch)),
        global_offset=res.global_offset.numpy(), total=res.total.numpy(),
        lost=res.lost.numpy(),
    )


def _errors(*calls):
    out = []
    for fn, args in calls:
        try:
            fn(*args)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def _dp_world(device, codes, lengths):
    """mode -> (this rank's piece, merge_ordered gathered to rank 0); and
    the messages of the mesh's refusals."""
    import torch

    mesh = make_mesh()
    rows = row_sharding(mesh, len(codes))
    group = mesh.get_group("data")
    out = {}
    for mode in MODES:
        spec = PipelineSpec(mode=mode, **SPEC)
        res = driver.make_dp_pipeline(spec, mesh, device)(codes[rows], lengths[rows])
        plain = driver.dp_step(torch.from_numpy(codes[rows]), torch.from_numpy(lengths[rows]),
                               spec, group)
        out[mode] = (_piece(res), driver.merge_ordered(res, mesh), _piece(plain))
    out["errors"] = _errors((make_mesh, (8,)), (make_mesh, (2, 4)),
                            (row_sharding, (mesh, 6)), (batch_sharding, (mesh, 4, 1000, False)))
    grid = make_mesh(2, 2)
    out["grid"] = (tuple(grid.shape), grid.get_coordinate(),
                   batch_sharding(grid, 4, 2048, True), row_sharding(grid, 4))
    return out


def _reference(codes, lengths):
    import jax.numpy as jnp

    from rust_seq2kminmers_tpu.ops.pipeline import PipelineSpec as JaxSpec
    from rust_seq2kminmers_tpu.parallel.driver import make_dp_pipeline, merge_ordered
    from rust_seq2kminmers_tpu.parallel.mesh import make_mesh as jax_mesh

    mesh = jax_mesh(n_data=WORLD)
    out = {}
    for mode in MODES:
        res = make_dp_pipeline(JaxSpec(mode=mode, **SPEC), mesh)(jnp.asarray(codes),
                                                                 jnp.asarray(lengths))
        out[mode] = (jnp_tree(res), merge_ordered(res))
    return out


def jnp_tree(res):
    return type(res)(batch=type(res.batch)(*map(np.asarray, res.batch)),
                     global_offset=np.asarray(res.global_offset),
                     total=np.asarray(res.total), lost=np.asarray(res.lost))


@pytest.fixture(scope="module")
def runs():
    """(every rank's results, the reference's), the world running while
    the reference computes."""
    codes, lengths = _batch()
    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(run_world, _dp_world, WORLD, "gloo", "cpu", codes, lengths)
        ref = _reference(codes, lengths)
        return world.result(), ref


def _same_dict(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _same_pieces(pieces, want):
    """The ranks' pieces, in rank order, are the reference's sharded batch
    (all 12 fields), with its offsets, total and loss flag."""
    for field, w in zip(want.batch._fields, want.batch):
        got = np.concatenate([getattr(p.batch, field) for p in pieces])
        if w.dtype == np.uint32:
            got = got.view(np.uint32)
        assert got.dtype == w.dtype, field
        np.testing.assert_array_equal(got, w, err_msg=field)
    np.testing.assert_array_equal(np.concatenate([p.global_offset for p in pieces]),
                                  want.global_offset)
    for p in pieces:
        assert int(p.total) == int(want.total) > 0 and int(p.lost) == int(want.lost) == 0


@pytest.mark.parametrize("mode", MODES)
def test_dp_step_equals_reference(runs, mode):
    """Every rank's rows, in rank order, are the reference's sharded batch
    (all 12 fields), with its offsets, total and loss flag."""
    port, ref = runs
    _same_pieces([rank[mode][0] for rank in port], ref[mode][0])


@pytest.mark.parametrize("mode", MODES)
def test_plain_dp_step_equals_reference(runs, mode):
    """dp_step, the step as a plain function of tensors, gives every rank
    the reference's rows, offsets, total and loss flag, as the step that
    make_dp_pipeline returns does."""
    port, ref = runs
    _same_pieces([rank[mode][2] for rank in port], ref[mode][0])


@pytest.mark.parametrize("mode", MODES)
def test_merge_ordered_equals_reference(runs, mode):
    """The merge of the pieces, on the host or gathered to rank 0 over
    'data', is the reference's dict key for key."""
    port, ref = runs
    want = ref[mode][1]
    _same_dict(driver.merge_ordered([rank[mode][0] for rank in port]), want)
    _same_dict(port[0][mode][1], want)
    assert all(rank[mode][1] is None for rank in port[1:])


def test_mesh_layout_and_refusals(runs):
    port, _ = runs
    errors = port[0]["errors"]
    assert "needs 8 ranks, have 4" in errors[0] and "needs 8 ranks" in errors[1]
    assert "batch size 6 is not a multiple of 4" in errors[2]
    assert errors[3] is None
    for r, rank in enumerate(port):  # rank r sits at (r // 2, r % 2)
        d, s = r // 2, r % 2
        assert rank["grid"] == ((2, 2), (d, s), (slice(2 * d, 2 * d + 2),
                                                  slice(1024 * s, 1024 * s + 1024)),
                                slice(2 * d, 2 * d + 2))


def _rank_of(device):
    import torch.distributed as dist

    return dist.get_rank()


def _children():
    """The pids of this process's live child processes."""
    me, out = os.getpid(), set()
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except OSError:  # the process ended meanwhile
            continue
        if int(fields[1]) == me and fields[0] != "Z":
            out.add(int(stat.parent.name))
    return out


def test_run_world_leaves_no_process():
    """run_world joins its ranks and stops the resource tracker that the
    spawn started: no process it made outlives the call."""
    from multiprocessing import resource_tracker

    before = _children()
    tracker_was_running = resource_tracker._resource_tracker._fd is not None
    assert run_world(_rank_of, 2, "gloo", "cpu") == [0, 1]
    assert _children() <= before
    if not tracker_was_running:
        assert resource_tracker._resource_tracker._fd is None


def test_merge_ordered_large_batch():
    """The stitch is O(total): 10,000 reads in 4 pieces, against the
    reference's merge of the whole batch (tests/test_parallel.py)."""
    from rust_seq2kminmers_tpu.ops.pipeline import KminmerBatch as JaxBatch
    from rust_seq2kminmers_tpu.parallel.driver import ShardedKminmers as JaxSharded
    from rust_seq2kminmers_tpu.parallel.driver import merge_ordered as jax_merge

    rng = np.random.default_rng(0x5E12)
    B, Mk = 10_000, 7
    counts = rng.integers(0, Mk + 1, size=B).astype(np.int32)
    bases = (np.cumsum(counts) - counts).astype(np.int32)
    total = np.int32(counts.sum())
    hi, lo = (rng.integers(0, 2**32, size=(B, Mk)).astype(np.uint32) for _ in range(2))
    start = rng.integers(0, 1000, size=(B, Mk)).astype(np.int32)
    rev = rng.random((B, Mk)) < 0.5
    cols = dict(hash_hi=hi, hash_lo=lo, start=start, end=start + 30, rev=rev,
                n_kminmers=counts, min_hash=lo, min_hash_hi=hi, min_start=start,
                min_end=start + 30, n_minimizers=counts, n_minimizers_raw=counts)
    want = jax_merge(JaxSharded(batch=JaxBatch(**cols), global_offset=bases, total=total,
                                lost=np.int32(0)))
    pieces = [
        driver.ShardedKminmers(
            batch=KminmerBatch(**{k: v[rows] for k, v in cols.items()}),
            global_offset=bases[rows], total=total, lost=np.int32(0))
        for rows in (slice(i * B // 4, (i + 1) * B // 4) for i in range(4))
    ]
    got = driver.merge_ordered(pieces)
    _same_dict(got, want)
    assert len(got["hash"]) == total and (got["read"][np.cumsum(counts)[counts > 0] - 1]
                                          == np.nonzero(counts)[0]).all()
