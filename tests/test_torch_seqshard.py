"""The port's sequence-sharded pipeline (rust_seq2kminmers_torch/parallel/
seqshard.py) on the CPU, in gloo worlds whose ranks run the kernels' plain
versions, against the reference package's make_seq_pipeline on its
virtual 8-device CPU mesh in interpret mode: the cases of
tests/test_seqshard.py and a few of tests/test_seqshard_sweep.py.  Every
field is an integer: equality is exact.

One world of 8 ranks runs every case (a (8 / S, S) mesh for S shards a
read); each reference result is computed once.  The ranks import this
module to find their function, so the reference package is imported only
inside the fixtures, in the pytest process."""

import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

from rust_seq2kminmers_torch.api import rescue_spec
from rust_seq2kminmers_torch.constants import XCODE_PAD, encode_xcodes, family_of_mode
from rust_seq2kminmers_torch.ops.pipeline import PipelineSpec
from rust_seq2kminmers_torch.parallel import seqshard
from rust_seq2kminmers_torch.parallel.launch import run_world
from rust_seq2kminmers_torch.parallel.mesh import batch_sharding, make_mesh

WORLD = 8


def _mixed_batch(rng, B, L, lo_frac=0.4):
    """Reads of ACGTN stretches and homopolymer runs of 2-60 (as in
    tests/test_seqshard.py)."""
    seqs = []
    for _ in range(B):
        n = int(rng.integers(int(L * lo_frac), L - 1))
        parts = []
        while sum(map(len, parts)) < n:
            if rng.random() < 0.3:
                parts.append(str(rng.choice(list("ACGT"))) * int(rng.integers(2, 60)))
            else:
                parts.append("".join(rng.choice(list("ACGTN"), size=int(rng.integers(20, 90)))))
        seqs.append("".join(parts)[:n])
    return seqs


def _sweep_batch(rng, B, L):
    """Reads with homopolymer runs of up to 700 that may span shards, over
    three alphabets (as in tests/test_seqshard_sweep.py)."""
    alpha = [list("ACGT"), list("ACGTN"), list("ACGTacgtNnQX")]
    seqs = []
    for b in range(B):
        n = int(rng.integers(L // 3, L - 1))
        parts, m = [], 0
        while m < n:
            if rng.random() < 0.3:
                p = str(rng.choice(list("ACGT"))) * int(rng.integers(2, 700))
            else:
                p = "".join(rng.choice(alpha[b % 3], size=int(rng.integers(30, 200))))
            parts.append(p)
            m += len(p)
        seqs.append("".join(parts)[:n])
    return seqs


def _acgt(rng, B, L, lo_frac):
    return ["".join(rng.choice(list("ACGT"), size=int(rng.integers(int(L * lo_frac), L - 1))))
            for _ in range(B)]


def _run_spanning_shards(rng, L):
    """A homopolymer run over the whole of the second of four shards: that
    shard keeps nothing, and the carry splices through it."""
    pre = "".join(rng.choice(list("ACGT"), size=900))
    mid = str(rng.choice(list("ACGT"))) * 1400
    post = "".join(rng.choice(list("ACGT"), size=1100))
    return [(pre + mid + post)[: L - 1]]


# name -> (spec keywords, S, L, reads)
CASES = {
    "hpc-run-spanning-shards": (dict(l=13, k=2, density=0.2, mode="hpc"), 4, 4096,
                                lambda r: _run_spanning_shards(r, 4096)
                                + _mixed_batch(r, 1, 4096)),
    "hpcsimd-l31-reads-within-a-shard": (dict(l=31, k=2, density=0.15, mode="hpcsimd"), 2,
                                         2048, lambda r: _mixed_batch(r, 4, 2048, 0.3)),
    "regular-u16": (dict(l=13, k=3, density=0.08, mode="regular", hash_width=16), 4, 4096,
                    lambda r: _mixed_batch(r, 2, 4096)),
    "hpc-u64": (dict(l=13, k=3, density=0.08, mode="hpc", hash_width=64), 4, 4096,
                lambda r: _mixed_batch(r, 2, 4096)),
    "hpcsimd-k1-no-halo": (dict(l=11, k=1, density=0.05, mode="hpcsimd"), 4, 4096,
                           lambda r: _mixed_batch(r, 2, 4096)),
    "regular-halo-across-8-shards": (dict(l=13, k=7, density=0.002, mode="regular"), 8, 8192,
                                     lambda r: _acgt(r, 1, 8192, 0.9)),
    "hpc-nthash2-S8": (dict(l=39, k=2, density=0.12, mode="hpc", variant="nthash2"), 8, 8192,
                       lambda r: _sweep_batch(r, 2, 8192)),
    "simd-nthash2-S2": (dict(l=61, k=4, density=0.08, mode="simd", variant="nthash2"), 2, 4096,
                        lambda r: _sweep_batch(r, 4, 4096)),
    # 64 minimizers a read over 4 shards: the shards' capacity of 16
    # overflows, is reported, and the rescue then loses nothing.
    "regular-nthash2-overflow": (dict(l=45, k=3, density=0.1, mode="regular",
                                      variant="nthash2", max_minimizers=64), 4, 8192,
                                 lambda r: _mixed_batch(r, 2, 8192)),
}
OVERFLOW = "regular-nthash2-overflow"
# The sweep's homopolymer runs of up to 700 in simd mode, whose windows all
# pass the bound together, overflow the reference's per-row slots and the
# port's shard capacity.  Survivor capacities differ by design, so the
# first run's segments are compared on their raw counts only.
DENSE = "simd-nthash2-S2"
MISALIGNED = "misaligned"  # 2048 bases over 4 shards of 512
# The carry-reach guard at a small size: with _CARRY_REACH at 1024, the run
# that fills shard 1 leaves shard 2 a carry from shard 0, more than 1024
# bases before it.
SPANNING, FAR, FAR_REACH = "hpc-run-spanning-shards", "far-carry", 1024


def _inputs(name):
    kw, S, L, reads = CASES[name]
    seqs = reads(np.random.default_rng(zlib.crc32(name.encode())))
    codes = np.full((len(seqs), L), XCODE_PAD, dtype=np.uint8)
    for b, s in enumerate(seqs):
        codes[b, : len(s)] = encode_xcodes(s, family_of_mode(kw["mode"]))
    return codes, np.array([len(s) for s in seqs], dtype=np.int32)


def _numpy(seg):
    return type(seg)(*(t.numpy() for t in seg))


def _seq_world(device, jobs):
    """Each job (name, spec, S, codes, lengths, carry reach or None) on a
    (WORLD / S, S) mesh -> {name: [segment, rescued segment if a read lost
    minimizers]}, or the message of the ValueError the step raised; and
    {(name, "plain"): seq_step's segment} for the first run.  A job with a
    carry reach runs with ``_CARRY_REACH`` set to it."""
    out = {}
    real_reach = seqshard._CARRY_REACH
    for name, spec, S, codes, lengths, reach in jobs:
        mesh = make_mesh(WORLD // S, S)
        rows, cols = batch_sharding(mesh, *codes.shape, seq_sharded=True)
        seqshard._CARRY_REACH = reach or real_reach
        try:
            seg = seqshard.make_seq_pipeline(spec, mesh, device)(codes[rows, cols], lengths[rows])
        except ValueError as e:
            out[name] = str(e)
            continue
        finally:
            seqshard._CARRY_REACH = real_reach
        out[name] = [_numpy(seg)]
        if reach is not None:  # a rank raised: the others must not gather again
            continue
        out[name, "plain"] = _numpy(seqshard.seq_step(
            torch.from_numpy(codes[rows, cols]), torch.from_numpy(lengths[rows]), spec,
            mesh.get_group("seq")))
        lost = (seg.n_minimizers_raw_seg > seg.n_minimizers_seg).any().to(torch.int32)
        worst = torch.stack([seg.n_minimizers_raw_seg.max(), lost])
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        if worst[1]:
            step = seqshard.make_seq_pipeline(rescue_spec(spec, int(worst[0]) * S), mesh, device)
            out[name].append(_numpy(step(codes[rows, cols], lengths[rows])))
    return out


@pytest.fixture(scope="module")
def runs():
    """(every rank's results, the reference's), the world running while
    the reference computes."""
    jobs = [(name, PipelineSpec(**CASES[name][0]), CASES[name][1], *_inputs(name), None)
            for name in CASES]
    jobs.append((MISALIGNED, PipelineSpec(l=7, k=2, density=0.1), 4,
                 np.zeros((2, 2048), dtype=np.uint8), np.array([100, 100], dtype=np.int32), None))
    jobs.append((FAR, PipelineSpec(**CASES[SPANNING][0]), CASES[SPANNING][1],
                 *_inputs(SPANNING), FAR_REACH))
    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(run_world, _seq_world, WORLD, "gloo", "cpu", jobs)
        ref = _reference()
        return world.result(), ref


@pytest.fixture(scope="module")
def port(runs):
    return runs[0]


@pytest.fixture(scope="module")
def reference(runs):
    return runs[1]


def _joined(port, name, i):
    S = CASES[name][1]
    return seqshard.join_segments([rank[name][i] for rank in port], S)


def _reference():
    """name -> [the reference's segments as numpy, rescued segments when a
    read lost minimizers]."""
    import jax.numpy as jnp

    from rust_seq2kminmers_tpu.api import rescue_spec as jax_rescue
    from rust_seq2kminmers_tpu.ops.pipeline import PipelineSpec as JaxSpec
    from rust_seq2kminmers_tpu.parallel.mesh import make_mesh as jax_mesh
    from rust_seq2kminmers_tpu.parallel.seqshard import make_seq_pipeline

    out = {}
    for name, (kw, S, _, _) in CASES.items():
        codes, lengths = _inputs(name)
        mesh = jax_mesh(WORLD // S, S)
        spec = JaxSpec(**kw, compaction="fused_interpret")
        with mesh:
            seg = make_seq_pipeline(spec, mesh)(jnp.asarray(codes), jnp.asarray(lengths))
        segs = [type(seg)(*map(np.asarray, seg))]
        raw = segs[0].n_minimizers_raw_seg
        if (raw > segs[0].n_minimizers_seg).any():
            spec = jax_rescue(spec, int(raw.max()) * S)
            with mesh:
                seg = make_seq_pipeline(spec, mesh)(jnp.asarray(codes), jnp.asarray(lengths))
            segs.append(type(seg)(*map(np.asarray, seg)))
        out[name] = segs
    return out


def _assert_same(got, want, what):
    assert got._fields == want._fields
    for field, g, w in zip(got._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, field, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {field}")


@pytest.mark.parametrize("name", list(CASES))
def test_segments_equal_reference(port, reference, name):
    """All 13 fields of every shard's segment, and the stitched batch."""
    from rust_seq2kminmers_tpu.parallel.seqshard import stitch_segments as jax_stitch

    want = reference[name]
    assert len(port[0][name]) == len(want), "one side lost minimizers, the other not"
    assert (name in (OVERFLOW, DENSE)) == (len(want) == 2)
    for i, w in enumerate(want):
        got = _joined(port, name, i)
        if name == DENSE and i == 0:
            np.testing.assert_array_equal(got.n_minimizers_raw_seg, w.n_minimizers_raw_seg)
            continue
        _assert_same(got, w, f"{name} run {i}")
        stitched = seqshard.stitch_segments(got)
        _assert_same(stitched, jax_stitch(w), f"{name} run {i} stitched")
    last = want[-1]
    assert (last.n_minimizers_raw_seg == last.n_minimizers_seg).all()
    assert last.n_kminmers_seg.sum() > 0


@pytest.mark.parametrize("name", list(CASES))
def test_plain_seq_step_equals_reference(port, reference, name):
    """seq_step, the step as a plain function of tensors, gives every
    shard the reference's segment (all 13 fields) on the first run."""
    got = seqshard.join_segments([rank[name, "plain"] for rank in port], CASES[name][1])
    want = reference[name][0]
    if name == DENSE:
        np.testing.assert_array_equal(got.n_minimizers_raw_seg, want.n_minimizers_raw_seg)
        return
    _assert_same(got, want, f"{name} seq_step")


def test_carry_reach_guard_raises(port):
    """A carried element that lies _CARRY_REACH or more bases before its
    shard raises on that shard's rank alone, after both all-gathers, with
    the guard's message; the other ranks finish their step."""
    S = CASES[SPANNING][1]
    for r, rank in enumerate(port):
        if r == 2:  # data block 0, shard 2
            assert rank[FAR] == "a carried element lies 2^28 or more bases before shard 2"
        else:
            assert isinstance(rank[FAR], list), (r, rank[FAR])
    assert S == 4 and WORLD // S == 2


def test_overflow_is_reported_then_rescued(port):
    first, rescued = (_joined(port, OVERFLOW, i) for i in (0, 1))
    assert (first.n_minimizers_raw_seg > first.n_minimizers_seg).any()
    assert (first.n_minimizers_seg <= 16).all() and first.hash_hi.shape[1] == 4 * 16
    assert (rescued.n_minimizers_raw_seg == rescued.n_minimizers_seg).all()
    np.testing.assert_array_equal(rescued.n_minimizers_raw_seg, first.n_minimizers_raw_seg)


def test_halo_spans_several_shards(port):
    """Fewer than k - 1 minimizers a shard: windows start mid-segment, and
    their halo reaches back over several shards."""
    seg = _joined(port, "regular-halo-across-8-shards", 0)
    assert (seg.km_off_seg > 0).sum() >= 2
    assert (seg.n_minimizers_seg < 6).sum() >= 2


def test_misaligned_length_raises(port):
    for rank in port:
        assert "multiple of 4096" in rank[MISALIGNED]


def test_splice_equals_a_walk_back():
    """_splice against walking back over the shards one element at a time,
    with shards that keep 0, fewer than w, or more than w elements."""
    rng = np.random.default_rng(5)
    S, B, c, w = 6, 7, 2, 5
    counts = rng.choice([0, 1, 3, 5, 9], size=(S, B))
    streams = [[rng.integers(-1000, 1000, size=(c, counts[j, b])) for b in range(B)]
               for j in range(S)]
    tails = np.zeros((S, B, c, w), dtype=np.int64)
    for j in range(S):
        for b in range(B):
            n = min(counts[j, b], w)
            tails[j, b, :, w - n :] = streams[j][b][:, counts[j, b] - n :]
    for s in range(S):
        got, real = seqshard._splice(torch.from_numpy(tails), torch.from_numpy(counts), s)
        for b in range(B):
            before = np.concatenate([streams[j][b] for j in range(s)] + [np.zeros((c, 0))], 1)
            n = min(before.shape[1], w)
            want = np.zeros((c, w), dtype=np.int64)
            want[:, w - n :] = before[:, before.shape[1] - n :]
            np.testing.assert_array_equal(got[b].numpy(), want)
            assert real[b].tolist() == [q >= w - n for q in range(w)]


def test_stitch_segments_equals_reference_loop():
    """The loop-free stitch against the reference's loop over reads and
    shards, on random segments with offsets into them."""
    from rust_seq2kminmers_tpu.parallel.seqshard import stitch_segments as jax_stitch

    rng = np.random.default_rng(9)
    B, S, cap = 5, 3, 11
    n_min = rng.integers(0, cap + 1, size=(B, S)).astype(np.int32)
    off = np.minimum(rng.integers(0, 3, size=(B, S)), n_min).astype(np.int32)
    cols = {}
    for name in seqshard.KminmerSegments._fields:
        if name in seqshard._SHARD_FIELDS:
            continue
        dtype = {"rev": bool}.get(name, np.uint32 if name in seqshard._HASH_FIELDS else np.int32)
        cols[name] = rng.integers(0, 2**31, size=(B, S * cap)).astype(dtype)
    seg = seqshard.KminmerSegments(
        **cols, n_kminmers_seg=n_min - off, km_off_seg=off, n_minimizers_seg=n_min,
        n_minimizers_raw_seg=n_min + 1,
    )
    _assert_same(seqshard.stitch_segments(seg), jax_stitch(seg), "stitch")
