"""The port's distributed file runner (rust_seq2kminmers_torch/parallel/
multihost.py) on the CPU: 2 gloo ranks running the kernels' plain
versions, against the reference package's run_file_distributed on its
virtual 8-device CPU mesh (one process, the same 8 rows a batch): the
ordered stream, chunk by chunk, and the manifest.  Also the overflow
rescue, a world of one, and the command line in two processes that
cannot import jax.

The ranks import this module to find their function, so the reference
package is imported only inside the fixtures and tests, in the pytest
process."""

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch.distributed as dist

from rust_seq2kminmers_torch.ops.pipeline import PipelineSpec
from rust_seq2kminmers_torch.parallel import multihost
from rust_seq2kminmers_torch.parallel.launch import run_world

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "data" / "ecoli.genome.100k.fa"
COLUMNS = ["hash", "start", "end", "offset", "rev", "read"]
# name -> (file, spec keywords): the CLI's defaults on the fixture, and the
# reference's two-process configurations (tests/test_multihost.py)
CONFIGS = {
    "ecoli-regular": ("ecoli", dict(l=31, k=5, density=0.01, mode="regular")),
    "hpcsimd_u32": ("mixed", dict(l=9, k=3, density=0.05, mode="hpcsimd")),
    "hpc_u64": ("mixed", dict(l=9, k=3, density=0.05, mode="hpc", hash_width=64)),
    "regular_nthash2_l45": ("mixed", dict(l=45, k=2, density=0.05, mode="regular",
                                          variant="nthash2")),
}
ROWS_PER_RANK = 4  # 2 ranks x 4 rows = the reference's 8 devices x 1 row


def _write(path, seqs):
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """name -> (path, sequences or None)."""
    d = tmp_path_factory.mktemp("mh")
    rng = np.random.default_rng(42)
    mixed = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(40, 900))))
             for _ in range(37)]  # not a multiple of the batch
    rng = np.random.default_rng(11)
    dense = ["".join(rng.choice(list("ACGT"), size=600)) for _ in range(16)]
    return {"ecoli": (FIXTURE, None), "mixed": (_write(d / "reads.fa", mixed), mixed),
            "dense": (_write(d / "dense.fa", dense), dense)}


def _file_world(device, jobs):
    """Each job (name, path, spec, out_dir) through run_file_distributed ->
    {name: (this rank's chunks, the raw counts each rescue was asked for,
    (the specs make_dp_pipeline was asked for, the ids of the steps it
    returned, the steps constructed)}."""
    from rust_seq2kminmers_torch import api
    from rust_seq2kminmers_torch.parallel import driver

    real, out = api.rescue_spec, {}
    real_make, real_cls = driver.make_dp_pipeline, driver.DataParallelPipeline
    for name, path, spec, out_dir in jobs:
        asked, made, built = [], [], []

        def counted(s, needed=0, asked=asked):
            asked.append(needed)
            return real(s, needed)

        def make(spec, mesh, device="cuda", made=made):
            step = real_make(spec, mesh, device)
            made.append((spec, id(step)))
            return step

        class Built(real_cls):
            def __init__(self, *args, built=built):
                built.append(args[0])
                super().__init__(*args)

        api.rescue_spec = counted
        driver.make_dp_pipeline, driver.DataParallelPipeline = make, Built
        driver._dp_pipeline.cache_clear()
        try:
            chunks = multihost.run_file_distributed(path, spec, rows_per_rank=ROWS_PER_RANK,
                                                    out_dir=out_dir, device=device)
        finally:
            api.rescue_spec = real
            driver.make_dp_pipeline, driver.DataParallelPipeline = real_make, real_cls
        out[name] = (chunks, asked, ([s for s, _ in made], [i for _, i in made], built))
    return out


def _reference(files, out_root):
    from rust_seq2kminmers_tpu.ops.pipeline import PipelineSpec as JaxSpec
    from rust_seq2kminmers_tpu.parallel.multihost import global_data_mesh, run_file_distributed

    return {name: run_file_distributed(files[f][0], JaxSpec(**kw), mesh=global_data_mesh(),
                                       rows_per_device=1, out_dir=str(out_root / name))
            for name, (f, kw) in CONFIGS.items()}


# The reference's dense case (tests/test_multihost.py): density 0.4 with
# room for 8 minimizers a read and 8 survivors a tile, rescued.
DENSE = dict(l=9, k=3, density=0.4, mode="regular", max_minimizers=8, tile_cap=8)


@pytest.fixture(scope="module")
def runs(files, tmp_path_factory):
    """(every rank's results, the reference's chunks, the two out_dir roots)."""
    port_dir, jax_dir = tmp_path_factory.mktemp("port"), tmp_path_factory.mktemp("jax")
    jobs = [(name, files[f][0], PipelineSpec(**kw), str(port_dir / name))
            for name, (f, kw) in CONFIGS.items()]
    jobs.append(("dense", files["dense"][0], PipelineSpec(**DENSE), None))
    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(run_world, _file_world, 2, "gloo", "cpu", jobs)
        ref = _reference(files, jax_dir)
        return world.result(), ref, port_dir, jax_dir


def _stream(chunks):
    """The concatenated records of chunks in (batch, rank) order, checking
    that each chunk starts where the stream so far ends."""
    pos, cols = 0, {c: [] for c in COLUMNS}
    for chunk in chunks:
        assert chunk.stream_start == pos
        pos += len(chunk.records["hash"])
        for c in COLUMNS:
            cols[c].append(chunk.records[c])
    return {c: np.concatenate(v) for c, v in cols.items()}


def _rank_order(port, name):
    pieces = [(c.batch_index, r, c) for r, rank in enumerate(port) for c in rank[name][0]]
    return [c for _, _, c in sorted(pieces, key=lambda x: x[:2])]


def _same(got, want):
    for c in COLUMNS:
        assert got[c].dtype == want[c].dtype, c
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stream_equals_reference(runs, name):
    """The ranks' chunks, in (batch, rank) order, are the reference's
    stream; each batch's total is the same on both ranks."""
    port, ref, _, _ = runs
    chunks = _rank_order(port, name)
    got, want = _stream(chunks), _stream(ref[name])
    _same(got, want)
    assert len(got["hash"]) == sum(c.batch_total for c in ref[name]) > 0
    for rank in port:
        assert [c.batch_total for c in rank[name][0]] == [c.batch_total for c in ref[name]]
        assert rank[name][1] == []  # no rescue
    assert [c.first_record for c in chunks] == [
        g * 8 + r * ROWS_PER_RANK for g in range(len(ref[name])) for r in range(2)]


def _parts(out_dir):
    return sorted(Path(out_dir).glob("part-*.npz"))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_parts_and_manifest_equal_reference(runs, name):
    port, _, port_dir, jax_dir = runs
    mine = json.loads((port_dir / name / "manifest.json").read_text())
    theirs = json.loads((jax_dir / name / "manifest.json").read_text())
    assert mine.pop("num_processes") == 2 and theirs.pop("num_processes") == 1
    assert mine == theirs
    parts = _parts(port_dir / name)
    assert len(parts) == 2 * len(_parts(jax_dir / name))
    loaded = [np.load(p) for p in parts]
    assert [int(z["stream_start"]) for z in loaded] == [
        c.stream_start for c in _rank_order(port, name)]
    _same({c: np.concatenate([z[c] for z in loaded]) for c in COLUMNS},
          {c: np.concatenate([np.load(p)[c] for p in _parts(jax_dir / name)]) for c in COLUMNS})


def test_overflow_is_rescued_collectively(runs, files):
    """Both ranks rescue each of the 2 batches together (one retry a batch,
    sized by each rank's own raw count), and the stream is the oracle's,
    read by read."""
    from rust_seq2kminmers_tpu.oracle import HashMode, kminmers

    port = runs[0]
    for rank in port:
        asked = rank["dense"][1]
        assert len(asked) == len(rank["dense"][0]) == 2 and min(asked) > 8
    got = _stream(_rank_order(port, "dense"))
    pos = 0
    for i, s in enumerate(files["dense"][1]):
        for rec in kminmers(s, 9, 3, 0.4, HashMode.Regular):
            assert (got["read"][pos], got["hash"][pos], got["start"][pos], got["end"][pos],
                    got["offset"][pos], got["rev"][pos]) == (
                i, rec.hash, rec.start, rec.end, rec.offset, rec.rev)
            pos += 1
    assert pos == len(got["hash"])


@pytest.mark.parametrize("name", ["hpcsimd_u32", "dense"])
def test_dp_step_is_cached_across_batches_and_retries(runs, name):
    """run_file_distributed asks make_dp_pipeline for a step on every batch
    and every retry; each (spec, group) is constructed once and the same
    object comes back every time."""
    port = runs[0]
    for rank in port:
        specs, ids, built = rank[name][2]
        assert len(specs) > len(set(specs)) and len(built) == len(set(specs))
        assert sorted(built, key=repr) == sorted(set(specs), key=repr)
        first = {}
        for spec, i in zip(specs, ids):
            assert first.setdefault(spec, i) == i
    if name == "dense":  # two batches, each rescued once
        assert len(port[0][name][2][0]) == 4


def test_one_process_is_a_world_of_one(runs, files):
    """Without init_distributed's group, the runner makes a world of one
    and gives the same stream."""
    port = runs[0]
    assert multihost.init_distributed(None, 1) is False
    assert not dist.is_initialized()
    try:
        chunks = multihost.run_file_distributed(
            files["mixed"][0], PipelineSpec(**CONFIGS["hpcsimd_u32"][1]), rows_per_rank=8,
            device="cpu")
        assert dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    _same(_stream(chunks), _stream(_rank_order(port, "hpcsimd_u32")))


RUNNER = """
import runpy, sys
sys.modules["jax"] = None
sys.argv = ["multihost"] + sys.argv[1:]
try:
    runpy.run_module("rust_seq2kminmers_torch.parallel.multihost", run_name="__main__")
except SystemExit as e:
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "rust_seq2kminmers_tpu")]
    assert bad == ["jax"] and sys.modules["jax"] is None, bad
    raise
"""


def test_command_line_in_two_processes_without_jax(runs, files, tmp_path):
    """python -m ...parallel.multihost, two ranks meeting through a file,
    with jax unimportable: the parts equal the in-process run's."""
    port_dir = runs[2]
    kw = CONFIGS["hpcsimd_u32"][1]
    args = [str(files["mixed"][0]), "--coordinator", (tmp_path / "store").as_uri(),
            "--num-processes", "2", "--backend", "gloo", "--device", "cpu",
            "--rows-per-rank", str(ROWS_PER_RANK), "--out-dir", str(tmp_path / "out"),
            "--mode", kw["mode"], "--l", str(kw["l"]), "--k", str(kw["k"]),
            "--density", str(kw["density"])]
    procs = [subprocess.Popen([sys.executable, "-c", RUNNER, *args, "--process-id", str(r)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, o[-3000:]
        assert f"[rank {r}] done in " in o and "[rank 0] batch 0: reads [0, 4)" in outs[0], o
    assert (json.loads((tmp_path / "out" / "manifest.json").read_text())
            == json.loads((port_dir / "hpcsimd_u32" / "manifest.json").read_text()))
    got, want = _parts(tmp_path / "out"), _parts(port_dir / "hpcsimd_u32")
    assert [p.name for p in got] == [p.name for p in want]
    for a, b in zip(got, want):
        za, zb = np.load(a), np.load(b)
        assert sorted(za.files) == sorted(zb.files)
        for f in za.files:
            np.testing.assert_array_equal(za[f], zb[f], err_msg=f)
