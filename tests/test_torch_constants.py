"""The port's numpy copies of the reference's constants, encoders, bounds
and PipelineSpec rules, held equal to the reference package; and the
port's independence from jax."""

import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the reference package's own import, made explicit)
import numpy as np
import pytest

from rust_seq2kminmers_torch import constants as pc
from rust_seq2kminmers_torch.convert import spec_from_jax
from rust_seq2kminmers_torch.ops.pipeline import PipelineSpec
from rust_seq2kminmers_tpu import constants as jc
from rust_seq2kminmers_tpu.ops.pipeline import PipelineSpec as JaxSpec

REPO = Path(__file__).resolve().parent.parent
MODES = ["regular", "simd", "hpc", "hpcsimd"]
DENSITIES = [0.0, 1e-6, 0.0001, 0.001, 0.01, 0.0333, 0.05, 0.1, 0.5, 0.999, 1.0]


@pytest.mark.parametrize(
    "name",
    [
        "SEED_TABLE_F", "SEED_TABLE_R", "BYTE_TO_CODE_SCALAR",
        "BYTE_TO_CODE_SIMD", "CODE_A", "CODE_C", "CODE_G", "CODE_T",
        "CODE_N", "CODE_OTHER", "CODE_PAD", "NUM_CODES", "XCODE_KEEP",
        "XCODE_PAD", "U32_MAX", "MASK32", "U64_MAX", "BYTE_TO_CODE", "CODE_TO_BYTE",
    ],
)
def test_constant_equals_reference(name):
    mine, ref = getattr(pc, name), getattr(jc, name)
    np.testing.assert_array_equal(mine, ref)
    assert np.asarray(mine).dtype == np.asarray(ref).dtype


@pytest.mark.parametrize("family", ["scalar", "simd"])
def test_encoders_equal_reference(family):
    rng = np.random.default_rng(len(family))
    np.testing.assert_array_equal(pc.code_table(family), jc.code_table(family))
    for mode in MODES:
        assert pc.family_of_mode(mode) == jc.family_of_mode(mode)
    alphabet = np.frombuffer(b"ACGTNacgtnQRY*-\x00\xff", dtype=np.uint8)
    for n in (0, 1, 2, 100, 4000):
        raw = rng.choice(alphabet, size=n)
        raw[: n // 3] = rng.integers(0, 256, size=n // 3)  # any byte at all
        for seq in (raw, raw.tobytes(), raw.tobytes().decode("latin-1")):
            np.testing.assert_array_equal(
                pc.encode_xcodes(seq, family), jc.encode_xcodes(seq, family)
            )
        for seq in (raw, raw.tobytes(), raw.tobytes().decode("latin-1")):
            np.testing.assert_array_equal(pc.encode_bases(seq), jc.encode_bases(seq))
    codes = rng.integers(0, 7, size=(3, 500))
    codes[:, 100:200] = 2  # runs
    np.testing.assert_array_equal(pc.with_keep_bits(codes), jc.with_keep_bits(codes))
    np.testing.assert_array_equal(
        pc.with_keep_bits(codes[0]), jc.with_keep_bits(codes[0])
    )


@pytest.mark.parametrize("hash_width", [16, 32, 64])
def test_seed_tables_equal_reference(hash_width):
    for mine, ref in zip(pc.seed_tables(hash_width), jc.seed_tables(hash_width)):
        np.testing.assert_array_equal(mine, ref)
        assert mine.dtype == ref.dtype
    for mine, ref in zip(pc.seed_tables_nthash2_31(), jc.seed_tables_nthash2_31()):
        np.testing.assert_array_equal(mine, ref)
        assert mine.dtype == ref.dtype
    with pytest.raises(ValueError):
        pc.seed_tables(8)


def test_bounds_equal_reference():
    rng = np.random.default_rng(1)
    for d in DENSITIES + list(rng.random(200)):
        assert pc.hash_bound_u32(d) == jc.hash_bound_u32(d)
        assert pc.hash_bound_simd_u32(d) == jc.hash_bound_simd_u32(d)
        assert pc.hash_bound_nthash2_31(d) == jc.hash_bound_nthash2_31(d)
        for w in (16, 32, 64):
            assert pc.hash_bound(d, w) == jc.hash_bound(d, w)


# (hash_width, variant) pairs, with the modes each is valid for.
WIDTHS = [(32, "nthash1"), (16, "nthash1"), (64, "nthash1"), (32, "nthash2")]
SPEC_CASES = [
    pytest.param(mode, w, v, id=mode if (w, v) == WIDTHS[0] else f"{mode}-{w}-{v}")
    for mode in MODES for w, v in WIDTHS
    if w == 32 or mode in ("regular", "hpc")
]


@pytest.mark.parametrize("mode,hash_width,variant", SPEC_CASES)
def test_spec_rules_equal_reference(mode, hash_width, variant):
    for d in DENSITIES:
        for l in (1, 2, 5, 10, 31, 100, 255, 256, 301):
            for mm in (None, 3, 1000):
                kw = dict(
                    l=l, k=5, density=d, mode=mode, max_minimizers=mm,
                    hash_width=hash_width, variant=variant,
                )
                mine, ref = PipelineSpec(**kw), JaxSpec(**kw)
                assert spec_from_jax(ref) == mine
                assert mine.bound == ref.bound
                assert mine.strict_threshold == ref.strict_threshold
                assert mine.is_hpc == ref.is_hpc
                assert mine.fused == (2 <= l <= 255)
                for L in (l + 1, 1000, 1 << 20):
                    assert mine.capacity_for(L) == ref.capacity_for(L)


def test_spec_from_jax_rejects_unported_widths():
    """Every width and variant is ported: spec_from_jax maps them, and the
    port's spec rejects exactly the combinations the reference rejects."""
    assert spec_from_jax(JaxSpec(l=11, k=3, density=0.01, hash_width=64)) == (
        PipelineSpec(l=11, k=3, density=0.01, hash_width=64)
    )
    assert spec_from_jax(
        JaxSpec(l=45, k=3, density=0.01, variant="nthash2")
    ).variant == "nthash2"
    assert spec_from_jax(
        JaxSpec(l=11, k=3, density=0.01, slots=128, rows_out=0)
    ).tile_cap == 0
    for bad in (
        dict(hash_width=8), dict(hash_width=64, mode="simd"),
        dict(hash_width=16, mode="hpcsimd"), dict(variant="nthash3"),
        dict(variant="nthash2", hash_width=64),
    ):
        with pytest.raises(ValueError):
            JaxSpec(l=11, k=3, density=0.01, **bad)
        with pytest.raises(ValueError):
            PipelineSpec(l=11, k=3, density=0.01, **bad)


def test_port_imports_without_jax():
    """With jax made unimportable, the port imports and runs its CPU
    pipeline, long-read path, file reader, streaming runner and command
    line, imports its profiling script and its multi-process layer, and
    never loads the reference package."""
    code = """
import sys
sys.modules["jax"] = None
import numpy as np, torch
import rust_seq2kminmers_torch as p
from rust_seq2kminmers_torch import convert
from rust_seq2kminmers_torch.ops.cuda import build, fused_scan, slot_compact, assemble_kernel, masked_compact, inrow_compact
from rust_seq2kminmers_torch.ops import long_read
from rust_seq2kminmers_torch.scripts import prof_long_read, prof_mxu_compact, prof_parallel
from rust_seq2kminmers_torch import hpc_strings, kminmer, __main__ as cli
from rust_seq2kminmers_torch.io import fasta, stream
from rust_seq2kminmers_torch.parallel import driver, launch, mesh, multihost, seqshard
codes = p.constants.with_keep_bits(np.random.default_rng(0).integers(0, 4, (2, 4096)))
for spec in (p.PipelineSpec(l=31, k=5, density=0.05, mode="hpcsimd"),
             p.PipelineSpec(l=301, k=5, density=0.05, mode="hpc", hash_width=64)):
    out = p.kminmer_pipeline(torch.from_numpy(codes), torch.tensor([4096, 3000], dtype=torch.int32), spec)
    assert int(out.n_kminmers.sum()) > 0
assert len(p.kminmers_list("ACGT" * 100, 10, 3, 0.2, "hpc", device="cpu")) > 0
assert len(p.kminmers_long("ACGTTGCA" * 500, 10, 3, 0.2, "hpc", chunk=1024, device="cpu")["hash"]) > 0
assert len(prof_mxu_compact.tile_inputs()[4][0]) == 4
assert prof_long_read.random_read(64).shape == (64,)
assert hpc_strings.hpc("AACCGT") == "ACGT" and len(kminmer.kminmers_vec("ACGT" * 100, 10, 3, 0.2, device="cpu")) > 0
import contextlib, io
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    assert cli.main(["tests/data/ecoli.genome.100k.fa", "2", "--device", "cpu"]) == 0
assert "1942 k-min-mers from 99925 bases" in buf.getvalue(), buf.getvalue()
with fasta.FastaFile("tests/data/ecoli.genome.100k.fa") as f:
    assert f.native and len(f) == 1
assert stream.stream_file("tests/data/ecoli.genome.100k.fa", p.PipelineSpec(l=31, k=5, density=0.01), device="cpu").total_kminmers == 1942
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "rust_seq2kminmers_tpu")]
assert bad == ["jax"] and sys.modules["jax"] is None, bad
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
