"""The port's command line (``python -m rust_seq2kminmers_torch``) against
the reference package's, on the CPU: the demo line for line, the FASTA run
and its ``.npz``."""

import contextlib
import io
from pathlib import Path

import jax  # noqa: F401  (the reference package's own import, made explicit)
import numpy as np
import pytest
import torch

from rust_seq2kminmers_torch import __main__ as pm
from rust_seq2kminmers_tpu import __main__ as jm
from rust_seq2kminmers_tpu import runtime

FIXTURE = str(Path(__file__).parent / "data" / "ecoli.genome.100k.fa")


def _stdout(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args, **kw)
    return result, buf.getvalue()


@pytest.fixture(scope="module")
def jax_demo():
    return _stdout(jm.demo)[1]


def test_demo_equals_reference(jax_demo):
    rc, out = _stdout(pm.main, ["--device", "cpu"])
    assert rc == 0
    assert out.splitlines() == jax_demo.splitlines()
    assert _stdout(pm.demo, device="cpu")[1] == jax_demo
    assert sum(line.startswith("kminmer: KminmerHash") for line in out.splitlines()) > 4


@pytest.fixture(scope="module")
def jax_npz(tmp_path_factory):
    """The reference CLI's ordered stream of the fixture (its compile cache
    left off: the test writes nothing outside its temporary directory)."""
    out = tmp_path_factory.mktemp("cli") / "jax.npz"
    mp = pytest.MonkeyPatch()
    mp.setattr(runtime, "enable_compile_cache", lambda *a, **kw: None)
    try:
        rc, text = _stdout(jm.main, [FIXTURE, "4", "-o", str(out)])
    finally:
        mp.undo()
    assert rc == 0 and "1942 k-min-mers from 99925 bases" in text
    return np.load(out)


def test_fasta_run_equals_reference(jax_npz, tmp_path):
    out = tmp_path / "port.npz"
    rc, text = _stdout(pm.main, [FIXTURE, "4", "--device", "cpu", "-o", str(out)])
    assert rc == 0
    lines = text.splitlines()
    assert lines[0].endswith("(4 packer threads, device cpu)")
    assert "FASTA to kminmers in " in lines[1]
    assert "1942 k-min-mers from 99925 bases over 1 records" in lines[1]
    assert lines[2] == f"ordered k-min-mer stream written to {out}"
    mine = np.load(out)
    assert sorted(mine.files) == sorted(jax_npz.files)
    for c in jax_npz.files:
        assert mine[c].dtype == jax_npz[c].dtype
        np.testing.assert_array_equal(mine[c], jax_npz[c], err_msg=c)


def test_fasta_run_options(tmp_path):
    """The reference's options reach the stream: hpcsimd at l=21, k=4."""
    rc, text = _stdout(pm.main, [FIXTURE, "--device", "cpu", "--mode", "hpcsimd", "-l", "21",
                                 "-k", "4", "-d", "0.02", "--progress"])
    assert rc == 0
    assert "  batch of 1 reads -> " in text and "from 99925 bases" in text


def test_missing_file_returns_2(tmp_path, capsys):
    assert pm.main([str(tmp_path / "absent.fa"), "--device", "cpu"]) == 2
    assert "input file not found" in capsys.readouterr().err


def test_cuda_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        _stdout(pm.main, [FIXTURE])
    with pytest.raises(RuntimeError, match="cuda"):
        _stdout(pm.demo)
