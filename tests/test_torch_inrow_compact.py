"""K5/K6's plain version (rust_seq2kminmers_torch/ops/cuda/inrow_compact.py)
against the reference profiling script's two Pallas kernels in interpret
mode, on its [512, 128] tile: payloads are u16 values carried in f32, so
every comparison is exact, bit for bit."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_seq2kminmers_torch.ops.cuda import inrow_compact as port
from rust_seq2kminmers_torch.scripts import prof_mxu_compact as port_script

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "prof_mxu_compact.py"


@pytest.fixture(scope="module")
def ref_script():
    spec = importlib.util.spec_from_file_location("ref_prof_mxu_compact", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed, npay, keep_share):
    rng = np.random.default_rng(seed)
    keep = (rng.random((port_script.R, port.LANES)) < keep_share).astype(np.float32)
    xs = [rng.integers(0, 1 << 16, size=keep.shape).astype(np.float32)
          for _ in range(npay)]
    return xs, keep


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("npay", [1, 4])
@pytest.mark.parametrize("keep_share", [0.0, 0.75, 1.0])
@pytest.mark.parametrize("kernel", ["run_roll", "run_onehot"])
def test_plain_matches_reference_kernels(ref_script, kernel, keep_share, npay):
    xs, keep = _inputs(int(keep_share * 100) + npay, npay, keep_share)
    want = getattr(ref_script, kernel)(
        [jnp.asarray(x) for x in xs], jnp.asarray(keep), interpret=True
    )
    got = port.inrow_compact_plain([torch.from_numpy(x) for x in xs], torch.from_numpy(keep))
    assert len(got) == len(want) == npay
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    if keep_share == 0.0:
        assert not any(g.any() for g in got)


def test_script_inputs_and_reference(ref_script):
    """The port's script draws the reference's inputs in its order, its
    numpy reference is the reference's row loop, and both wrappers take
    the plain version on CPU tensors."""
    rng = np.random.default_rng(3)
    kh = (rng.random((ref_script.R, ref_script.L)) < 0.75).astype(np.float32)
    inputs = port_script.tile_inputs()
    np.testing.assert_array_equal(inputs[1][1], kh)
    for npay in port_script.PAYLOADS:
        xs, keep = inputs[npay]
        np.testing.assert_array_equal(xs[0], rng.integers(0, 1 << 16, size=kh.shape)
                                      .astype(np.float32))
        for _ in range(npay - 1):
            rng.integers(0, 1 << 16, size=kh.shape)
        refs = port_script.numpy_reference(xs, keep)
        txs, tk = [torch.from_numpy(x) for x in xs], torch.from_numpy(keep)
        for fn in (port.inrow_compact_plain, port.inrow_compact_ballot,
                   port.inrow_compact_mma):
            for g, w in zip(fn(txs, tk), refs):
                np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


def test_wrappers_reject_bad_inputs():
    keep = torch.ones((4, 128))
    x = torch.zeros((4, 128))
    with pytest.raises(ValueError, match="payloads"):
        port.inrow_compact_ballot([x] * 5, keep)
    with pytest.raises(ValueError, match="payloads"):
        port.inrow_compact_mma([], keep)
    with pytest.raises(TypeError):
        port.inrow_compact_ballot([x.to(torch.int32)], keep)
    with pytest.raises(ValueError):
        port.inrow_compact_mma([x], torch.ones((4, 64)))


def test_script_needs_a_gpu():
    """Without a GPU the profiling script exits non-zero and times nothing."""
    if not torch.cuda.is_available():
        assert port_script.main() == 1
