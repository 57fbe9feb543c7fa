"""The burn-in script (``rust_seq2kminmers_torch/scripts/burnin.py``) on
the CPU: it passes, its draws keep to their ranges and routes, and a
wrong record makes it raise."""

import numpy as np
import pytest

from rust_seq2kminmers_torch import api
from rust_seq2kminmers_torch.ops.pipeline import PipelineSpec
from rust_seq2kminmers_torch.scripts import burnin


def test_burnin_passes_on_the_cpu(capsys):
    args = ["--device", "cpu", "--configs", "2", "--seqs", "2", "--general", "1", "--seed", "5"]
    assert burnin.main(args) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("session seed: 5")
    assert out[-1].startswith("BURN-IN PASS: 6 sequences across 3 random configs")
    assert "on cpu" in out[-1]


def test_burnin_counts_routes():
    counts = burnin.run(2, 2, 11, None, "cpu", 3, log=lambda msg: None)
    assert counts["sequences"] == 10 and counts["kminmers"] > 0
    assert counts["fused"] == 4 and counts["general"] == 6 and counts["general_hpc"] >= 2


def test_burnin_raises_on_a_wrong_record(monkeypatch):
    real = api.oracle_kminmers

    def wrong(*args, **kwargs):
        recs = real(*args, **kwargs)
        if recs:
            recs[-1].start += 1
        return recs

    monkeypatch.setattr(api, "oracle_kminmers", wrong)
    with pytest.raises(RuntimeError, match="burn-in mismatch .* seed 5"):
        burnin.main(["--device", "cpu", "--configs", "2", "--seqs", "2", "--seed", "5"])


@pytest.mark.parametrize("variant", [None, "nthash1", "nthash2"])
def test_draws_keep_to_their_ranges(variant):
    rng = np.random.default_rng(3)
    for _ in range(300):
        mode, width, var, l = burnin.draw_fused(rng, variant)
        if mode in ("simd", "hpcsimd"):
            assert (width, var) == (32, "nthash1") and 2 <= l < 32
        elif var == "nthash2":
            assert width == 32 and 2 <= l < 64 and mode in ("regular", "hpc")
        else:
            assert width in (16, 32, 64) and 2 <= l < (32 if mode == "regular" else 100)
        assert variant in (None, var) or mode in ("simd", "hpcsimd")
        assert PipelineSpec(l=l, k=2, density=0.1, mode=mode, hash_width=width,
                            variant=var).fused
    for turn in range(30):
        mode, width, var, l = burnin.draw_general(rng, turn, variant)
        assert variant in (None, var)
        assert l == 1 if (mode, var) == ("regular", "nthash1") else 256 <= l <= 400
        assert not PipelineSpec(l=l, k=2, density=0.1, mode=mode, hash_width=width,
                                variant=var).fused


def test_gen_seq_alphabets():
    rng = np.random.default_rng(0)
    for kind, allowed in (("acgt", "ACGT"), ("acgtn", "ACGTN"), ("case", "ACGTacgtNn"),
                          ("garbage", "ACGTacgtNnXY@z*-"), ("homo", "ACGTN")):
        seq = burnin.gen_seq(rng, kind, 500)
        assert len(seq) == 500 and set(seq) <= set(allowed)
    assert len(burnin.gen_seq(rng, "homo", 0)) == 0
