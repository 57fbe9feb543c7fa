#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (mode hpcsimd, l=31, k=5, d=0.01, u32 hashes,
a [32, 1 Mbp] xcode batch made from a numpy seed) through its user entry
points, after building the CUDA kernels from ``rust_seq2kminmers_torch/
csrc``.  In order, and any failure raises (exit code != 0):

  1. needs a GPU; prints the card's name and power limit;
  2. builds the kernel library; prints the build time and ptxas's
     register / shared-memory / spill lines;
  3. checks each kernel (K1 fused scan, K2 slot compaction, K3 assembly)
     bit for bit against its plain PyTorch version at the main-path shapes;
  4. reproduces the 15 u32 golden hashes (tests/data/ecoli.genome.100k.fa,
     regular, l=10, k=5, d=0.0001) on the card;
  5. with the launch counters at zero, runs the batch through
     ``kminmers_batch``; every kernel must have launched, and all 12
     KminmerBatch fields must equal the plain pipeline's on the card;
  6. times the main path and each kernel with CUDA events, beside the
     plain versions.

The second-to-last line is a JSON object with one entry per kernel; the
last is ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 7
B, L = 32, 1 << 20
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "fused_scan": (
        "rust_seq2kminmers_torch/csrc/fused_scan.cu",
        "rust_seq2kminmers_tpu/ops/pallas/fused_scan.py:357",
    ),
    "slot_compact": (
        "rust_seq2kminmers_torch/csrc/slot_compact.cu",
        "rust_seq2kminmers_tpu/ops/pallas/slot_compact.py:37",
    ),
    "assemble": (
        "rust_seq2kminmers_torch/csrc/assemble.cu",
        "rust_seq2kminmers_tpu/ops/pallas/assemble_kernel.py:71",
    ),
}


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"FAILED: {msg}")


def log(msg):
    print(msg, flush=True)


def main():
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    from rust_seq2kminmers_torch import kminmers_list
    from rust_seq2kminmers_torch.api import kminmers_batch
    from rust_seq2kminmers_torch.constants import with_keep_bits
    from rust_seq2kminmers_torch.ops.assemble import assemble_kminmers
    from rust_seq2kminmers_torch.ops.cuda import build
    from rust_seq2kminmers_torch.ops.cuda.assemble_kernel import (
        assemble_kminmers_cuda,
    )
    from rust_seq2kminmers_torch.ops.cuda.fused_scan import (
        TILE,
        fused_minimizer_scan,
        fused_scan_plain,
        valid_slots,
    )
    from rust_seq2kminmers_torch.ops.cuda.slot_compact import (
        slot_compact,
        slot_compact_plain,
    )
    from rust_seq2kminmers_torch.ops.pipeline import (
        PipelineSpec,
        kminmer_pipeline,
        kminmer_pipeline_plain,
    )

    # 1. the card
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    card = smi.splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 2. the build
    lib = build.library()
    how = "built" if lib.built else "loaded an earlier build"
    log(f"build: {how} in {lib.seconds:.2f} s -> {lib.path.relative_to(REPO)}")
    ptxas = [ln for ln in lib.log.splitlines() if "ptxas" in ln or "spill" in ln]
    check(ptxas, "no ptxas lines in the nvcc log")
    for ln in ptxas:
        log(f"  {ln}")

    # The main-path batch: random ACGT with keep bits, full-length reads,
    # two distinct batches so that consecutive timed steps miss the L2.
    spec = PipelineSpec(
        l=31, k=5, density=0.01, mode="hpcsimd",
        max_minimizers=int(L * 0.02) + 256,
    )
    rng = np.random.default_rng(SEED)
    pool = [
        torch.from_numpy(with_keep_bits(rng.integers(0, 4, (B, L), dtype=np.uint8)))
        .to(dev)
        for _ in range(2)
    ]
    codes = pool[0]
    lengths = torch.full((B,), L, dtype=torch.int32, device=dev)
    limit = torch.full((B,), 1 << 30, dtype=torch.int32, device=dev)
    m_cap = spec.capacity_for(L)
    cap = spec.cap_per_tile(TILE)
    scan_args = (spec.l, spec.bound, spec.strict_threshold, spec.is_hpc, False)

    # 3. each kernel against its plain version, at the main-path shapes
    def max_abs_err(got, want):
        return max(
            float((g.to(torch.float64) - w.to(torch.float64)).abs().max())
            for g, w in zip(got, want)
        )

    k1 = fused_minimizer_scan(codes, lengths, limit, *scan_args, TILE, cap)
    k1p = fused_scan_plain(codes, lengths, limit, *scan_args, TILE, cap)
    k1_cmp = [valid_slots(t, k1[3]) for t in k1[:3]] + [k1[3]]
    errs = {"fused_scan": max_abs_err(k1_cmp, k1p)}
    kept = k1[3][:, :, 0].contiguous()
    k2 = slot_compact(*k1[:3], kept, m_cap)
    k2p = slot_compact_plain(*k1[:3], kept, m_cap)
    errs["slot_compact"] = max_abs_err([*k2[0], k2[1]], [*k2p[0], k2p[1]])
    min_hash = k2[0][2]
    k3 = assemble_kminmers_cuda(min_hash, spec.k)
    k3p = assemble_kminmers(min_hash, spec.k)
    errs["assemble"] = max_abs_err([*k3[0], k3[1]], [*k3p[0], k3p[1]])
    torch.cuda.synchronize()
    for name, err in errs.items():
        log(f"{name}: kernel vs plain max_abs_err={err} (tolerance 0: bit-exact)")
        check(err == 0, f"{name} kernel differs from its plain version")
    n_raw_tiles = int(k1[3][:, :, 1].sum())
    check(n_raw_tiles > 0, "K1 selected no minimizer")
    check(bool((k1[3][:, :, 0] == k1[3][:, :, 1]).all()), "K1 tile overflow")

    # 4. the goldens, on the card
    golden = json.loads((REPO / "tests/data/goldens_u32.json").read_text())
    seq = (REPO / "tests/data/ecoli.genome.100k.fa").read_text().split("\n")[1]
    recs = kminmers_list(
        seq, golden["l"], golden["k"], golden["density"], golden["mode"], device=dev
    )
    check([r.hash for r in recs] == golden["hashes"], "u32 goldens")
    log(f"goldens: {len(recs)} u32 k-min-mer hashes equal the reference's")

    # 5. the main path, through the user entry point, with counters at 0
    build.launches.clear()
    out = kminmers_batch(codes, lengths, spec)
    torch.cuda.synchronize()
    launches = {name: build.launches[name] for name in KERNELS}
    log(f"main path launches: {launches}")
    for name, n in launches.items():
        check(n > 0, f"the main path never launched {name}")
    plain = kminmer_pipeline_plain(codes, lengths, spec)
    torch.cuda.synchronize()
    for name, g, w in zip(out._fields, out, plain):
        check(g.shape == w.shape and g.dtype == w.dtype, f"{name} shape/dtype")
        check(torch.equal(g, w), f"main path field {name} differs from plain")
    mk = m_cap - spec.k + 1
    check(tuple(out.hash_lo.shape) == (B, mk), "k-min-mer shape")
    check(torch.equal(out.n_minimizers, out.n_minimizers_raw), "minimizers lost")
    n_km = int(out.n_kminmers.sum())
    check(n_km > 0, "no k-min-mers")
    log(f"main path [{B}, {L}] hpcsimd: all 12 KminmerBatch fields equal the "
        f"plain pipeline on the card; {n_km} k-min-mers, "
        f"{int(out.n_minimizers.sum())} minimizers")

    # 6. timing (CUDA events, after warm-up)
    def time_ms(fn, reps, warmup=2):
        for i in range(warmup):
            fn(i)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for i in range(reps):
            fn(i)
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / reps

    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = time_ms(lambda i: kminmer_pipeline(pool[i % 2], lengths, spec), 20)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    plain_step_ms = time_ms(
        lambda i: kminmer_pipeline_plain(pool[i % 2], lengths, spec), 3, 1
    )
    k1_runs = [
        fused_minimizer_scan(c, lengths, limit, *scan_args, TILE, cap) for c in pool
    ]
    kept_runs = [r[3][:, :, 0].contiguous() for r in k1_runs]
    ms = {
        "fused_scan": time_ms(
            lambda i: fused_minimizer_scan(
                pool[i % 2], lengths, limit, *scan_args, TILE, cap), 20),
        "slot_compact": time_ms(
            lambda i: slot_compact(*k1_runs[i % 2][:3], kept_runs[i % 2], m_cap),
            50),
        "assemble": time_ms(lambda i: assemble_kminmers_cuda(min_hash, spec.k), 50),
    }
    plain_ms = {
        "fused_scan": time_ms(
            lambda i: fused_scan_plain(
                pool[i % 2], lengths, limit, *scan_args, TILE, cap), 3, 1),
        "slot_compact": time_ms(
            lambda i: slot_compact_plain(
                *k1_runs[i % 2][:3], kept_runs[i % 2], m_cap), 10),
        "assemble": time_ms(lambda i: assemble_kminmers(min_hash, spec.k), 10),
    }
    gbps = B * L / (step_ms * 1e-3) / 1e9
    plain_gbps = B * L / (plain_step_ms * 1e-3) / 1e9
    log(f"main path step [{B}, {L}] hpcsimd on {card}: {step_ms:.4f} ms = "
        f"{gbps:.4f} GB/s (plain pipeline {plain_step_ms:.4f} ms = "
        f"{plain_gbps:.4f} GB/s); peak device memory {peak_gib:.3f} GiB")
    for name in KERNELS:
        log(f"{name} on {card}: kernel {ms[name]:.4f} ms, plain {plain_ms[name]:.4f} ms")

    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": ms[name],
            "plain_ms": plain_ms[name],
        }
        for name, (src, replaces) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
