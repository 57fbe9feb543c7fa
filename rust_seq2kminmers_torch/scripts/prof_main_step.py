"""Profiles a path's step on one NVIDIA GPU: ``kminmer_pipeline`` at
[32, 1 Mbp] random ACGT (the shape and data of ``chip_smoke.py``), on the
main path (hpcsimd, l=31, k=5, d=0.01, u32) or with ``--path general`` on
the general path (hpcsimd, nthash2, l=301, k=5, d=0.01).

    python -m rust_seq2kminmers_torch.scripts.prof_main_step [--root DIR] [--path general]

``--root`` measures the ``rust_seq2kminmers_torch`` of another checkout
(for example an earlier commit unpacked by ``git archive``, imported as
``s2k_root``), so that two versions are compared on one card in one call;
it uses only functions that both have.  Prints the card's name and power limit, then:

  1. the step time by CUDA events over 20 back-to-back steps alternating
     two batches, three times;
  2. 10 steps under ``torch.profiler``: device busy time a step (the union
     of the device spans), idle share, device kernels a step, and device
     time a step by kernel name (``common.profile``);
  3. the stages apart, each 10 times under the profiler: the minimizer
     stream (``_fused_minimizers``: K1, K2 and their glue; on the general
     path ``_general_minimizers``) and the k-min-mer fields (``_assemble``:
     K3 and, where there is one, its masking), with device kernels and
     device time a call;
  4. the host's time to enqueue a step and each stage (host clock over 20
     calls, without the profiler and before the closing synchronize);

and last one JSON line of these numbers.  Needs a GPU: without one it
exits with an error and prints no result.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

from .common import NOT_MEASURED, card, event_ms, load_package, profile

K1_KEYS = ("tile_summary", "tile_carries", "scan_kernel")


def host_ms(fn, reps=20):
    """Host-clock ms to issue a call of fn(i), before the closing sync."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i)
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e3


def kernels(prof, skip=()) -> tuple:
    """(device kernels, device ms) a call in ``prof``, without the kernels
    whose names hold one of ``skip``."""
    rows = [v for k, v in prof.by_kernel.items()
            if not k.startswith(("Memcpy", "Memset")) and not any(s in k for s in skip)]
    return sum(n for n, _ in rows), sum(ms for _, ms in rows)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--path", choices=("main", "general"), default="main")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if args.root is None:
        pkg = importlib.import_module(__package__.rsplit(".", 1)[0])
    else:
        pkg = load_package(Path(args.root).resolve(), "s2k_root")
    pipeline = importlib.import_module(pkg.__name__ + ".ops.pipeline")
    with_keep_bits = importlib.import_module(pkg.__name__ + ".constants").with_keep_bits

    name = card()
    print(f"{name}; package from {Path(pkg.__file__).parents[1]}; {args.path} path", flush=True)
    dev = torch.device("cuda", 0)
    B, L = 32, 1 << 20
    if args.path == "main":
        spec = pipeline.PipelineSpec(l=31, k=5, density=0.01, mode="hpcsimd",
                                     max_minimizers=int(L * 0.02) + 256)
        minimizers = pipeline._fused_minimizers
    else:
        spec = pipeline.PipelineSpec(l=301, k=5, density=0.01, mode="hpcsimd",
                                     variant="nthash2")
        minimizers = pipeline._general_minimizers
    rng = np.random.default_rng(7)
    pool = [torch.from_numpy(with_keep_bits(rng.integers(0, 4, (B, L), dtype=np.uint8)))
            .to(dev) for _ in range(2)]
    lengths = torch.full((B,), L, dtype=torch.int32, device=dev)
    m_cap = spec.capacity_for(L)

    def step(i):
        pipeline.kminmer_pipeline(pool[i % 2], lengths, spec)

    step_ms = [event_ms(step, 20, 3) for _ in range(3)]
    print("step (CUDA events, 20 steps) ms: " + ", ".join(f"{t:.4f}" for t in step_ms))

    res = {"card": name, "step_event_ms": step_ms}
    prof = profile(step, 10)
    res["host_ms_a_step"] = host_ms(step)
    if prof is None:
        print(f"10 steps under the profiler: {NOT_MEASURED}; host enqueue "
              f"{res['host_ms_a_step']:.4f} ms a step")
    else:
        res.update(busy_ms=prof.busy_ms, profiled_wall_ms=prof.wall_ms,
                   idle_share=prof.idle_share, kernels_a_step=prof.kernels,
                   device_events_a_step=prof.events)
        print(f"10 steps under the profiler: device busy {prof.busy_ms:.4f} ms a step of "
              f"{prof.wall_ms:.4f} ms wall (idle share {prof.idle_share:.4f}); "
              f"{prof.kernels:.1f} device kernels a step; host enqueue "
              f"{res['host_ms_a_step']:.4f} ms a step")
        for key, (n, ms) in sorted(prof.by_kernel.items(), key=lambda kv: -kv[1][1]):
            print(f"  {ms:8.4f} ms a step  x{n:<4.1f} {key[:100]}")

    stream = minimizers(pool[0], lengths, spec, pipeline._KERNELS, m_cap)
    stages = {
        "minimizer stream (all before K3)": lambda i: minimizers(
            pool[i % 2], lengths, spec, pipeline._KERNELS, m_cap),
        "k-min-mer fields (K3 and its masking)": lambda i: pipeline._assemble(
            spec, pipeline._KERNELS, *stream),
    }
    res["stages"] = {}
    for what, fn in stages.items():
        fn(0)
        prof = profile(fn, 10)
        row = {"host_ms_a_call": host_ms(fn)}
        res["stages"][what] = row
        if prof is None:
            print(f"{what}: {NOT_MEASURED}; host enqueue {row['host_ms_a_call']:.4f} ms a call")
            continue
        row["kernels_a_call"], row["device_ms_a_call"] = kernels(prof)
        row["kernels_a_call_without_k1"], row["device_ms_a_call_without_k1"] = kernels(
            prof, K1_KEYS)
        print(f"{what}: {row['kernels_a_call']:.1f} device kernels, "
              f"{row['device_ms_a_call']:.4f} ms device a call; without K1's kernels "
              f"{row['kernels_a_call_without_k1']:.1f} kernels, "
              f"{row['device_ms_a_call_without_k1']:.4f} ms; host enqueue "
              f"{row['host_ms_a_call']:.4f} ms a call")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
