"""Profiles a path's step on one NVIDIA GPU: ``kminmer_pipeline`` at
[32, 1 Mbp] random ACGT (the shape and data of ``chip_smoke.py``), on the
main path (hpcsimd, l=31, k=5, d=0.01, u32) or with ``--path general`` on
the general path (hpcsimd, nthash2, l=301, k=5, d=0.01).

    python rust_seq2kminmers_torch/scripts/prof_main_step.py [--root DIR] [--path general]

``--root`` imports ``rust_seq2kminmers_torch`` from another checkout (for
example an earlier commit unpacked by ``git archive``), so that two
versions are compared on one card in one call; it uses only functions that
both have.  Prints the card's name and power limit, then:

  1. the step time by CUDA events over 20 back-to-back steps alternating
     two batches, three times;
  2. 10 steps under ``torch.profiler``: device busy time a step (the union
     of the device spans), idle share, device kernels a step, and device
     time a step by kernel;
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
import json
import subprocess
import sys
import time
from pathlib import Path

K1_KEYS = ("tile_summary", "tile_carries", "scan_kernel")


def _kernels(events):
    return [e for e in events if not e.name.startswith(("Memcpy", "Memset"))]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--path", choices=("main", "general"), default="main")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from rust_seq2kminmers_torch.constants import with_keep_bits
    from rust_seq2kminmers_torch.ops import pipeline
    from rust_seq2kminmers_torch.scripts.prof_long_read import device_busy

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"{card}; package from {root}; {args.path} path", flush=True)
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

    for i in range(3):
        step(i)
    torch.cuda.synchronize()
    event_ms = []
    for _ in range(3):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for i in range(20):
            step(i)
        e1.record()
        e1.synchronize()
        event_ms.append(e0.elapsed_time(e1) / 20)
    print("step (CUDA events, 20 steps) ms: " + ", ".join(f"{t:.4f}" for t in event_ms))

    def host_ms(fn, reps=20):
        fn(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(reps):
            fn(i)
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / reps * 1e3

    def profiled(fn, reps=10):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            for i in range(reps):
                fn(i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        evs = [e for e in p.events() if e.device_type == DeviceType.CUDA]
        if not evs:
            raise RuntimeError("the profiler recorded no device event")
        return evs, wall

    evs, wall = profiled(step)
    busy, _ = device_busy(evs)
    by_name = {}
    for e in evs:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + (e.time_range.end - e.time_range.start) / 1e4)
    res = {
        "card": card,
        "step_event_ms": event_ms,
        "busy_ms": busy * 100,
        "profiled_wall_ms": wall * 100,
        "idle_share": 1 - busy / wall,
        "kernels_a_step": len(_kernels(evs)) / 10,
        "device_events_a_step": len(evs) / 10,
        "host_ms_a_step": host_ms(step),
    }
    print(f"10 steps under the profiler: device busy {res['busy_ms']:.4f} ms a step of "
          f"{res['profiled_wall_ms']:.4f} ms wall (idle share {res['idle_share']:.4f}); "
          f"{res['kernels_a_step']:.1f} device kernels a step; host enqueue "
          f"{res['host_ms_a_step']:.4f} ms a step")
    for name, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        print(f"  {ms:8.4f} ms a step  x{n / 10:<4.1f} {name[:100]}")

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
        evs, _ = profiled(fn)
        ks = _kernels(evs)
        not_k1 = [e for e in ks if not any(k in e.name for k in K1_KEYS)]
        row = {
            "kernels_a_call": len(ks) / 10,
            "device_ms_a_call": sum(e.time_range.end - e.time_range.start for e in ks) / 1e4,
            "kernels_a_call_without_k1": len(not_k1) / 10,
            "device_ms_a_call_without_k1":
                sum(e.time_range.end - e.time_range.start for e in not_k1) / 1e4,
            "host_ms_a_call": host_ms(fn),
        }
        res["stages"][what] = row
        print(f"{what}: {row['kernels_a_call']:.1f} device kernels, "
              f"{row['device_ms_a_call']:.4f} ms device a call; without K1's kernels "
              f"{row['kernels_a_call_without_k1']:.1f} kernels, "
              f"{row['device_ms_a_call_without_k1']:.4f} ms; host enqueue "
              f"{row['host_ms_a_call']:.4f} ms a call")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
