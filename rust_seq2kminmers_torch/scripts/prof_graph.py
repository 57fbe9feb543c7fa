"""The compiled step on one NVIDIA GPU: the eager ``kminmer_pipeline``
against its captured graph (``make_pipeline``), and what capturing costs.

    python -m rust_seq2kminmers_torch.scripts.prof_graph

Prints the card's name and power limit, then for the main, general and
u64 paths at [32, 1 Mbp] (the data and specs of ``chip_smoke.py``):

  1. the capture: seconds, and the memory it holds (the growth of
     ``torch.cuda.memory_reserved`` over the capture, the cache emptied
     first: the static inputs and the graph's private pool);
  2. the step by CUDA events over 20 steps alternating two batches, and
     the host's seconds to issue a step (host clock over 20 calls before
     the closing synchronize), eager and graph in turns: eager, graph,
     graph, eager;
  3. 10 steps of each under ``torch.profiler``: device busy a step (the
     union of the device spans), idle share, device kernels a step, and
     for the graph the device time of its input copy and output handoff;

then phase 13's burn-in draw (``chip_smoke.py``: 24 fused-route and 6
general-route configurations of 6 sequences, seed 20261017) through
``kminmers_list`` with the pipelines run eagerly, with each key captured
on its first call (``make_pipeline``'s rule) and with each captured on its
second call, the first run eagerly (a rule emulated here): the seconds
and the graphs captured, after one eager pass that loads every kernel.
Last, one JSON line of these numbers.  Needs a GPU: without one it exits
with an error and prints no result.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

B, L = 32, 1 << 20
SEED = 7
BURNIN = dict(configs=24, seqs=6, seed=20261017, general=6)  # chip_smoke.py phase 13
HANDOFF_KEYS = {"input copy": ("Memcpy DtoD",), "handoff": ("CatArrayBatchedCopy",)}


def path_specs():
    from rust_seq2kminmers_torch.ops.pipeline import PipelineSpec

    return {
        "main": PipelineSpec(l=31, k=5, density=0.01, mode="hpcsimd",
                             max_minimizers=int(L * 0.02) + 256),
        "general": PipelineSpec(l=301, k=5, density=0.01, mode="hpcsimd", variant="nthash2"),
        "u64": PipelineSpec(l=31, k=5, density=0.01, mode="regular", hash_width=64),
    }


def event_ms(fn, reps=20) -> float:
    """CUDA-event ms a call of fn(i), over reps calls after two warm ones."""
    fn(0)
    fn(1)
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for i in range(reps):
        fn(i)
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def host_ms(fn, reps=20) -> float:
    """Host-clock ms to issue a call of fn(i), before the closing sync."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i)
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e3


def profiled(fn, reps=10):
    """reps calls under the profiler -> device busy ms a call, idle share,
    device kernels a call, and device ms a call of HANDOFF_KEYS' events;
    None where no session recorded a device event."""
    from rust_seq2kminmers_torch.scripts.prof_long_read import device_busy, device_events

    fn(0)
    torch.cuda.synchronize()
    evs, wall = device_events(lambda: [fn(i) for i in range(reps)])
    if not evs:
        return None
    busy, _ = device_busy(evs)
    out = {
        "busy_ms": busy / reps * 1e3,
        "idle_share": 1 - busy / wall,
        "kernels": sum(not e.name.startswith(("Memcpy", "Memset")) for e in evs) / reps,
    }
    for what, keys in HANDOFF_KEYS.items():
        out[f"{what}_ms"] = sum(e.time_range.end - e.time_range.start for e in evs
                                if any(k in e.name for k in keys)) / 1e3 / reps
    return out


def measure_path(spec, pool, lengths) -> dict:
    """Eager against a fresh compiled pipeline on ``pool``'s two batches."""
    from rust_seq2kminmers_torch.ops.pipeline import make_pipeline, kminmer_pipeline

    dev = pool[0].device
    fn = make_pipeline(spec)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    t0 = time.perf_counter()
    fn.capture(pool[0], lengths)
    torch.cuda.synchronize()
    res = {"capture_s": time.perf_counter() - t0}
    torch.cuda.empty_cache()  # the warm-up's blocks; the graph's pool stays
    res["pool_mib"] = (torch.cuda.memory_reserved(dev) - reserved) / 2**20
    steps = {"eager": lambda i: kminmer_pipeline(pool[i % 2], lengths, spec),
             "graph": lambda i: fn(pool[i % 2], lengths)}
    turns = ("eager", "graph", "graph", "eager")
    res["event_ms"] = [(w, event_ms(steps[w])) for w in turns]
    res["host_ms"] = [(w, host_ms(steps[w])) for w in turns]
    res["profile"] = {w: profiled(steps[w]) for w in ("eager", "graph")}
    return res


def burnin_times(dev) -> dict:
    """Phase 13's draw under each capture rule -> {rule: {seconds,
    graphs}}; an eager pass first loads every kernel."""
    from rust_seq2kminmers_torch import api
    from rust_seq2kminmers_torch.ops import pipeline
    from rust_seq2kminmers_torch.ops.cuda import graph
    from rust_seq2kminmers_torch.scripts import burnin

    captured = []

    class Counted(graph.CapturedStep):
        def __init__(self, *args):
            captured.append(1)
            super().__init__(*args)

    class SecondCall(pipeline.CompiledPipeline):
        """A key's first call eager, its second captured."""

        def __init__(self, spec):
            super().__init__(spec)
            self.seen = set()

        def __call__(self, codes, lengths):
            key = (tuple(codes.shape), tuple(lengths.shape))
            if key in self.seen:
                return super().__call__(codes, lengths)
            self.seen.add(key)
            return pipeline.kminmer_pipeline(codes, lengths, self.spec)

    real = (api._cached_pipeline, graph.CapturedStep)
    rules = {
        "eager, loading": lambda spec: functools.partial(pipeline.kminmer_pipeline, spec=spec),
        "eager": lambda spec: functools.partial(pipeline.kminmer_pipeline, spec=spec),
        "capture on call 1": functools.lru_cache(maxsize=64)(pipeline.CompiledPipeline),
        "capture on call 2": functools.lru_cache(maxsize=64)(SecondCall),
    }
    rules["eager again"] = rules["eager"]
    out = {}
    try:
        graph.CapturedStep = Counted
        for rule, cached in rules.items():
            api._cached_pipeline = cached
            captured.clear()
            t0 = time.perf_counter()
            burnin.run(BURNIN["configs"], BURNIN["seqs"], BURNIN["seed"], None, dev,
                       BURNIN["general"], log=lambda *a: None)
            torch.cuda.synchronize()
            out[rule] = {"seconds": time.perf_counter() - t0, "graphs": len(captured)}
    finally:
        api._cached_pipeline, graph.CapturedStep = real
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from rust_seq2kminmers_torch.constants import with_keep_bits

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    pool = [torch.from_numpy(with_keep_bits(rng.integers(0, 4, (B, L), dtype=np.uint8)))
            .to(dev) for _ in range(2)]
    lengths = torch.full((B,), L, dtype=torch.int32, device=dev)
    res = {"card": card, "paths": {}}
    for path, spec in path_specs().items():
        r = res["paths"][path] = measure_path(spec, pool, lengths)
        print(describe(path, r), flush=True)
    res["burnin"] = burnin_times(dev)
    for rule, r in res["burnin"].items():
        print(f"phase 13's draw, {rule}: {r['seconds']:.4f} s, {r['graphs']} graphs captured",
              flush=True)
    print(json.dumps(res))
    return 0


def describe(path: str, r: dict) -> str:
    """One line of ``measure_path``'s numbers."""
    from rust_seq2kminmers_torch.scripts.prof_long_read import NOT_MEASURED

    pe, pg = r["profile"]["eager"], r["profile"]["graph"]
    eager = (NOT_MEASURED if pe is None else f"{pe['busy_ms']:.4f} (idle share "
             f"{pe['idle_share']:.4f}, {pe['kernels']:.1f} kernels)")
    graph = (NOT_MEASURED if pg is None else f"{pg['busy_ms']:.4f} (idle share "
             f"{pg['idle_share']:.4f}, {pg['kernels']:.1f} kernels; input copy "
             f"{pg['input copy_ms']:.4f} ms, handoff {pg['handoff_ms']:.4f} ms)")
    return (
        f"{path} path [{B}, {L}]: capture {r['capture_s']:.4f} s holding "
        f"{r['pool_mib']:.1f} MiB; CUDA-event step ms in turns "
        + ", ".join(f"{w} {t:.4f}" for w, t in r["event_ms"])
        + "; host ms to issue a step " + ", ".join(f"{w} {t:.4f}" for w, t in r["host_ms"])
        + f"; device busy ms a step eager {eager}, graph {graph}"
    )


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    sys.exit(main())
