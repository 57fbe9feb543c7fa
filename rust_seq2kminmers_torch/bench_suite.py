"""Per-stage benchmark suite, the counterpart of
``rust_seq2kminmers_tpu/bench_suite.py`` case for case: the reference
crate's criterion cases (benches/bench.rs:33-147), namely the host HPC
string kernels, the sliding-hash stage alone and the whole pipeline in
all four modes, plus the reference package's extensions (nthash2 at l=45,
hpc at l=100, hash widths 64 and 16).

    python -m rust_seq2kminmers_torch.bench_suite [--size BYTES] [--steps N]
        [--host-size N] [--skip-device] [--device cuda|cpu]

Prints one JSON line a case: {"case", "value", "unit", ...}.

Device cases: a pool of 8 distinct [B, L] batches of random ACGT with
keep bits, made on the device from a seeded generator; a unit makes
``steps`` calls over ``pool[i % 8]`` and adds each call's checksum into
one device scalar, so no output can go unread, and the host reads that
scalar once (its one sync).  On the card the unit is one captured CUDA
graph, as the reference's unit is one jitted scan; its warm-up run and
one replay warm it, then the median of 3 replays.  ``value`` is B * L
bases over the median step time, on the device each row names, with the
card's power limit beside it.  A CUDA device that does not exist raises:
nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

POOL = 8
SEED = 7
UNITS = 3  # timed units a case, after one warm unit


def _bench_host(fn, data, reps=5):
    fn(data)  # warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(data)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def host_backend() -> str:
    """What serves the string calls: the host library, with its AVX-512
    or its scalar collapse on this CPU, and the CPU's model name."""
    from .io import native_ext

    kind = "avx512" if native_ext.avx512()["rle"] else "scalar"
    return f"host-native-c++ ({kind}; {cpu_model()})"


def cpu_model() -> str:
    """The host CPU as /proc/cpuinfo names it (Linux): its model name, then
    vendor, family and model numbers (a virtual machine may hide the name),
    or the platform's processor."""
    import platform

    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                if not key.strip():
                    break  # the first processor only
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        return platform.processor() or "unknown CPU"
    return (f"{fields.get('model name', 'unknown')}, {fields.get('vendor_id', '?')} "
            f"family {fields.get('cpu family', '?')} model {fields.get('model', '?')}")


def host_cases(size: int):
    """The string-level HPC kernels (reference bench.rs:36-49) on random
    ACGT, through ``hpc_strings`` (the host library).  Three rows a
    kernel: the median of single calls (what one API call costs), a
    steady loop of at least 30 ms a timed repetition (criterion's method),
    and the kernel alone, repeated inside the library for 50 ms into
    reused buffers, best of 3 (no call overhead in the loop)."""
    from .constants import byte_view
    from .hpc_strings import encode_rle, encode_rle_simd, hpc
    from .io import native_ext

    backend = host_backend()
    rng = np.random.default_rng(1)
    seq = "".join(rng.choice(list("ACGT"), size=size))
    for name, fn in [
        ("hpc_plain", hpc),
        ("hpc_encode_rle", encode_rle),
        ("hpc_encode_rle_simd", encode_rle_simd),
    ]:
        dt = _bench_host(fn, seq)
        yield {
            "case": name,
            "value": size / dt / 1e9,
            "unit": "GB/s",
            "backend": backend,
            "size": size,
        }
        iters = max(1, int(0.03 / max(dt, 1e-9)))

        def loop(s, fn=fn, iters=iters):
            for _ in range(iters):
                fn(s)

        dts = _bench_host(loop, seq)
        yield {
            "case": f"{name}_steady",
            "value": size * iters / dts / 1e9,
            "unit": "GB/s",
            "backend": backend,
            "size": size,
            "iters_per_rep": iters,
        }
    data = byte_view(seq)
    for name, (collapse_any, wide, want_pos) in [
        ("hpc_plain", (True, False, False)),
        ("hpc_encode_rle", (False, True, True)),
        ("hpc_encode_rle_simd", (True, False, True)),
    ]:
        best = 0.0
        for _ in range(3):
            iters, ns = native_ext.rle_loop(data, collapse_any, wide, want_pos, 50)
            best = max(best, size * iters / max(ns, 1))
        yield {
            "case": f"{name}_native_loop",
            "value": best,
            "unit": "GB/s",
            "backend": f"{backend}, in-library loop",
            "size": size,
        }


def batch_shape(size: int):
    """(B, L) of the device cases: reads of 1 Mbp where size allows, up
    to 32 of them, L a multiple of 1024 and at least 2^14."""
    B = max(1, min(32, size // (1 << 20)))
    L = max(1 << 14, (size // B // 1024) * 1024)
    return B, L


def make_pool(B: int, L: int, device, n: int = POOL) -> torch.Tensor:
    """uint8[n, B, L]: random ACGT xcodes, made on ``device`` from a
    generator seeded with SEED."""
    from .ops.hpc import with_keep_bits_device

    g = torch.Generator(device=device).manual_seed(SEED)
    pool = torch.empty((n, B, L), dtype=torch.uint8, device=device)
    for p in pool:
        p.copy_(with_keep_bits_device(torch.randint(
            0, 4, (B, L), generator=g, dtype=torch.uint8, device=device)))
    return pool


def pipeline_cases(L: int):
    """[(case, PipelineSpec)]: the four modes at l=31, k=5, d=0.01, then
    the extensions, each with M = int(L * 0.02) + 256."""
    from .ops.pipeline import PipelineSpec

    m_cap = int(L * 0.02) + 256
    kws = [(f"kminmers_{mode}_l31_k5_d0.01", dict(mode=mode))
           for mode in ("regular", "simd", "hpc", "hpcsimd")]
    kws += [
        ("kminmers_regular_nthash2_l45", dict(l=45, variant="nthash2")),
        ("kminmers_hpc_l100_k5", dict(l=100, mode="hpc")),
        ("kminmers_regular_u64_l31", dict(hash_width=64)),
        ("kminmers_regular_u16_l31", dict(hash_width=16)),
    ]
    return [
        (name, PipelineSpec(**{"l": 31, "k": 5, "density": 0.01, "mode": "regular",
                               "max_minimizers": m_cap, **kw}))
        for name, kw in kws
    ]


def checksum(out) -> torch.Tensor:
    """The reference suite's checksum of a KminmerBatch, an int64 scalar
    on its device: sum(n_kminmers) + sum(hash_lo as int32) + sum(start)."""
    return out.n_kminmers.sum() + out.hash_lo.sum() + out.start.sum()


def dense_hash(codes: torch.Tensor) -> torch.Tensor:
    """The sliding-hash stage alone: canonical 32-bit NtHash1 of every
    l=31 window, min(fh, rh) (reference bench.rs:51-73)."""
    from .ops.nthash import sliding_nthash32

    fh, rh = sliding_nthash32(codes, 31)
    return torch.minimum(fh, rh)


def card(device: torch.device):
    """(device name, power limit): the CUDA device's name and its limit as
    nvidia-smi prints it, or ("cpu", None)."""
    if device.type != "cuda":
        return "cpu", None
    smi = subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return torch.cuda.get_device_name(device), smi


def timed_units(step, pool, steps: int):
    """-> (the median over UNITS units, after a warm one, of a unit's
    host-clock time over its steps; the last unit's sums, as ints).  A
    unit is ``steps`` calls of ``step`` over ``pool[i % len(pool)]``, each
    call's tuple of device scalars added into the unit's sums on the
    device; the host reads the sums once (the unit's one sync).

    On the card the unit is one captured graph (``ops/cuda/graph.py``)
    that reads the resident pool in place, and each unit replays it; its
    capture's warm-up is one eager unit.  The reference's unit takes a
    ``salt`` that shifts the pool index only so that XLA cannot fold one
    unit into the next; the card caches nothing between replays, so one
    capture of the unit serves every unit, and the salt is gone."""
    from .ops.cuda.graph import CapturedStep

    def unit():
        sums = None
        for i in range(steps):
            got = step(pool[i % len(pool)])
            sums = got if sums is None else tuple(a + b for a, b in zip(sums, got))
        return sums

    if pool.device.type == "cuda":
        unit = CapturedStep(unit, (), pool.device)
    unit()  # warm
    ts = []
    for _ in range(UNITS):
        t0 = time.perf_counter()
        sums = [int(v) for v in unit()]  # the unit's one sync
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) / steps, sums


def device_cases(size: int, steps: int, device="cuda"):
    """The dense hash stage, then the pipeline cases, on ``device``."""
    from .api import _device
    from .ops.pipeline import kminmer_pipeline

    device = _device(device)
    name, power_limit = card(device)
    B, L = batch_shape(size)
    pool = make_pool(B, L, device)
    lengths = torch.full((B,), L, dtype=torch.int32, device=device)

    def row(case, step, extra=None):
        dt = timed_units(lambda codes: (step(codes),), pool, steps)[0]
        return {
            "case": case,
            "value": B * L / dt / 1e9,
            "unit": "GB/s",
            "step_ms": dt * 1e3,
            "batch": [B, L],
            "steps_per_sync": steps,
            "backend": name,
            "power_limit": power_limit,
            **(extra or {}),
        }

    yield row("nthash32_dense_l31", lambda codes: dense_hash(codes).sum())
    for case, spec in pipeline_cases(L):
        yield row(
            case,
            lambda codes, spec=spec: checksum(kminmer_pipeline(codes, lengths, spec)),
            {"l": spec.l, "k": spec.k, "density": spec.density, "mode": spec.mode,
             "hash_width": spec.hash_width, "variant": spec.variant,
             "m_cap": spec.max_minimizers},
        )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=32 << 20)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--host-size", type=int, default=10_000)
    ap.add_argument("--skip-device", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for rec in host_cases(args.host_size):
        print(json.dumps(rec), flush=True)
    if not args.skip_device:
        for rec in device_cases(args.size, args.steps, args.device):
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
