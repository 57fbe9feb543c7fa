"""Fresh-seed differential burn-in: ``kminmers_list`` on a device (on a
GPU, the CUDA kernels) against ``kminmers_list(..., backend="oracle")``,
the numpy oracle, on randomly drawn configurations and sequences; the
counterpart of ``scripts/burnin_onchip.py``.

    python rust_seq2kminmers_torch/scripts/burnin.py [--configs N] [--seqs M]
        [--seed S] [--variant nthash1|nthash2] [--device cuda|cpu] [--general N]

Each run draws a new session seed (printed first; ``--seed`` replays it),
so every invocation checks fresh inputs.  A configuration draws its mode,
its width and variant, l (in [2, 32) for simd and regular nthash1, [2,
100) for hpc, [2, 64) for nthash2), k in [2, 9) and d in {0.01, 0.05,
0.1}; its sequences cycle through five alphabets (ACGT; ACGT with N;
mixed case; garbage bytes; homopolymer bombs) at lengths from max(l + 1,
64) to 6000.  Those configurations take the fused route (2 <= l <= 255).
``--general N`` appends N on the general route, in turns: regular l = 1,
hpc nthash1 at l in [256, 400] (``strict_limits=False``), nthash2 at l in
[256, 400] in any mode.  Records are compared on (hash, start, end,
offset, rev); the first difference raises with its configuration,
alphabet, length and seed.  The last line says PASS with the counts and
the device (on a GPU, its name and power limit).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np

MODES = ["regular", "simd", "hpc", "hpcsimd"]
ALPHABETS = ["acgt", "acgtn", "case", "garbage", "homo"]


def gen_seq(rng, kind: str, n: int) -> str:
    """n characters of one of the five alphabets."""
    if kind == "acgt":
        return "".join(rng.choice(list("ACGT"), size=n))
    if kind == "acgtn":
        return "".join(rng.choice(list("ACGTN"), size=n, p=[0.24, 0.24, 0.24, 0.24, 0.04]))
    if kind == "case":
        return "".join(rng.choice(list("ACGTacgtNn"), size=n))
    if kind == "garbage":
        return "".join(rng.choice(list("ACGTacgtNnXY@z*-"), size=n))
    # homopolymer bombs: runs of geometric length
    out = []
    while sum(map(len, out)) < n:
        out.append(str(rng.choice(list("ACGTN"))) * int(rng.geometric(0.25)))
    return "".join(out)[:n]


def draw_fused(rng, variant=None):
    """(mode, hash_width, variant, l) of a fused-route configuration, drawn
    as the reference package's burn-in draws it."""
    mode = str(rng.choice(["regular", "hpc"] if variant == "nthash2" else MODES))
    if mode in ("simd", "hpcsimd"):
        return mode, 32, "nthash1", int(rng.integers(2, 32))
    variant = variant or str(rng.choice(["nthash1", "nthash1", "nthash2"]))
    width = 32 if variant == "nthash2" else int(rng.choice([16, 32, 64]))
    if variant == "nthash2":
        l = int(rng.integers(2, 64))
    else:
        l = int(rng.integers(2, 32 if mode == "regular" else 100))
    return mode, width, variant, l


def draw_general(rng, turn: int, variant=None):
    """(mode, hash_width, variant, l) of the general-route configuration
    of this turn: regular l = 1, hpc nthash1 l > 255, nthash2 l > 255."""
    kinds = {None: (0, 1, 2), "nthash1": (0, 1), "nthash2": (2,)}[variant]
    kind = kinds[turn % len(kinds)]
    if kind == 0:
        return "regular", int(rng.choice([16, 32, 64])), "nthash1", 1
    if kind == 1:
        return "hpc", int(rng.choice([16, 32, 64])), "nthash1", int(rng.integers(256, 401))
    return str(rng.choice(MODES)), 32, "nthash2", int(rng.integers(256, 401))


def _fields(records):
    return [(r.hash, r.start, r.end, r.offset, r.rev) for r in records]


def run(configs=12, seqs=6, seed=None, variant=None, device="cuda", general=0, log=print):
    """Draw and check ``configs`` fused-route and ``general`` general-route
    configurations of ``seqs`` sequences each -> counts: sequences,
    k-min-mers, and sequences by route ("fused", "general", and
    "general_hpc", those of them in an hpc mode)."""
    from rust_seq2kminmers_torch import api
    from rust_seq2kminmers_torch.bench_suite import card
    from rust_seq2kminmers_torch.ops.pipeline import PipelineSpec

    device = api._device(device)
    if seed is None:
        seed = int.from_bytes(os.urandom(4), "little")
    log(f"session seed: {seed}  (replay with --seed {seed})")
    rng = np.random.default_rng(seed)
    counts = {"sequences": 0, "kminmers": 0, "fused": 0, "general": 0, "general_hpc": 0}
    t0 = time.perf_counter()
    for c in range(configs + general):
        on_general = c >= configs
        if on_general:
            mode, width, var, l = draw_general(rng, c - configs, variant)
        else:
            mode, width, var, l = draw_fused(rng, variant)
        k = int(rng.integers(2, 9))
        d = float(rng.choice([0.01, 0.05, 0.1]))
        spec = PipelineSpec(l=l, k=k, density=d, mode=mode, hash_width=width, variant=var)
        route = "fused" if spec.fused else "general"
        label = f"[{c}] {mode}/{var}/u{width} l={l} k={k} d={d} ({route} route)"
        kw = dict(strict_limits=not on_general, hash_width=width, variant=var)
        for s in range(seqs):
            kind = ALPHABETS[s % len(ALPHABETS)]
            n = int(rng.integers(max(l + 1, 64), 6000))
            seq = gen_seq(rng, kind, n)
            got = _fields(api.kminmers_list(seq, l, k, d, mode, device, **kw))
            want = _fields(api.kminmers_list(seq, l, k, d, mode, backend="oracle", **kw))
            if got != want:
                i = next((i for i, (g, w) in enumerate(zip(got, want)) if g != w),
                         min(len(got), len(want)))
                raise RuntimeError(
                    f"burn-in mismatch {label}, alphabet {kind}, length {n}, seed {seed}: "
                    f"{len(got)} records against the oracle's {len(want)}; first "
                    f"difference at record {i}: {got[i:i + 1]} against {want[i:i + 1]}")
            counts["sequences"] += 1
            counts["kminmers"] += len(got)
            counts[route] += 1
            counts["general_hpc"] += route == "general" and spec.is_hpc
        log(f"{label}: ok ({seqs} seqs)")
    name, power_limit = card(device)
    where = name if power_limit is None else f"{name}, {power_limit}"
    counts["seconds"] = time.perf_counter() - t0
    log(f"BURN-IN PASS: {counts['sequences']} sequences across {configs + general} random "
        f"configs ({general} on the general route; {counts['general']} sequences there, "
        f"{counts['general_hpc']} in an hpc mode), {counts['kminmers']} k-min-mers "
        f"record-exact vs the oracle on {where} in {counts['seconds']:.1f} s "
        f"(seed {seed})")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", type=int, default=12)
    ap.add_argument("--seqs", type=int, default=6)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--variant", default=None, choices=["nthash1", "nthash2"],
                    help="pin the hash variant for non-SIMD configs")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--general", type=int, default=0,
                    help="general-route configs to append (l = 1 or l > 255)")
    args = ap.parse_args(argv)
    run(args.configs, args.seqs, args.seed, args.variant, args.device, args.general)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    sys.exit(main())
