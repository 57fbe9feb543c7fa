"""The command line, as the reference crate's binary (src/main.rs).

    python -m rust_seq2kminmers_torch [--device cpu]
        the demo: a fixed string's HPC forms and its k-min-mers in the four
        modes (src/main.rs:13-47: l=28, k=5, d=0.1);
    python -m rust_seq2kminmers_torch FILE [threads] [--device cpu] ...
        every record of a FASTA/FASTQ file through the streaming runner
        (src/main.rs:53-60 defaults: l=31, k=5, d=0.01, regular); prints
        the count and the wall time.  ``threads`` is the native packer's
        thread count (0: all cores).

The device is the GPU unless ``--device cpu`` asks for the plain versions.
"""

from __future__ import annotations

import argparse
import os
import sys

DEMO_SEQ = (
    "AACTGCACTGCACTGCACTGCACACTGCACTGCACTGCACTGCACACTGCACTGCACTG"
    "ACTGCACTGCACTGCACTGCACTGCCTGC"
)


def demo(device="cuda"):
    from .api import kminmers_list
    from .hpc_strings import encode_rle, hpc

    seq = DEMO_SEQ
    print(f"seq:    {seq!r}")
    print(f"HPC:    {hpc(seq)!r}")
    rle_s, rle_p = encode_rle(seq)
    print(f"encode_rle:({rle_s!r}, {rle_p.tolist()!r})")
    print(
        "Demonstrating how to construct k-min-mers (l=28, k=5, d=0.1) "
        f"out of a test sequence: {seq}"
    )
    for mode in ["regular", "simd", "hpc", "hpcsimd"]:
        print(f"mode: {mode}")
        for km in kminmers_list(seq, 28, 5, 0.1, mode, device=device):
            print(
                f"kminmer: KminmerHash {{ hash: {km.hash}, start: {km.start},"
                f" end: {km.end}, offset: {km.offset}, rev: {km.rev} }}"
            )


def _device_name(device) -> str:
    import torch

    from .api import _device

    device = _device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def run_file(
    filename: str,
    nb_threads: int,
    mode: str = "regular",
    l: int = 31,
    k: int = 5,
    density: float = 0.01,
    out: str | None = None,
    progress: bool = False,
    hash_width: int = 32,
    variant: str = "nthash1",
    device="cuda",
):
    from .io.stream import stream_file
    from .ops.pipeline import PipelineSpec

    print(
        f"Enumerating k-min-mers for the input file {filename} "
        f"({nb_threads} packer threads, device {_device_name(device)})"
    )
    spec = PipelineSpec(
        l=l, k=k, density=density, mode=mode, hash_width=hash_width,
        variant=variant,
    )
    st = stream_file(
        filename, spec, threads=nb_threads, out=out, progress=progress,
        device=device,
    )
    print(
        f"FASTA to kminmers in {st.wall_s:.3f}s: {st.total_kminmers} "
        f"k-min-mers from {st.total_bases} bases over {st.num_records} "
        f"records ({st.total_bases / st.wall_s / 1e9:.3f} GB/s end-to-end; "
        f"{st.batches} batches in {st.buckets} length buckets, "
        f"{st.pack_s:.3f}s host packing overlapped; "
        f"kernel load and graph capture {st.warm_s:.3f}s, first result at "
        f"{st.first_result_s:.3f}s)."
    )
    if out is not None:
        print(f"ordered k-min-mer stream written to {out}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(
        prog="rust_seq2kminmers_torch",
        description="Enumerate k-min-mers of a FASTA/FASTQ file (reference "
        "src/main.rs:53-60 defaults: l=31 k=5 d=0.01 regular); with no file, "
        "the demo.",
    )
    ap.add_argument("fasta", nargs="?", default=None)
    ap.add_argument("nb_threads", nargs="?", type=int, default=0,
                    help="native packer threads (0 = all cores)")
    ap.add_argument("--mode", default="regular",
                    choices=["regular", "simd", "hpc", "hpcsimd"])
    ap.add_argument("-l", type=int, default=31)
    ap.add_argument("-k", type=int, default=5)
    ap.add_argument("-d", "--density", type=float, default=0.01)
    ap.add_argument("-o", "--out", default=None,
                    help="write the ordered stream to this .npz")
    ap.add_argument("--hash-width", type=int, default=32, choices=[16, 32, 64],
                    help="minimizer hash precision (the reference's "
                    "compile-time H, src/lib.rs:30-32)")
    ap.add_argument("--variant", default="nthash1", choices=["nthash1", "nthash2"],
                    help="nthash2 = the 31-bit-rotate hybrid for l > 31")
    ap.add_argument("--progress", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    if args.fasta is None:
        demo(args.device)
        return 0
    if not os.path.exists(args.fasta):
        print(f"error: input file not found: {args.fasta}", file=sys.stderr)
        return 2
    run_file(
        args.fasta, args.nb_threads, mode=args.mode, l=args.l, k=args.k,
        density=args.density, out=args.out, progress=args.progress,
        hash_width=args.hash_width, variant=args.variant, device=args.device,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
