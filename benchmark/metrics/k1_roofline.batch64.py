"""K1, the fused scan (csrc/fused_scan.cu), at 64-bit minimizer hashes: its
three kernels, the scan's width-64 instance among them.
Its share of the roofline: 100 x its least time on the traced calls'
inputs (``benchmark/roofline.py``, which counts 16 bytes a survivor at
width 64) / its device time, in %.
Kernels are matched by their full demangled names."""

from benchmark.readers import roofline

KERNELS = (
    "void (anonymous namespace)::scan_kernel<s2k::H64>(unsigned char const*, int const*, "
    "int const*, s2k::H64::T const*, int const*, int const*, int*, int*, int*, int*, int*, "
    "int, int, s2k::H64::T, int, int, int, int, int, int)",
    "(anonymous namespace)::tile_summary_kernel(unsigned char const*, int const*, int*, "
    "int*, int, int, int, int, int)",
    "(anonymous namespace)::tile_carries_kernel(int const*, int const*, int const*, "
    "int const*, int*, int*, int*, int, int, int)",
)


def read(run):
    return roofline(run, "k1_bound_s", KERNELS)
