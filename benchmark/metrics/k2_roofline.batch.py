"""K2, the slot compaction (csrc/slot_compact.cu): its two kernels.
Its share of the roofline: 100 x its least time on the traced calls'
inputs (``benchmark/roofline.py``) / its device time, in %.
Kernels are matched by their full demangled names."""

from benchmark.readers import roofline

KERNELS = (
    "(anonymous namespace)::slot_compact_offsets_kernel(int const*, int const*, int, int*, "
    "int*, int*, int*, int, int, int)",
    "(anonymous namespace)::slot_compact_copy_kernel(int const*, int const*, int const*, "
    "int const*, int const*, int*, int*, int*, int*, int, int, int, int)",
)


def read(run):
    return roofline(run, "k2_bound_s", KERNELS)
