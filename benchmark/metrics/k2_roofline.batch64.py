"""K2, the slot compaction (csrc/slot_compact.cu), with the high hash
column it copies at 64-bit minimizer hashes: its two kernels.
Its share of the roofline: 100 x its least time on the traced calls'
inputs (``k2_bound64_s`` in ``benchmark/drivers/resident_batches64.py``)
/ its device time, in %.
Kernels are matched by their full demangled names."""

from benchmark.readers import roofline

KERNELS = (
    "(anonymous namespace)::slot_compact_offsets_kernel(int const*, int const*, int, int*, "
    "int*, int*, int*, int, int, int)",
    "(anonymous namespace)::slot_compact_copy_kernel(int const*, int const*, int const*, "
    "int const*, int const*, int*, int*, int*, int*, int, int, int, int)",
)


def read(run):
    return roofline(run, "k2_bound64_s", KERNELS)
