"""K3, the assembly (csrc/assemble.cu), at 64-bit minimizer hashes:
assemble_kernel<64>, the identity mix.
Its share of the roofline: 100 x its least time on the traced calls'
inputs (``k3_bound64_s`` in ``benchmark/drivers/resident_batches64.py``)
/ its device time, in %.
Kernels are matched by their full demangled names."""

from benchmark.readers import roofline

KERNELS = (
    "void (anonymous namespace)::assemble_kernel<64>((anonymous namespace)::Args)",
)


def read(run):
    return roofline(run, "k3_bound64_s", KERNELS)
