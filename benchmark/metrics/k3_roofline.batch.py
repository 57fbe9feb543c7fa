"""K3, the assembly (csrc/assemble.cu): assemble_kernel.
Its share of the roofline: 100 x its least time on the traced calls'
inputs (``benchmark/roofline.py``) / its device time, in %.
Kernels are matched by their full demangled names."""

from benchmark.readers import roofline

KERNELS = (
    "void (anonymous namespace)::assemble_kernel<32>((anonymous namespace)::Args)",
)


def read(run):
    return roofline(run, "k3_bound_s", KERNELS)
