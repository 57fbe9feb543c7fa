"""rust_seq2kminmers_torch: the k-min-mer sketching engine on PyTorch and
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``rust_seq2kminmers_tpu`` (the JAX reference, which stays
beside it): DNA reads -> ordered streams of k-min-mers.  It imports
neither jax nor the reference package.  CUDA tensors run the kernels in
``csrc/``; CPU tensors run their plain PyTorch versions.
"""

from .api import KminmerRecord, KminmersIterator, KSizeTooBig, kminmers_list
from .ops.long_read import kminmers_long, kminmers_long_batch
from .ops.pipeline import KminmerBatch, PipelineSpec, kminmer_pipeline

__all__ = [
    "KminmerBatch",
    "KminmerRecord",
    "KminmersIterator",
    "KSizeTooBig",
    "PipelineSpec",
    "kminmer_pipeline",
    "kminmers_list",
    "kminmers_long",
    "kminmers_long_batch",
]
