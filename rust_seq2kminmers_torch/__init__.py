"""rust_seq2kminmers_torch: the k-min-mer sketching engine on PyTorch and
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``rust_seq2kminmers_tpu`` (the JAX reference, which stays
beside it): DNA reads -> ordered streams of k-min-mers.  It imports
neither jax nor the reference package.  CUDA tensors run the kernels in
``csrc/``; CPU tensors run their plain PyTorch versions.  Files go through
``io.stream.stream_file`` or ``python -m rust_seq2kminmers_torch``.
"""

from .api import KminmersIterator, KSizeTooBig, kminmers_list
from .constants import encode_bases, hash_bound_simd_u32, hash_bound_u32
from .hpc_strings import encode_rle, encode_rle_simd, hpc
from .kminmer import (
    KminmerVec,
    fxhash32_of_mers,
    fxhash64_of_mers,
    kminmer_hash_from_mers,
    kminmers_vec,
)
from .oracle import HashMode, KminmerRecord, nthash1_minimizer_space
from .ops.long_read import kminmers_long, kminmers_long_batch
from .ops.pipeline import KminmerBatch, PipelineSpec, kminmer_pipeline, make_pipeline

__version__ = "0.1.0"

__all__ = [
    "HashMode",
    "KminmerBatch",
    "KminmerRecord",
    "KminmerVec",
    "KminmersIterator",
    "KSizeTooBig",
    "PipelineSpec",
    "encode_bases",
    "encode_rle",
    "encode_rle_simd",
    "fxhash32_of_mers",
    "fxhash64_of_mers",
    "hash_bound_simd_u32",
    "hash_bound_u32",
    "hpc",
    "kminmer_hash_from_mers",
    "kminmer_pipeline",
    "kminmers_list",
    "kminmers_long",
    "kminmers_long_batch",
    "kminmers_vec",
    "make_pipeline",
    "nthash1_minimizer_space",
]
