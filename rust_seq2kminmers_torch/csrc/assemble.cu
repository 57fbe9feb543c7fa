// K3, k-min-mer assembly: xorshift mix of each u32 minimizer hash to u64,
// then per k-window the canonical minimizer-space NtHash
//   f = XOR_q rol64(m_{w+q}, k-1-q),  r = XOR_q rol64(m_{w+q}, q),
//   hash = min(f, r),  rev = r < f
// (the rotate-by-rank form of the TPU kernel, with the window's own rank
// folded in).
//
// Replaces: rust_seq2kminmers_tpu/ops/pallas/assemble_kernel.py:
// _assemble_kernel (wrapper assemble_kminmers_pallas).  The TPU emulated
// u64 as (hi, lo) int32 pairs and fell back to XLA above 32768 slots; here
// it is native uint64_t with no size limit.
//
// Bound on this card: bytes.  One thread per (read, window) reads k
// neighbouring u32 (served by L1 after the first) and writes 9 bytes; the
// k mixes and rotates per window are a few dozen integer operations.
// Windows past a row's count - k + 1 are computed like any other and
// masked by the caller.

#include "common.cuh"

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT) assemble_kernel(
    const int32_t* __restrict__ min_hash, int32_t* __restrict__ out_hi,
    int32_t* __restrict__ out_lo, uint8_t* __restrict__ out_rev, int M,
    int k, int nwin) {
  const int w = blockIdx.x * NT + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= nwin) return;
  const int32_t* row = min_hash + (size_t)b * M + w;
  uint64_t f = 0, r = 0;
  for (int q = 0; q < k; ++q) {
    uint64_t x = (uint32_t)row[q];
    x ^= x << 13;
    x ^= x >> 7;
    x ^= x << 17;
    f ^= s2k::rol64(x, (uint32_t)(k - 1 - q));
    r ^= s2k::rol64(x, (uint32_t)q);
  }
  const bool rev = r < f;
  const uint64_t h = rev ? r : f;
  const size_t o = (size_t)b * nwin + w;
  out_hi[o] = (int32_t)(uint32_t)(h >> 32);
  out_lo[o] = (int32_t)(uint32_t)h;
  out_rev[o] = rev;
}

}  // namespace

extern "C" int s2k_assemble(const void* min_hash, void* out_hi, void* out_lo,
                            void* out_rev, int B, int M, int k,
                            void* stream) {
  const int nwin = M - k + 1;
  const dim3 grid((nwin + NT - 1) / NT, B);
  assemble_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const int32_t*)min_hash, (int32_t*)out_hi, (int32_t*)out_lo,
      (uint8_t*)out_rev, M, k, nwin);
  return (int)cudaGetLastError();
}

extern "C" const char* s2k_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
