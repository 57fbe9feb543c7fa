// K3, k-min-mer assembly: mix of each minimizer hash to u64 (xorshift of a
// u32, murmur of a u16, identity of a u64 given as (hi, lo) words), then
// per k-window the canonical minimizer-space NtHash
//   f = XOR_q rol64(m_{w+q}, k-1-q),  r = XOR_q rol64(m_{w+q}, q),
//   hash = min(f, r),  rev = r < f
// (the rotate-by-rank form of the TPU kernel, with the window's own rank
// folded in).
//
// Replaces: rust_seq2kminmers_tpu/ops/pallas/assemble_kernel.py:
// _assemble_kernel (wrapper assemble_kminmers_pallas), which takes the
// xorshift mix only; the reference package runs the u16 and u64 mixes in
// XLA (ops/pipeline.py:448-470).  The TPU emulated u64 as (hi, lo) int32
// pairs and fell back to XLA above 32768 slots; here it is native uint64_t
// with no size limit, and the mix is a template parameter.
//
// Bound on this card: bytes.  One thread per (read, window) reads k
// neighbouring words (served by L1 after the first) and writes 9 bytes;
// the k mixes and rotates per window are a few dozen integer operations
// (two 64-bit multiplies each for murmur).  Windows past a row's count -
// k + 1 are computed like any other and masked by the caller.

#include "common.cuh"

namespace {

constexpr int NT = 256;

template <int WIDTH>
__device__ __forceinline__ uint64_t mix(const int32_t* lo, const int32_t* hi,
                                        int q) {
  if constexpr (WIDTH == 64) {
    return ((uint64_t)(uint32_t)hi[q] << 32) | (uint32_t)lo[q];
  } else if constexpr (WIDTH == 16) {
    uint64_t x = (uint32_t)lo[q] & 0xFFFFu;
    x ^= s2k::rol64(x, 33);
    x *= 0xFF51AFD7ED558CCDull;
    x ^= s2k::rol64(x, 33);
    x *= 0xC4CEB9FE1A85EC53ull;
    return x ^ s2k::rol64(x, 33);
  } else {
    uint64_t x = (uint32_t)lo[q];
    x ^= x << 13;
    x ^= x >> 7;
    x ^= x << 17;
    return x;
  }
}

template <int WIDTH>
__global__ void __launch_bounds__(NT) assemble_kernel(
    const int32_t* __restrict__ min_hash,
    const int32_t* __restrict__ min_hash_hi, int32_t* __restrict__ out_hi,
    int32_t* __restrict__ out_lo, uint8_t* __restrict__ out_rev, int M,
    int k, int nwin) {
  const int w = blockIdx.x * NT + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= nwin) return;
  const size_t row = (size_t)b * M + w;
  const int32_t* lo = min_hash + row;
  const int32_t* hi = min_hash_hi + row;
  uint64_t f = 0, r = 0;
  for (int q = 0; q < k; ++q) {
    const uint64_t x = mix<WIDTH>(lo, hi, q);
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

template <int WIDTH>
void launch(const void* min_hash, const void* min_hash_hi, void* out_hi,
            void* out_lo, void* out_rev, int B, int M, int k,
            cudaStream_t stream) {
  const int nwin = M - k + 1;
  const dim3 grid((nwin + NT - 1) / NT, B);
  assemble_kernel<WIDTH><<<grid, NT, 0, stream>>>(
      (const int32_t*)min_hash, (const int32_t*)min_hash_hi,
      (int32_t*)out_hi, (int32_t*)out_lo, (uint8_t*)out_rev, M, k, nwin);
}

}  // namespace

// min_hash_hi is read only at hash_width 64.
extern "C" int s2k_assemble(const void* min_hash, const void* min_hash_hi,
                            void* out_hi, void* out_lo, void* out_rev, int B,
                            int M, int k, int hash_width, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (hash_width) {
    case 16:
      launch<16>(min_hash, min_hash_hi, out_hi, out_lo, out_rev, B, M, k, s);
      break;
    case 32:
      launch<32>(min_hash, min_hash_hi, out_hi, out_lo, out_rev, B, M, k, s);
      break;
    case 64:
      launch<64>(min_hash, min_hash_hi, out_hi, out_lo, out_rev, B, M, k, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* s2k_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
