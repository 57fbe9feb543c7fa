// Helpers shared by the port's kernels: rotates and block-wide scans.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace s2k {

__device__ __forceinline__ uint32_t rol32(uint32_t x, uint32_t r) {
  return __funnelshift_l(x, x, r & 31u);
}

__device__ __forceinline__ uint64_t rol64(uint64_t x, uint32_t r) {
  r &= 63u;
  return (x << r) | (x >> ((64u - r) & 63u));
}

// Exclusive rank of `pred` among the block's threads, in thread order.
// Every thread of the block calls it.  `warp_tot` is a __shared__ int[32]
// that no thread may touch again before the next __syncthreads().  The
// block's count of true predicates goes to *total.
template <int NT>
__device__ __forceinline__ int block_rank(bool pred, int* warp_tot,
                                          int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, pred);
  const int rank = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_tot[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int v = lane < NT / 32 ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    warp_tot[lane] = v;  // inclusive prefix over warps
  }
  __syncthreads();
  *total = warp_tot[NT / 32 - 1];
  return rank + (warp ? warp_tot[warp - 1] : 0);
}

// Exclusive prefix sum of v over the block's threads; same contract as
// block_rank.
template <int NT>
__device__ __forceinline__ int block_exclusive_sum(int v, int* warp_tot,
                                                   int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < NT / 32 ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  *total = warp_tot[NT / 32 - 1];
  return inc - v + (warp ? warp_tot[warp - 1] : 0);
}

}  // namespace s2k
