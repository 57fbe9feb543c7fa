// Helpers shared by the port's kernels: rotates, the hash widths, 16-byte
// loads at any alignment, and block-wide and row-wide scans.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace s2k {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t rol32(uint32_t x, uint32_t r) {
  return __funnelshift_l(x, x, r & 31u);
}

__device__ __forceinline__ uint64_t rol64(uint64_t x, uint32_t r) {
  r &= 63u;
  return (x << r) | (x >> ((64u - r) & 63u));
}

// A hash width: its value type, rotate (the amount taken mod the width),
// the amount that rotates by -r, and for a walk over consecutive positions
// W with red(x) = x mod W and rolr, a rotate by an amount already below W.
// K1 and the general scan share them.
struct H32 {
  using T = uint32_t;
  static constexpr uint32_t W = 32;
  __device__ static T rol(T x, uint32_t r) { return rol32(x, r); }
  __device__ static uint32_t neg(uint32_t r) { return 0u - r; }
  __device__ static uint32_t red(uint32_t x) { return x & 31u; }
  __device__ static T rolr(T x, uint32_t r) { return rol32(x, r); }
};

struct H16 {  // values below 2^16 in 32-bit lanes
  using T = uint32_t;
  static constexpr uint32_t W = 16;
  __device__ static T rol(T x, uint32_t r) { return rolr(x, r & 15u); }
  __device__ static uint32_t neg(uint32_t r) { return 0u - r; }
  __device__ static uint32_t red(uint32_t x) { return x & 15u; }
  __device__ static T rolr(T x, uint32_t r) {  // x >> 16 is 0 at r = 0: x < 2^16
    return ((x << r) | (x >> (16u - r))) & 0xFFFFu;
  }
};

struct H31 {  // NtHash2-hybrid: values below 2^31, rotates mod 31
  using T = uint32_t;
  static constexpr uint32_t W = 31;
  __device__ static T rol(T x, uint32_t r) { return rolr(x, r % 31u); }
  __device__ static uint32_t neg(uint32_t r) { return (31u - r % 31u) % 31u; }
  __device__ static uint32_t red(uint32_t x) { return x % 31u; }
  __device__ static T rolr(T x, uint32_t r) {  // x >> 31 is 0 at r = 0: x < 2^31
    return ((x << r) | (x >> (31u - r))) & 0x7FFFFFFFu;
  }
};

struct H64 {
  using T = uint64_t;
  static constexpr uint32_t W = 64;
  __device__ static T rol(T x, uint32_t r) { return rol64(x, r); }
  __device__ static uint32_t neg(uint32_t r) { return 0u - r; }
  __device__ static uint32_t red(uint32_t x) { return x & 63u; }
  __device__ static T rolr(T x, uint32_t r) { return rol64(x, r); }
};

// Byte x of a 16-byte chunk.
__device__ __forceinline__ uint32_t byte_of(const uint4& v, int x) {
  const uint32_t w = x < 8 ? (x < 4 ? v.x : v.y) : (x < 12 ? v.z : v.w);
  return (w >> ((x & 3) * 8)) & 0xFFu;
}

__device__ __forceinline__ int misalign(const void* p) {
  return (int)((uintptr_t)p & 15u);
}

// Bytes [s, s + 16) of the 32 bytes v0, v1 (0 <= s < 16).
__device__ __forceinline__ uint4 bytes_at(uint4 v0, uint4 v1, int s) {
  uint32_t w0 = v0.x, w1 = v0.y, w2 = v0.z, w3 = v0.w;
  uint32_t w4 = v1.x, w5 = v1.y, w6 = v1.z, w7 = v1.w;
  if (s & 8) { w0 = w2; w1 = w3; w2 = w4; w3 = w5; w4 = w6; w5 = w7; }
  if (s & 4) { w0 = w1; w1 = w2; w2 = w3; w3 = w4; w4 = w5; }
  const uint32_t sh = (s & 3) * 8;
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                    __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

// The 16 bytes at p, at any alignment, by loads of the aligned 16-byte
// chunks that hold them.  Each such chunk shares a byte with [p, p + 16),
// so no load leaves the pages those bytes lie in.
__device__ __forceinline__ uint4 load16(const uint8_t* p) {
  const int s = misalign(p);
  const uint4* a = reinterpret_cast<const uint4*>(p - s);
  return s == 0 ? a[0] : bytes_at(a[0], a[1], s);
}

// Inclusive XOR scan over the warp's lanes.
template <typename T>
__device__ __forceinline__ T warp_xor_scan(T v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v ^= u;
  }
  return v;
}

// The XOR of w[0 .. n), n <= 32, in every lane.
template <typename T>
__device__ __forceinline__ T xor_below(const T* w, int lane, int n) {
  const T v = lane < n ? w[lane] : 0;
  if constexpr (sizeof(T) == 8) {
    return (uint64_t)__reduce_xor_sync(FULL, (unsigned)(v >> 32)) << 32 |
           __reduce_xor_sync(FULL, (unsigned)v);
  } else {
    return __reduce_xor_sync(FULL, v);
  }
}

// Exclusive rank of `pred` among the block's threads, in thread order.
// Every thread of the block calls it.  `warp_tot` is a __shared__ int[32]
// that no thread may touch again before the next __syncthreads().  The
// block's count of true predicates goes to *total.
template <int NT>
__device__ __forceinline__ int block_rank(bool pred, int* warp_tot,
                                          int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(FULL, pred);
  const int rank = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_tot[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int v = lane < NT / 32 ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, v, o);
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
    const int u = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < NT / 32 ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += u;
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  *total = warp_tot[NT / 32 - 1];
  return inc - v + (warp ? warp_tot[warp - 1] : 0);
}

// One block's exclusive scan of a row's nt counts, NT at a time: off[t] =
// count(0) + ... + count(t - 1); -> the row's total.  count(t) is called
// once for each t < nt.  Every thread of the block calls it; `warp_tot` as
// for block_rank.
template <int NT, typename Count>
__device__ __forceinline__ int row_exclusive_scan(Count count, int32_t* off, int nt,
                                                  int* warp_tot) {
  int running = 0;
  for (int t0 = 0; t0 < nt; t0 += NT) {
    const int t = t0 + (int)threadIdx.x;
    const int c = t < nt ? count(t) : 0;
    int total;
    const int pre = block_exclusive_sum<NT>(c, warp_tot, &total);
    if (t < nt) off[t] = running + pre;
    running += total;
    __syncthreads();  // warp_tot is read above before the next round writes it
  }
  return running;
}

// Writes v to p[lo, hi): 16-byte stores between the unaligned ends.
// Every thread of the block calls it with the same range.
template <typename T>
__device__ __forceinline__ void fill_range(T* p, int lo, int hi, T v) {
  constexpr int V = 16 / sizeof(T);  // values a 16-byte store
  int a = lo;
  while (a < hi && misalign(p + a) != 0) ++a;  // first aligned slot
  const int head = min(a, hi);
  for (int d = lo + (int)threadIdx.x; d < head; d += blockDim.x) p[d] = v;
  const int nvec = (hi - head) / V;
  union { T s[V]; uint4 q; } u;
#pragma unroll
  for (int x = 0; x < V; ++x) u.s[x] = v;
  uint4* q = reinterpret_cast<uint4*>(p + head);
  for (int x = threadIdx.x; x < nvec; x += blockDim.x) q[x] = u.q;
  for (int d = head + nvec * V + (int)threadIdx.x; d < hi; d += blockDim.x) p[d] = v;
}

}  // namespace s2k
