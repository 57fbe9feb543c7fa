// Xcode encoding of raw sequence bytes on the device: row b of a chunk holds
// length_local[b] bytes of one read, and each becomes
//   table[byte] | (byte != byte before ? 8 : 0),
// with XCODE_PAD past length_local[b].  The byte before column 0 is
// prev[b]: the read's byte before the chunk, or -1 where the chunk starts
// the read (its first byte is always kept).  A row with prev[b] == -2
// already holds xcodes and is copied, padded past its length.  The plain
// version is ops/xcode.py:encode_xcodes_plain.
//
// Replaces: no TPU kernel.  The reference package encodes on the host
// (rust_seq2kminmers_tpu/io/native/rle_kernels.h:368-409, xcode_dispatch,
// AVX-512) and ships xcodes; the port ships the raw bytes a producer thread
// copies at the same cost, and encodes them here.
//
// Bound on this card: bytes, 2 a base (one read, one write): 0.020 ms at
// [32, 2^20] and at [1, 2^25] at 3.35 TB/s.  One thread owns 16
// consecutive bytes, read and written with one 16-byte access each, so a
// warp moves 512 contiguous bytes.  The 256-byte table is copied into
// shared memory once a block (ACGT hit three distinct banks: no conflict).
// A thread's byte before its first byte is its left neighbour's last, by
// __shfl_up_sync; lane 0 loads it (the only extra load, 1 byte a warp), or
// takes prev[b] in column 0.  Rows whose length is not a multiple of 16, or
// that do not start on a 16-byte boundary, take byte accesses.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // == the table's entries: one load a thread
constexpr int BYTES = 16;     // a thread's bytes
constexpr int BLOCK_BYTES = THREADS * BYTES;
constexpr uint32_t KEEP = 8;
constexpr uint32_t PAD = 8 | 6;  // XCODE_PAD
constexpr int XCODE_ROW = -2;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    xcode_kernel(const uint8_t* __restrict__ raw, const int32_t* __restrict__ prev,
                 const int32_t* __restrict__ length_local, const uint8_t* __restrict__ table,
                 uint8_t* __restrict__ out, int C) {
  __shared__ uint8_t s_table[256];
  s_table[threadIdx.x] = table[threadIdx.x];
  const int b = blockIdx.y;
  const uint8_t* row = raw + (size_t)b * C;
  uint8_t* orow = out + (size_t)b * C;
  const int j0 = (blockIdx.x * THREADS + threadIdx.x) * BYTES;
  const bool live = j0 < C;  // every thread reaches the shuffle below
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (live) {
    if (VEC) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + j0);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < BYTES; ++k)
        if (j0 + k < C) w[k >> 2] |= (uint32_t)row[j0 + k] << ((k & 3) * 8);
    }
  }
  int before = (int)(w[3] >> 24);  // this thread's last byte, for lane + 1
  before = __shfl_up_sync(s2k::FULL, before, 1);
  const int p0 = prev[b];
  if ((threadIdx.x & 31) == 0 && live) before = j0 == 0 ? p0 : (int)row[j0 - 1];
  __syncthreads();  // the table
  if (!live) return;
  const int len = length_local[b];
  const bool copy = p0 == XCODE_ROW;
  uint32_t o[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = (int)((w[q] >> (8 * i)) & 0xFFu);
      uint32_t y = copy ? (uint32_t)c : (uint32_t)s_table[c] | (c != before ? KEEP : 0u);
      if (j0 + q * 4 + i >= len) y = PAD;
      word |= y << (8 * i);
      before = c;
    }
    o[q] = word;
  }
  if (VEC) {
    *reinterpret_cast<uint4*>(orow + j0) = make_uint4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int k = 0; k < BYTES; ++k)
      if (j0 + k < C) orow[j0 + k] = (uint8_t)(o[k >> 2] >> ((k & 3) * 8));
  }
}

}  // namespace

// raw, out: uint8[B, C]; prev, length_local: int32[B]; table: uint8[256].
extern "C" int s2k_xcode(const void* raw, const void* prev, const void* length_local,
                         const void* table, void* out, int B, int C, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || C > (1 << 30)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((C + BLOCK_BYTES - 1) / BLOCK_BYTES), (unsigned)B);
  const bool vec = C % BYTES == 0 && ((uintptr_t)raw | (uintptr_t)out) % BYTES == 0;
  auto* r = (const uint8_t*)raw;
  auto* pv = (const int32_t*)prev;
  auto* ln = (const int32_t*)length_local;
  auto* t = (const uint8_t*)table;
  auto* o = (uint8_t*)out;
  if (vec)
    xcode_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(r, pv, ln, t, o, C);
  else
    xcode_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(r, pv, ln, t, o, C);
  return (int)cudaGetLastError();
}
