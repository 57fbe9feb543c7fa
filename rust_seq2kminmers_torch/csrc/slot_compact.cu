// K2, slot compaction: stitches K1's per-tile survivor rows into one
// ordered [B, m] minimizer stream per read.
//
// Replaces: rust_seq2kminmers_tpu/ops/pallas/slot_compact.py:
// _slot_compact_kernel (wrapper slot_compact), phase 2 of the pipeline.
// The TPU left-packed a slot-validity mask with a bit-decomposed move over
// the whole row; here the tile offsets are an exclusive scan of the kept
// counts, and each tile's kept prefix is a plain copy to its offset.
//
// Bound on this card: bytes.  It reads the kept survivors (3 int32 each,
// ~1% of bases) plus nt counts per read and writes m slots per column, so
// at the main-path shape it moves a few MB and is dominated by its launch.
// One block per read scans the counts in chunks of NT tiles in shared
// memory; its warps then copy one tile each.  Slots past the total (or
// past m) are written as zeros; survivors past m are dropped and show as
// n_slotted > m.

#include "common.cuh"

namespace {

constexpr int NT = 1024;
constexpr int NWARPS = NT / 32;

__global__ void __launch_bounds__(NT) slot_compact_kernel(
    const int32_t* __restrict__ in_start, const int32_t* __restrict__ in_end,
    const int32_t* __restrict__ in_hash, const int32_t* __restrict__ kept,
    int32_t* __restrict__ out_start, int32_t* __restrict__ out_end,
    int32_t* __restrict__ out_hash, int32_t* __restrict__ n_slotted, int nt,
    int cap, int m) {
  __shared__ int s_off[NT], s_cnt[NT];
  __shared__ int s_tot[32];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t ob = (size_t)b * m;
  int running = 0;
  for (int t0 = 0; t0 < nt; t0 += NT) {
    const int t = t0 + tid;
    const int c = t < nt ? min(max(kept[(size_t)b * nt + t], 0), cap) : 0;
    int total;
    const int pre = s2k::block_exclusive_sum<NT>(c, s_tot, &total);
    s_off[tid] = running + pre;
    s_cnt[tid] = c;
    __syncthreads();
    const int n_here = min(NT, nt - t0);
    for (int q = warp; q < n_here; q += NWARPS) {
      const size_t src = ((size_t)b * nt + t0 + q) * cap;
      const int off = s_off[q], n = s_cnt[q];
      for (int e = lane; e < n && off + e < m; e += 32) {
        out_start[ob + off + e] = in_start[src + e];
        out_end[ob + off + e] = in_end[src + e];
        out_hash[ob + off + e] = in_hash[src + e];
      }
    }
    running += total;
    __syncthreads();
  }
  for (int d = min(running, m) + tid; d < m; d += NT) {
    out_start[ob + d] = 0;
    out_end[ob + d] = 0;
    out_hash[ob + d] = 0;
  }
  if (tid == 0) n_slotted[b] = running;
}

}  // namespace

extern "C" int s2k_slot_compact(const void* in_start, const void* in_end,
                                const void* in_hash, const void* kept,
                                void* out_start, void* out_end,
                                void* out_hash, void* n_slotted, int B,
                                int nt, int cap, int m, void* stream) {
  slot_compact_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(
      (const int32_t*)in_start, (const int32_t*)in_end,
      (const int32_t*)in_hash, (const int32_t*)kept, (int32_t*)out_start,
      (int32_t*)out_end, (int32_t*)out_hash, (int32_t*)n_slotted, nt, cap, m);
  return (int)cudaGetLastError();
}
