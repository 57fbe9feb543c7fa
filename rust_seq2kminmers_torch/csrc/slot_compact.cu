// K2, slot compaction: stitches K1's per-tile survivor rows into one
// ordered [B, m] minimizer stream per read.
//
// Replaces: rust_seq2kminmers_tpu/ops/pallas/slot_compact.py:
// _slot_compact_kernel (wrapper slot_compact), phase 2 of the pipeline,
// with the count glue around it (its caller's clip of the count to m and
// sum of the raw counts, rust_seq2kminmers_tpu/ops/pipeline.py:318,363).
// The TPU left-packed a slot-validity mask with a bit-decomposed move over
// the whole row; here the tile offsets are an exclusive scan of the kept
// counts, and each tile's kept prefix is a plain copy to its offset.
//
// Bound on this card: bytes.  It reads the kept survivors (3 int32 each,
// ~1% of bases) and the tile counts and writes m slots per column.  Two
// launches from one C call:
//   1. offsets, one block per read: an exclusive scan of the tiles' kept
//      counts (clipped to [0, cap]; read at a stride, so K1's [B, nt, 3]
//      counts need no copy) into offsets[b, 0..nt], plus the read's
//      n_slotted (unclipped), n_min = min(n_slotted, m) and n_raw (the sum
//      of the raw counts), each only where its pointer is given;
//   2. copy, grid (nt, B): block (t, b) copies tile t's kept prefix to its
//      offset with all its threads (4-byte loads and stores, coalesced;
//      a tile holds ~1% of its bases, too few for wider accesses to pay),
//      then, with `fill`, zeroes its 1/nt share of the read's slots past
//      min(n_slotted, m) with 16-byte stores between a scalar head and
//      tail.  Survivors past m are dropped and show as n_slotted > m.
// At hash width 64 a fourth column, the hash's high words, rides along;
// its pointers are null otherwise.

#include "common.cuh"

namespace {

constexpr int NT_OFF = 512;  // threads of the offsets block (one a read)
constexpr int NT_COPY = 128;  // threads of a copy block (one a tile)

__global__ void __launch_bounds__(NT_OFF) slot_compact_offsets_kernel(
    const int32_t* __restrict__ kept, const int32_t* __restrict__ raw,
    int stride, int32_t* __restrict__ offsets, int32_t* __restrict__ n_slotted,
    int32_t* __restrict__ n_min, int32_t* __restrict__ n_raw, int nt, int cap,
    int m) {
  __shared__ int s_tot[32];
  const int b = blockIdx.x, tid = threadIdx.x;
  int32_t* off = offsets + (size_t)b * (nt + 1);
  int raw_sum = 0;
  const int running = s2k::row_exclusive_scan<NT_OFF>(
      [&](int t) {
        const size_t at = ((size_t)b * nt + t) * stride;
        if (raw != nullptr) raw_sum += raw[at];
        return min(max(kept[at], 0), cap);
      },
      off, nt, s_tot);
  if (raw != nullptr) {
    int total;
    s2k::block_exclusive_sum<NT_OFF>(raw_sum, s_tot, &total);
    raw_sum = total;
  }
  if (tid == 0) {
    off[nt] = running;
    if (n_slotted != nullptr) n_slotted[b] = running;
    if (n_min != nullptr) n_min[b] = min(running, m);
    if (n_raw != nullptr) n_raw[b] = raw_sum;
  }
}

// Zero [d0, d1) of a column: scalar up to a 16-byte boundary, int4 stores,
// a scalar tail.
__device__ __forceinline__ void zero_range(int32_t* __restrict__ col,
                                           size_t d0, size_t d1) {
  const size_t a0 = min((d0 + 3) & ~(size_t)3, d1);
  const size_t a1 = max(d1 & ~(size_t)3, a0);
  for (size_t d = d0 + threadIdx.x; d < a0; d += NT_COPY) col[d] = 0;
  int4* body = reinterpret_cast<int4*>(col + a0);
  for (size_t q = threadIdx.x; q < (a1 - a0) / 4; q += NT_COPY)
    body[q] = make_int4(0, 0, 0, 0);
  for (size_t d = a1 + threadIdx.x; d < d1; d += NT_COPY) col[d] = 0;
}

__global__ void __launch_bounds__(NT_COPY) slot_compact_copy_kernel(
    const int32_t* __restrict__ in_start, const int32_t* __restrict__ in_end,
    const int32_t* __restrict__ in_hash,
    const int32_t* __restrict__ in_hash_hi,
    const int32_t* __restrict__ offsets, int32_t* __restrict__ out_start,
    int32_t* __restrict__ out_end, int32_t* __restrict__ out_hash,
    int32_t* __restrict__ out_hash_hi, int nt, int cap, int m, int fill) {
  const bool has_hi = in_hash_hi != nullptr;
  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int32_t* off = offsets + (size_t)b * (nt + 1);
  const int o = off[t];
  const int n = min(off[t + 1], m) - o;  // <= 0 once the offset passes m
  const size_t src = ((size_t)b * nt + t) * cap;
  const size_t dst = (size_t)b * m + o;
  for (int e = tid; e < n; e += NT_COPY) {
    out_start[dst + e] = in_start[src + e];
    out_end[dst + e] = in_end[src + e];
    out_hash[dst + e] = in_hash[src + e];
    if (has_hi) out_hash_hi[dst + e] = in_hash_hi[src + e];
  }
  if (!fill) return;
  // This block's share of the read's fill [min(n_slotted, m), m).
  const int lo = min(off[nt], m);
  const int share = (m - lo + nt - 1) / nt;
  const int f0 = min(lo + t * share, m), f1 = min(f0 + share, m);
  const size_t row = (size_t)b * m;
  zero_range(out_start, row + f0, row + f1);
  zero_range(out_end, row + f0, row + f1);
  zero_range(out_hash, row + f0, row + f1);
  if (has_hi) zero_range(out_hash_hi, row + f0, row + f1);
}

}  // namespace

// kept int32 at kept[(b * nt + t) * stride], raw (null: no n_raw) the same;
// offsets int32[B, nt + 1] is scratch; n_slotted, n_min and n_raw int32[B]
// are written where not null.  in_hash_hi and out_hash_hi are both null, or
// both given (hash width 64).  fill = 0 leaves the slots past
// min(n_slotted, m) unwritten.
extern "C" int s2k_slot_compact(const void* in_start, const void* in_end,
                                const void* in_hash, const void* in_hash_hi,
                                const void* kept, const void* raw, int stride,
                                void* out_start, void* out_end,
                                void* out_hash, void* out_hash_hi,
                                void* offsets, void* n_slotted, void* n_min,
                                void* n_raw, int B, int nt, int cap, int m,
                                int fill, void* stream) {
  if ((in_hash_hi == nullptr) != (out_hash_hi == nullptr) || B < 1 ||
      nt < 1 || cap < 1 || m < 1 || stride < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  slot_compact_offsets_kernel<<<B, NT_OFF, 0, s>>>(
      (const int32_t*)kept, (const int32_t*)raw, stride, (int32_t*)offsets,
      (int32_t*)n_slotted, (int32_t*)n_min, (int32_t*)n_raw, nt, cap, m);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  slot_compact_copy_kernel<<<dim3(nt, B), NT_COPY, 0, s>>>(
      (const int32_t*)in_start, (const int32_t*)in_end,
      (const int32_t*)in_hash, (const int32_t*)in_hash_hi,
      (const int32_t*)offsets, (int32_t*)out_start, (int32_t*)out_end,
      (int32_t*)out_hash, (int32_t*)out_hash_hi, nt, cap, m, fill);
  return (int)cudaGetLastError();
}
