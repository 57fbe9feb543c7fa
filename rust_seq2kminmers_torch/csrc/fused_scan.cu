// K1, fused minimizer scan: HPC left-pack, canonical NtHash over the kept
// stream, density select and the per-tile survivor pack, over the xcodes.
// The hash is NtHash1 at width 16, 32 or 64, or the NtHash2-hybrid 31-bit
// variant: one template instance each.
//
// Replaces: rust_seq2kminmers_tpu/ops/pallas/fused_scan.py:_fused_kernel
// (wrapper fused_minimizer_scan).  What it computes is the same; the TPU
// mechanics (where-select seed tree, bit-decomposed move networks, MXU
// ranks, the 8-row pending prefix carried along a sequential grid, u32
// emulated on int32, u64 as (hi, lo) int32 pairs, mod 31 through f32
// division) are replaced by a table in shared memory, __ballot_sync/__popc
// and shuffle scans, and native uint32_t / uint64_t arithmetic.
//
// A read's bases form one ordered stream: an element's hash terms are
// rotated by its global kept rank, and a window needs the l elements
// before it.  The TPU carried the last l kept elements from grid step to
// grid step.  Here the tiles of every read run in parallel, in three
// launches (the count -> scan -> scatter pattern of masked_compact.cu):
//
//   1. tile_summary_kernel, grid (nt, B): each tile's kept count and its
//      last min(count, l) kept elements, packed (pos << 3) | code and
//      right-aligned in tail[b, t, 0:l];
//   2. tile_carries_kernel, grid (ceil((nt + 1) / 64), B): an exclusive scan
//      of the counts from base0 (every block of a read scans them) gives each tile's first rank base[b, t] (t = 0..nt;
//      base[b, nt] is the next chunk's), and each tile's pending prefix
//      pending[b, t, 0:l], the stream elements of ranks base - l .. base - 1,
//      64 tiles' prefixes a block.
//      Rank r comes from the tile s < t whose rank range holds it (a binary
//      search over base, in shared memory); fewer than l elements follow it before tile t, so
//      it lies in s's tail.  Ranks below base0 come from carry_in (0 when
//      there is none; ranks below 0 are never real).  A tile that keeps
//      nothing owns no rank and needs no special case.  The virtual tile
//      nt's prefix IS the carry-out;
//   3. scan_kernel, grid (nt, B), one block per (tile, read): the block
//      seeds its stream from its pending prefix and walks its own tile in
//      steps of NT = 640 bases, its codes staged in shared memory by 16-byte
//      loads.
//
// The window hash: the pre-rotated terms af[e] = rol(seed[c], -r) and
// ar[e] = rol(seed'[c], r) combine only by XOR, so the block keeps running
// prefixes PF(r) = af[..] ^ ... ^ af[r] and PR(r) instead of the terms, and
// the window at rank f is PF(f + l - 1) ^ PF(f - 1): two shared-memory loads,
// not 2 * l.  A step ranks its kept elements (ballots, one warp reduction
// for the warps before), XOR-scans their terms over the warp with shuffles
// and adds the XOR of the warps before with one warp reduction.  Prefixes
// and positions live in a ring of RING slots indexed by rank, so nothing is
// copied from step to step and PF(base - 1) is read back from it; a step has
// four barriers (ballots, warp XORs, stream written, survivor ballots).
//
// Bound on this card: it reads 1 byte per base twice (passes 1 and 3) and
// writes ~12 bytes per survivor (~1% of bases), so bytes allow ~0.01 ms at
// the [32, 1 Mbp] main-path shape; what binds is pass 3's instructions per
// base (keep test, ballots, shuffle scans, rotations, the window) and its
// four barriers a step.
//
// Output contract: the survivors whose window's emitting element lies in
// tile t (its last element, or its one-past-last element in hpc mode) are
// left-packed into out_*[b, t, 0:cap] in stream order; counts[b, t] =
// (kept survivors, raw selected, kept stream elements).  Slots past the kept
// count are left unwritten.  out_hash holds the hash's low 32 bits; at
// width 64, out_hash_hi its high 32 bits.
//
// Carry (a long read scanned chunk by chunk, ops/long_read.py): base0[b] is
// the global kept rank before this launch, carry_in[b] the last l stream
// elements before it, right-aligned and packed (pos << 3) | code with
// chunk-relative (so negative) positions; only the last min(base0, l) are
// real, and every window that touches the others has a start rank < 0 and
// is masked.  carry_out[b] gets the last l elements of the extended stream
// in the same packing; the caller rebases their positions.  All three are
// null for a fresh read with no carry-out.

#include "common.cuh"

namespace {

// Pass 3: threads per block = bases per step, and blocks per SM: 640 x 2
// leaves 48 registers a thread, enough for every width with no spill
// (1024 x 2 spilled at 32; 1024 x 1 and 512 x 2 ran slower).
constexpr int NT = 640;
constexpr int MIN_BLOCKS = 2;
constexpr int LMAX = 255;   // largest l: the pending prefix is l elements
// Ring slots: a power of two that holds a step and the l + 1 ranks before it.
constexpr int ring_slots(int n) { return n >= NT + LMAX + 1 ? n : ring_slots(2 * n); }
constexpr int RING = ring_slots(1);
constexpr int SEG = 16 * NT;  // bases staged in shared memory at a time
constexpr int RANKS_SMEM = 12000;  // pass 2 searches ranks in shared memory
                                   // up to this many tiles
constexpr int NW = NT / 32;  // warps per block
constexpr int NT1 = 256, CH = 4;  // pass 1: threads, 16-byte chunks a thread
constexpr int TPB = 64;  // pass 2: tiles' pending prefixes a block

using s2k::FULL;
using s2k::H16;
using s2k::H31;
using s2k::H32;
using s2k::H64;
using s2k::byte_of;
using s2k::misalign;
using s2k::warp_xor_scan;
using s2k::xor_below;

// Whether xcode x at position j < t1 is a stream element: every position
// in the regular modes, the HPC keep bit before the read's end in the hpc
// modes.
__device__ __forceinline__ bool kept(uint32_t x, int j, int t1, int length,
                                     int do_hpc) {
  return j < t1 && (!do_hpc || ((x & 8u) != 0 && j < length));
}

// ---- pass 1: per tile, the kept count and the last l kept elements -------

__global__ void __launch_bounds__(NT1) tile_summary_kernel(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ lengths,
    int32_t* __restrict__ tile_count, int32_t* __restrict__ tail, int L,
    int l, int do_hpc, int tile, int nt) {
  __shared__ int s_tot[32];
  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const uint8_t* row = codes + (size_t)b * L;
  const int length = lengths[b];
  const int t0 = t * tile, t1 = min(L, t0 + tile);
  const int lo = t0 - misalign(row + t0);  // position of chunk 0's byte 0
  const uint4* src = reinterpret_cast<const uint4*>(row + lo);
  const int nchunk = (t1 - lo + 15) >> 4;
  int32_t* out = tail + ((size_t)b * nt + t) * l;
  // Rounds of NT1 * CH chunks, CH consecutive ones a thread, the last round
  // first: an element's suffix rank (the kept elements after it in the
  // tile) places it in the tail.
  int after = 0;  // kept elements in the rounds done
  for (int s = (nchunk - 1) / (NT1 * CH); s >= 0; --s) {
    const int q0 = (s * NT1 + tid) * CH;
    const int p0 = lo + 16 * q0;
    uint64_t mask = 0;  // bit i: position p0 + i is kept
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (q0 + c < nchunk) {
        const uint4 v = src[q0 + c];
#pragma unroll
        for (int x = 0; x < 16; ++x) {
          const int j = p0 + 16 * c + x;
          mask |= (uint64_t)(j >= t0 && kept(byte_of(v, x), j, t1, length, do_hpc))
                  << (16 * c + x);
        }
      }
    }
    const int n = __popcll(mask);
    int total;
    const int before = s2k::block_exclusive_sum<NT1>(n, s_tot, &total);
    // From the thread's last kept base down, while the suffix rank is < l.
    for (int suf = after + total - before - n; mask && suf < l; ++suf) {
      const int i = 63 - __clzll(mask);
      mask &= ~(1ull << i);
      out[l - 1 - suf] = ((p0 + i) << 3) | (int)(row[p0 + i] & 7u);
    }
    after += total;
    __syncthreads();  // s_tot is read above before the next round writes it
  }
  if (tid == 0) tile_count[(size_t)b * nt + t] = after;
}

// ---- pass 2: per read, each tile's first rank and pending prefix ----------

// Block (g, b) scans all of read b's tile counts (block 0 also stores the
// ranks) and builds the pending prefixes of tiles [g * tpb, (g + 1) * tpb).
// With the ranks in shared memory the blocks of a read share nothing;
// without (nt >= RANKS_SMEM) one block does it all through `base`.
__global__ void __launch_bounds__(NT) tile_carries_kernel(
    const int32_t* __restrict__ tile_count, const int32_t* __restrict__ tail,
    const int32_t* __restrict__ base0, const int32_t* __restrict__ carry_in,
    int32_t* base, int32_t* __restrict__ pending,
    int32_t* __restrict__ carry_out, int l, int nt, int tpb) {
  __shared__ int s_tot[32];
  extern __shared__ int32_t s_rb[];  // the ranks, when nt < RANKS_SMEM
  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int b0 = base0 ? base0[b] : 0;
  int32_t* rb = base + (size_t)b * (nt + 1);
  const bool in_smem = nt < RANKS_SMEM;
  int running = b0;
  for (int t0 = 0; t0 < nt; t0 += NT) {
    const int t = t0 + tid;
    const int c = t < nt ? tile_count[(size_t)b * nt + t] : 0;
    int total;
    const int pre = s2k::block_exclusive_sum<NT>(c, s_tot, &total);
    if (t < nt) {
      if (g == 0) rb[t] = running + pre;
      if (in_smem) s_rb[t] = running + pre;
    }
    running += total;
    __syncthreads();  // s_tot is read above before the next chunk writes it
  }
  if (tid == 0) {
    if (g == 0) rb[nt] = running;
    if (in_smem) s_rb[nt] = running;
  }
  __syncthreads();  // the block's stores to the ranks are visible to its loads
  const int32_t* rs = in_smem ? s_rb : rb;
  const int32_t* rtail = tail + (size_t)b * nt * l;
  const int tb = g * tpb, n = (min(nt + 1, tb + tpb) - tb) * l;
  for (int idx = tid; idx < n; idx += NT) {
    const int t = tb + idx / l, k = idx % l;
    const int r = rs[t] - l + k;  // the element's global rank
    int32_t p = 0;
    if (r < b0) {
      if (carry_in) p = carry_in[(size_t)b * l + r - b0 + l];
    } else {  // the tile s < t holding rank r: the first with rs[s + 1] > r
      int s = 0, hi = t - 1;
      while (s < hi) {
        const int mid = (s + hi) >> 1;
        if (rs[mid + 1] > r) hi = mid; else s = mid + 1;
      }
      p = rtail[(size_t)s * l + l - (rs[s + 1] - r)];
    }
    if (t == nt && carry_out) {
      carry_out[(size_t)b * l + k] = p;
    } else {
      pending[((size_t)b * (nt + 1) + t) * l + k] = p;
    }
  }
}

// ---- pass 3: one block per (tile, read) -----------------------------------

// The canonical hash of the window at rank f >= 0 from the ring's prefixes.
template <typename H>
__device__ __forceinline__ typename H::T window_hash(const typename H::T* pf,
                                                     const typename H::T* pr,
                                                     int f, int l) {
  using T = typename H::T;
  const int last = (f + l - 1) & (RING - 1), prev = (f - 1) & (RING - 1);
  const T fh = H::rol(pf[last] ^ pf[prev], (uint32_t)(l - 1 + f));
  const T rh = H::rol(pr[last] ^ pr[prev], H::neg((uint32_t)f));
  return fh < rh ? fh : rh;
}

template <typename H>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) scan_kernel(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ limits,
    const typename H::T* __restrict__ seeds,
    const int32_t* __restrict__ base_in, const int32_t* __restrict__ pending,
    int32_t* __restrict__ out_start, int32_t* __restrict__ out_end,
    int32_t* __restrict__ out_hash, int32_t* __restrict__ out_hash_hi,
    int32_t* __restrict__ counts, int L, int l, typename H::T bound,
    int strict, int do_hpc, int hpc_end, int tile, int cap, int nt) {
  using T = typename H::T;
  constexpr int M = RING - 1;
  // The ring, by rank r at slot r & M: PF(r), PR(r) and r's position; then
  // the staged codes.
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_pf = reinterpret_cast<T*>(smem);
  T* s_pr = s_pf + RING;
  int32_t* s_pos = reinterpret_cast<int32_t*>(s_pr + RING);
  uint8_t* s_code = reinterpret_cast<uint8_t*>(s_pos + RING);
  __shared__ T s_seed[16];  // forward seeds [0, 8), reverse [8, 16)
  __shared__ T s_wf[NW], s_wr[NW];  // each warp's XOR of its terms
  __shared__ unsigned s_ballot[NW], s_bsel[NW];  // kept, selected

  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (tid < 16) s_seed[tid] = seeds[tid];
  __syncthreads();
  const size_t bt = (size_t)b * (nt + 1) + t;
  int base = base_in[bt];  // the rank of the next stream element

  // The pending prefix, ranks base - l .. base - 1, by warp 0, 8 a lane.
  // A rank below 0 is never in a window: its terms are left out.
  if (warp == 0) {
    const int32_t* pend = pending + bt * l;
    const int k0 = lane * 8, k1 = min(l, k0 + 8);
    T xf = 0, xr = 0;
    for (int k = k0; k < k1; ++k) {
      const int32_t p = pend[k];
      const int r = base - l + k;
      if (r >= 0) {
        xf ^= H::rol(s_seed[p & 7], H::neg((uint32_t)r));
        xr ^= H::rol(s_seed[8 + (p & 7)], (uint32_t)r);
      }
    }
    T pf = warp_xor_scan(xf, lane) ^ xf, pr = warp_xor_scan(xr, lane) ^ xr;
    for (int k = k0; k < k1; ++k) {
      const int32_t p = pend[k];
      const int r = base - l + k;
      if (r >= 0) {
        pf ^= H::rol(s_seed[p & 7], H::neg((uint32_t)r));
        pr ^= H::rol(s_seed[8 + (p & 7)], (uint32_t)r);
      }
      s_pf[r & M] = pf;
      s_pr[r & M] = pr;
      s_pos[r & M] = p >> 3;  // arithmetic: carried positions are negative
    }
    if (lane == 0) {
      s_pf[(base - l - 1) & M] = 0;
      s_pr[(base - l - 1) & M] = 0;
    }
  }

  const int length = lengths[b], limit = limits[b];
  const int t0 = t * tile, t1 = min(L, t0 + tile);
  int tile_raw = 0;
  for (int c0 = t0; c0 < t1; c0 += NT) {
    const int g0 = t0 + (c0 - t0) / SEG * SEG;  // the staged segment's start
    const uint8_t* seg = codes + (size_t)b * L + g0;
    const int mis = misalign(seg);
    if (c0 == g0) {
      __syncthreads();  // the last segment's codes are read; the ring seeded
      const uint4* src = reinterpret_cast<const uint4*>(seg - mis);
      for (int q = tid; q < (min(t1 - g0, SEG) + mis + 15) >> 4; q += NT) {
        reinterpret_cast<uint4*>(s_code)[q] = src[q];
      }
      __syncthreads();
    }
    const int j = c0 + tid;
    const uint32_t x = j < t1 ? s_code[j - g0 + mis] : 0u;
    const bool keep = kept(x, j, t1, length, do_hpc);
    const unsigned ballot = __ballot_sync(FULL, keep);
    if (lane == 0) s_ballot[warp] = ballot;
    __syncthreads();
    // The element's rank, and its terms rotated by it, XOR-scanned over the
    // warp; then the warps' XORs combined over the block.
    const int wn = lane < NW ? __popc(s_ballot[lane]) : 0;
    const int cnt = __reduce_add_sync(FULL, wn);
    const int rank = base + __reduce_add_sync(FULL, lane < warp ? wn : 0) +
                     __popc(ballot & ((1u << lane) - 1u));
    T f = 0, r = 0;
    if (keep) {
      f = H::rol(s_seed[x & 7u], H::neg((uint32_t)rank));
      r = H::rol(s_seed[8 + (x & 7u)], (uint32_t)rank);
    }
    f = warp_xor_scan(f, lane);
    r = warp_xor_scan(r, lane);
    if (lane == 31) {
      s_wf[warp] = f;
      s_wr[warp] = r;
    }
    __syncthreads();
    f ^= xor_below(s_wf, lane, warp);
    r ^= xor_below(s_wr, lane, warp);
    if (keep) {  // PF(rank) = PF(base - 1) ^ the step's terms up to rank
      const int p = (base - 1) & M;
      s_pf[rank & M] = s_pf[p] ^ f;
      s_pr[rank & M] = s_pr[p] ^ r;
      s_pos[rank & M] = j;
    }
    __syncthreads();

    // The window at rank fs; this step emits it when its emitting element
    // (rank fs + l - 1, or fs + l for hpc_end) is new: tid < cnt.  A
    // survivor's hash is computed again after the barrier, so that no
    // thread keeps it across.
    const int fs = base - l + tid + (hpc_end ? 0 : 1);
    bool sel = false;
    if (tid < cnt && fs >= 0 && fs <= limit) {
      const T h = window_hash<H>(s_pf, s_pr, fs, l);
      sel = strict ? (h < bound) : (h <= bound);
    }
    const unsigned sb = __ballot_sync(FULL, sel);
    if (lane == 0) s_bsel[warp] = sb;
    __syncthreads();
    const int sn = lane < NW ? __popc(s_bsel[lane]) : 0;
    const int slot = tile_raw + __reduce_add_sync(FULL, lane < warp ? sn : 0) +
                     __popc(sb & ((1u << lane) - 1u));
    if (sel && slot < cap) {
      const size_t o = ((size_t)b * nt + t) * cap + slot;
      const T h = window_hash<H>(s_pf, s_pr, fs, l);
      out_start[o] = s_pos[fs & M];
      out_end[o] = hpc_end ? s_pos[(fs + l) & M] - 1 : s_pos[(fs + l - 1) & M];
      out_hash[o] = (int32_t)(uint32_t)h;
      if constexpr (sizeof(T) == 8) out_hash_hi[o] = (int32_t)(uint32_t)(h >> 32);
    }
    tile_raw += __reduce_add_sync(FULL, sn);
    base += cnt;
  }
  if (tid == 0) {
    int32_t* c = counts + ((size_t)b * nt + t) * 3;
    c[0] = min(tile_raw, cap);
    c[1] = tile_raw;
    c[2] = base - base_in[bt];
  }
}

// Passes 1 and 2.  With carry_out, tile nt's pending prefix goes there.
cudaError_t launch_carries(const void* codes, const void* lengths,
                           const void* base0, const void* carry_in,
                           void* tile_count, void* tail, void* base,
                           void* pending, void* carry_out, int B, int L, int l,
                           int do_hpc, int tile, int nt, cudaStream_t s) {
  tile_summary_kernel<<<dim3(nt, B), NT1, 0, s>>>(
      (const uint8_t*)codes, (const int32_t*)lengths, (int32_t*)tile_count,
      (int32_t*)tail, L, l, do_hpc, tile, nt);
  const bool in_smem = nt < RANKS_SMEM;
  const int tpb = in_smem ? TPB : nt + 1;
  tile_carries_kernel<<<dim3((nt + tpb) / tpb, B), NT,
                        in_smem ? (nt + 1) * sizeof(int32_t) : 0, s>>>(
      (const int32_t*)tile_count, (const int32_t*)tail, (const int32_t*)base0,
      (const int32_t*)carry_in, (int32_t*)base, (int32_t*)pending,
      (int32_t*)carry_out, l, nt, tpb);
  return cudaGetLastError();
}

template <typename H>
cudaError_t launch_scan(const void* codes, const void* lengths,
                        const void* limits, const void* seeds,
                        const void* base, const void* pending, void* out_start,
                        void* out_end, void* out_hash, void* out_hash_hi,
                        void* counts, int B, int L, int l, uint64_t bound,
                        int strict, int do_hpc, int hpc_end, int tile, int cap,
                        int nt, cudaStream_t s) {
  using T = typename H::T;
  constexpr int smem = RING * (2 * (int)sizeof(T) + 4) + SEG + 16;
  static_assert(smem <= 40 * 1024, "more needs cudaFuncSetAttribute");
  scan_kernel<H><<<dim3(nt, B), NT, smem, s>>>(
      (const uint8_t*)codes, (const int32_t*)lengths, (const int32_t*)limits,
      (const T*)seeds, (const int32_t*)base, (const int32_t*)pending,
      (int32_t*)out_start, (int32_t*)out_end, (int32_t*)out_hash,
      (int32_t*)out_hash_hi, (int32_t*)counts, L, l, (T)bound, strict, do_hpc,
      hpc_end, tile, cap, nt);
  return cudaGetLastError();
}

}  // namespace

// Passes 1 and 2 alone: base int32[B, nt + 1] and pending int32[B, nt + 1,
// l]; tile_count int32[B, nt] and tail int32[B, nt, l] are scratch.
// base0 int32[B] and carry_in int32[B, l] are null for a fresh read.
extern "C" int s2k_tile_carries(const void* codes, const void* lengths,
                                const void* base0, const void* carry_in,
                                void* tile_count, void* tail, void* base,
                                void* pending, int B, int L, int l,
                                int do_hpc, int tile, int nt, void* stream) {
  if (l < 2 || l > LMAX || B < 1 || L < 1 || tile < 1)
    return (int)cudaErrorInvalidValue;
  return (int)launch_carries(codes, lengths, base0, carry_in, tile_count, tail,
                             base, pending, nullptr, B, L, l, do_hpc, tile, nt,
                             (cudaStream_t)stream);
}

// The whole scan.  width: 16, 32 or 64 (NtHash1), or 31 (the NtHash2-hybrid
// variant).  seeds: 16 values of the width's type (uint64_t at 64, else
// uint32_t); out_hash_hi is written only at width 64.  base0 int32[B],
// carry_in and carry_out int32[B, l]: null for a fresh read and no
// carry-out.  tile_count, tail, base and pending: scratch as for
// s2k_tile_carries.
extern "C" int s2k_fused_scan(const void* codes, const void* lengths,
                              const void* limits, const void* seeds,
                              void* out_start, void* out_end, void* out_hash,
                              void* out_hash_hi, void* counts,
                              const void* base0, const void* carry_in,
                              void* carry_out, void* tile_count, void* tail,
                              void* base, void* pending, int B, int L, int l,
                              uint64_t bound, int width, int strict,
                              int do_hpc, int hpc_end, int tile, int cap,
                              int nt, void* stream) {
  if (l < 2 || l > LMAX || B < 1 || L < 1 || tile < 1)
    return (int)cudaErrorInvalidValue;
  if (width != 64 && bound > 0xFFFFFFFFull) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_carries(codes, lengths, base0, carry_in, tile_count,
                                   tail, base, pending, carry_out, B, L, l,
                                   do_hpc, tile, nt, s);
  if (err != cudaSuccess) return (int)err;
#define S2K_SCAN(H)                                                          \
  err = launch_scan<H>(codes, lengths, limits, seeds, base, pending,         \
                       out_start, out_end, out_hash, out_hash_hi, counts, B, \
                       L, l, bound, strict, do_hpc, hpc_end, tile, cap, nt, s)
  switch (width) {
    case 16: S2K_SCAN(H16); break;
    case 31: S2K_SCAN(H31); break;
    case 32: S2K_SCAN(H32); break;
    case 64: S2K_SCAN(H64); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef S2K_SCAN
  return (int)err;
}
