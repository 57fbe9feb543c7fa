// K1, fused minimizer scan: HPC left-pack, canonical NtHash1-32 over the
// kept stream, density select and the per-tile survivor pack, in one pass
// over the xcodes.
//
// Replaces: rust_seq2kminmers_tpu/ops/pallas/fused_scan.py:_fused_kernel
// (wrapper fused_minimizer_scan).  What it computes is the same; the TPU
// mechanics (where-select seed tree, bit-decomposed move networks, MXU
// ranks, the 8-row pending prefix, u32 emulated on int32) are replaced by
// a table in shared memory, __ballot_sync/__popc block scans and native
// uint32_t.
//
// Bound on this card: it reads 1 byte per base and writes ~12 bytes per
// survivor (~1% of bases), so it is memory-light; the work is the window
// XOR (2*l shared-memory loads per candidate window) and ~7 block
// barriers per 1024 bases.  The real limit of this design is occupancy:
// a read's bases form one ordered stream whose rotations depend on the
// global kept rank, and the TPU carried the last l kept elements from
// block to block.  Here ONE thread block walks a read's tiles in order and
// keeps that carry in shared memory, so only B blocks run (32 of 132 SMs
// at the [32, 1 Mbp] main-path shape).  A tile that keeps no base (a long
// homopolymer run) costs nothing extra.  Filling the card needs a count ->
// scan -> splice pass or decoupled look-back over tiles: later work.
//
// Output contract (kept from the TPU so that a parallel K1 can reuse K2):
// the survivors whose window's emitting element lies in tile t (its last
// element, or its one-past-last element in hpc mode) are left-packed into
// out_*[b, t, 0:cap] in stream order; counts[b, t] = (kept survivors,
// raw selected, kept stream elements).  Slots past the kept count are
// left unwritten.

#include "common.cuh"

namespace {

constexpr int NT = 1024;    // threads per block = bases per step
constexpr int LMAX = 255;   // largest l: the carry is l elements
constexpr int BUF = NT + LMAX;

__global__ void __launch_bounds__(NT) fused_scan_kernel(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ limits, const uint32_t* __restrict__ seeds,
    int32_t* __restrict__ out_start, int32_t* __restrict__ out_end,
    int32_t* __restrict__ out_hash, int32_t* __restrict__ counts, int L,
    int l, uint32_t bound, int strict, int do_hpc, int hpc_end, int tile,
    int cap, int nt) {
  // Stream buffer: [0, l) holds the carry (the l kept elements before this
  // step, right-aligned), [l, l + cnt) the elements kept in this step.
  // For each element: its two pre-rotated seed terms and its position.
  __shared__ uint32_t s_af[BUF], s_ar[BUF];
  __shared__ int32_t s_pos[BUF];
  __shared__ uint32_t s_seed[16];  // forward seeds [0, 8), reverse [8, 16)
  __shared__ int s_tot_keep[32], s_tot_sel[32];

  const int b = blockIdx.x, tid = threadIdx.x;
  if (tid < 16) s_seed[tid] = seeds[tid];
  __syncthreads();
  const uint8_t* row = codes + (size_t)b * L;
  const int length = lengths[b];
  const int limit = limits[b];
  int base = 0;  // global kept rank of buffer index l

  for (int t = 0; t < nt; ++t) {
    const size_t obase = ((size_t)b * nt + t) * cap;
    const int t_end = min(L, (t + 1) * tile);
    int tile_raw = 0, tile_stream = 0;
    for (int c0 = t * tile; c0 < t_end; c0 += NT) {
      const int j = c0 + tid;
      bool keep = false;
      uint32_t code = 0;
      if (j < t_end) {
        const uint32_t x = row[j];
        code = x & 7u;
        keep = do_hpc ? ((x & 8u) != 0 && j < length) : true;
      }
      int cnt;
      const int rank = s2k::block_rank<NT>(keep, s_tot_keep, &cnt);
      if (keep) {
        const int e = l + rank;
        const uint32_t r = (uint32_t)(base + rank);
        s_af[e] = s2k::rol32(s_seed[code], 0u - r);
        s_ar[e] = s2k::rol32(s_seed[8 + code], r);
        s_pos[e] = j;
      }
      __syncthreads();

      // Window starting at buffer index i; this step emits it when its
      // emitting element is new: i in [1, cnt], or [0, cnt) for hpc_end.
      const int i = tid + (hpc_end ? 0 : 1);
      const int f = base - l + i;  // global kept rank of the window start
      bool sel = false;
      uint32_t h = 0;
      int st = 0, en = 0;
      if (tid < cnt && f >= 0 && f <= limit) {
        uint32_t wf = 0, wr = 0;
        for (int q = 0; q < l; ++q) {
          wf ^= s_af[i + q];
          wr ^= s_ar[i + q];
        }
        const uint32_t fh = s2k::rol32(wf, (uint32_t)(l - 1 + f));
        const uint32_t rh = s2k::rol32(wr, 0u - (uint32_t)f);
        h = min(fh, rh);
        sel = strict ? (h < bound) : (h <= bound);
        st = s_pos[i];
        en = hpc_end ? s_pos[i + l] - 1 : s_pos[i + l - 1];
      }
      int nsel;
      const int srank = s2k::block_rank<NT>(sel, s_tot_sel, &nsel);
      const int slot = tile_raw + srank;
      if (sel && slot < cap) {
        out_start[obase + slot] = st;
        out_end[obase + slot] = en;
        out_hash[obase + slot] = (int32_t)h;
      }
      tile_raw += nsel;
      tile_stream += cnt;

      // The last l elements become the next step's carry.
      uint32_t ca = 0, cr = 0;
      int cp = 0;
      if (tid < l) {
        ca = s_af[cnt + tid];
        cr = s_ar[cnt + tid];
        cp = s_pos[cnt + tid];
      }
      __syncthreads();
      if (tid < l) {
        s_af[tid] = ca;
        s_ar[tid] = cr;
        s_pos[tid] = cp;
      }
      __syncthreads();
      base += cnt;
    }
    if (tid == 0) {
      int32_t* c = counts + ((size_t)b * nt + t) * 3;
      c[0] = min(tile_raw, cap);
      c[1] = tile_raw;
      c[2] = tile_stream;
    }
  }
}

}  // namespace

extern "C" int s2k_fused_scan(const void* codes, const void* lengths,
                              const void* limits, const void* seeds,
                              void* out_start, void* out_end, void* out_hash,
                              void* counts, int B, int L, int l,
                              uint32_t bound, int strict, int do_hpc,
                              int hpc_end, int tile, int cap, int nt,
                              void* stream) {
  if (l < 2 || l > LMAX) return (int)cudaErrorInvalidValue;
  fused_scan_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int32_t*)lengths,
      (const int32_t*)limits, (const uint32_t*)seeds, (int32_t*)out_start,
      (int32_t*)out_end, (int32_t*)out_hash, (int32_t*)counts, L, l, bound,
      strict, do_hpc, hpc_end, tile, cap, nt);
  return (int)cudaGetLastError();
}
