// K1, fused minimizer scan: HPC left-pack, canonical NtHash over the kept
// stream, density select and the per-tile survivor pack, in one pass over
// the xcodes.  The hash is NtHash1 at width 16, 32 or 64, or the
// NtHash2-hybrid 31-bit variant: one template instance each.
//
// Replaces: rust_seq2kminmers_tpu/ops/pallas/fused_scan.py:_fused_kernel
// (wrapper fused_minimizer_scan).  What it computes is the same; the TPU
// mechanics (where-select seed tree, bit-decomposed move networks, MXU
// ranks, the 8-row pending prefix, u32 emulated on int32, u64 as (hi, lo)
// int32 pairs, mod 31 through f32 division) are replaced by a table in
// shared memory, __ballot_sync/__popc block scans and native uint32_t /
// uint64_t arithmetic.
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
// Carry (a long read scanned chunk by chunk, ops/long_read.py): base0[b] is
// the global kept rank before this launch, carry_in[b] the last l stream
// elements before it, right-aligned and packed (pos << 3) | code with
// chunk-relative (so negative) positions; only the last min(base0, l) are
// real, and every window that touches the others has a start rank < 0 and
// is masked.  After the last tile the buffer's last l elements go to
// carry_out[b] in the same packing; the caller rebases their positions.
// Both are null for a fresh read.  The buffer keeps positions only, as the
// scan needs: a carried-out element of this chunk takes its code from the
// row again, and one that passed through from an earlier chunk (this chunk
// kept fewer than l elements) is copied from carry_in.  So the scan loop
// is the same with or without a carry.
//
// Output contract (kept from the TPU so that a parallel K1 can reuse K2):
// the survivors whose window's emitting element lies in tile t (its last
// element, or its one-past-last element in hpc mode) are left-packed into
// out_*[b, t, 0:cap] in stream order; counts[b, t] = (kept survivors,
// raw selected, kept stream elements).  Slots past the kept count are
// left unwritten.  out_hash holds the hash's low 32 bits; at width 64,
// out_hash_hi its high 32 bits.

#include "common.cuh"

namespace {

constexpr int NT = 1024;    // threads per block = bases per step
constexpr int LMAX = 255;   // largest l: the carry is l elements
constexpr int BUF = NT + LMAX;

// A hash width: its value type, rotate (the amount taken mod the width)
// and the amount that rotates by -r.
struct H32 {
  using T = uint32_t;
  __device__ static T rol(T x, uint32_t r) { return s2k::rol32(x, r); }
  __device__ static uint32_t neg(uint32_t r) { return 0u - r; }
};

struct H16 {  // values below 2^16 in 32-bit lanes
  using T = uint32_t;
  __device__ static T rol(T x, uint32_t r) {
    r &= 15u;
    return ((x << r) | (x >> (16u - r))) & 0xFFFFu;
  }
  __device__ static uint32_t neg(uint32_t r) { return 0u - r; }
};

struct H31 {  // NtHash2-hybrid: values below 2^31, rotates mod 31
  using T = uint32_t;
  __device__ static T rol(T x, uint32_t r) {
    r %= 31u;  // x >> 31 is 0 at r = 0: x < 2^31
    return ((x << r) | (x >> (31u - r))) & 0x7FFFFFFFu;
  }
  __device__ static uint32_t neg(uint32_t r) { return (31u - r % 31u) % 31u; }
};

struct H64 {
  using T = uint64_t;
  __device__ static T rol(T x, uint32_t r) { return s2k::rol64(x, r); }
  __device__ static uint32_t neg(uint32_t r) { return 0u - r; }
};

template <typename H>
__global__ void __launch_bounds__(NT) fused_scan_kernel(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ limits,
    const typename H::T* __restrict__ seeds, int32_t* __restrict__ out_start,
    int32_t* __restrict__ out_end, int32_t* __restrict__ out_hash,
    int32_t* __restrict__ out_hash_hi, int32_t* __restrict__ counts,
    const int32_t* __restrict__ base0, const int32_t* __restrict__ carry_in,
    int32_t* __restrict__ carry_out, int L, int l, typename H::T bound,
    int strict, int do_hpc, int hpc_end, int tile, int cap, int nt) {
  using T = typename H::T;
  // Stream buffer: [0, l) holds the carry (the l kept elements before this
  // step, right-aligned), [l, l + cnt) the elements kept in this step.
  // For each element: its two pre-rotated seed terms and its position.
  __shared__ T s_af[BUF], s_ar[BUF];
  __shared__ int32_t s_pos[BUF];
  __shared__ T s_seed[16];  // forward seeds [0, 8), reverse [8, 16)
  __shared__ int s_tot_keep[32], s_tot_sel[32];

  const int b = blockIdx.x, tid = threadIdx.x;
  if (tid < 16) s_seed[tid] = seeds[tid];
  __syncthreads();
  const uint8_t* row = codes + (size_t)b * L;
  const int length = lengths[b];
  const int limit = limits[b];
  const int base_in = base0 ? base0[b] : 0;
  int base = base_in;  // global kept rank of buffer index l
  if (carry_in && tid < l) {
    const int32_t p = carry_in[(size_t)b * l + tid];
    const int r = base - l + tid;  // < 0: not a real element, never read
    if (r >= 0) {
      s_af[tid] = H::rol(s_seed[p & 7], H::neg((uint32_t)r));
      s_ar[tid] = H::rol(s_seed[8 + (p & 7)], (uint32_t)r);
    }
    s_pos[tid] = p >> 3;  // arithmetic: carried positions are negative
  }
  __syncthreads();

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
        s_af[e] = H::rol(s_seed[code], H::neg(r));
        s_ar[e] = H::rol(s_seed[8 + code], r);
        s_pos[e] = j;
      }
      __syncthreads();

      // Window starting at buffer index i; this step emits it when its
      // emitting element is new: i in [1, cnt], or [0, cnt) for hpc_end.
      const int i = tid + (hpc_end ? 0 : 1);
      const int f = base - l + i;  // global kept rank of the window start
      bool sel = false;
      T h = 0;
      int st = 0, en = 0;
      if (tid < cnt && f >= 0 && f <= limit) {
        T wf = 0, wr = 0;
        for (int q = 0; q < l; ++q) {
          wf ^= s_af[i + q];
          wr ^= s_ar[i + q];
        }
        const T fh = H::rol(wf, (uint32_t)(l - 1 + f));
        const T rh = H::rol(wr, H::neg((uint32_t)f));
        h = fh < rh ? fh : rh;
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
        out_hash[obase + slot] = (int32_t)(uint32_t)h;
        if constexpr (sizeof(T) == 8) {
          out_hash_hi[obase + slot] = (int32_t)(uint32_t)(h >> 32);
        }
      }
      tile_raw += nsel;
      tile_stream += cnt;

      // The last l elements become the next step's carry.
      T ca = 0, cr = 0;
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
  if (carry_out && tid < l) {
    const int n = base - base_in;  // elements kept in this launch
    int32_t p = 0;  // an element before the read's start: never real
    if (n + tid < l) {
      if (carry_in) p = carry_in[(size_t)b * l + n + tid];
    } else {
      const int pos = s_pos[tid];
      p = (pos << 3) | (int)(row[pos] & 7u);
    }
    carry_out[(size_t)b * l + tid] = p;
  }
}

template <typename H>
void launch(const void* codes, const void* lengths, const void* limits,
            const void* seeds, void* out_start, void* out_end,
            void* out_hash, void* out_hash_hi, void* counts,
            const void* base0, const void* carry_in, void* carry_out, int B,
            int L, int l, uint64_t bound, int strict, int do_hpc, int hpc_end,
            int tile, int cap, int nt, cudaStream_t stream) {
  using T = typename H::T;
  fused_scan_kernel<H><<<B, NT, 0, stream>>>(
      (const uint8_t*)codes, (const int32_t*)lengths, (const int32_t*)limits,
      (const T*)seeds, (int32_t*)out_start, (int32_t*)out_end,
      (int32_t*)out_hash, (int32_t*)out_hash_hi, (int32_t*)counts,
      (const int32_t*)base0, (const int32_t*)carry_in, (int32_t*)carry_out, L,
      l, (T)bound, strict, do_hpc, hpc_end, tile, cap, nt);
}

}  // namespace

// width: 16, 32 or 64 (NtHash1), or 31 (the NtHash2-hybrid variant).
// seeds: 16 values of the width's type (uint64_t at 64, else uint32_t);
// out_hash_hi is written only at width 64.  base0 int32[B], carry_in and
// carry_out int32[B, l]: null for a fresh read and no carry-out.
extern "C" int s2k_fused_scan(const void* codes, const void* lengths,
                              const void* limits, const void* seeds,
                              void* out_start, void* out_end, void* out_hash,
                              void* out_hash_hi, void* counts,
                              const void* base0, const void* carry_in,
                              void* carry_out, int B, int L, int l,
                              uint64_t bound, int width, int strict,
                              int do_hpc, int hpc_end, int tile, int cap,
                              int nt, void* stream) {
  if (l < 2 || l > LMAX) return (int)cudaErrorInvalidValue;
  if (width != 64 && bound > 0xFFFFFFFFull) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define S2K_LAUNCH(H)                                                       \
  launch<H>(codes, lengths, limits, seeds, out_start, out_end, out_hash,    \
            out_hash_hi, counts, base0, carry_in, carry_out, B, L, l, bound, \
            strict, do_hpc, hpc_end, tile, cap, nt, s)
  switch (width) {
    case 16: S2K_LAUNCH(H16); break;
    case 31: S2K_LAUNCH(H31); break;
    case 32: S2K_LAUNCH(H32); break;
    case 64: S2K_LAUNCH(H64); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef S2K_LAUNCH
  return (int)cudaGetLastError();
}
