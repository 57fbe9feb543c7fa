// The general path's minimizer stream (l = 1 or l > 255): per row, the
// canonical NtHash of every window of l elements, the density select, the
// window gate, each window's start and end, and the ordered compaction of
// (start, end, hash[, hash_hi]) into [B, m], zero past the count, with the
// unclipped count.  The hash is NtHash1 at width 16, 32 or 64, or the
// NtHash2-hybrid 31-bit variant: one template instance each.
//
// Replaces: rust_seq2kminmers_tpu/ops/pipeline.py:198-264, the reference
// package's general path, which XLA computes outside any Pallas kernel
// (sliding hashes, select, then K4's compaction).  The input is the packed
// HPC stream (pos << 3) | code of K4's HPC form in the hpc modes, with
// eff_len its count, or the xcodes (low 3 bits) with eff_len = lengths.
// Window i selects when lengths > l, i <= eff_len - l (i < eff_len - l in
// mode hpc, which never emits the last window) and its hash passes the
// bound (< in the SIMD modes, <= otherwise, unsigned at every width).
// start, end = i, i + l - 1, or in the hpc modes pos[i] and pos[i + l - 1]
// (hpcsimd) or pos[i + l] - 1 (hpc, with pos[L] = L).
//
// The window hash, as in K1 pass 3: the terms af[j] = rol(F[c_j], -j) and
// ar[j] = rol(R[c_j], j) combine only by XOR, so with running prefixes
// P(n) = af[0] ^ ... ^ af[n - 1] the window at i is P(i + l) ^ P(i),
// rotated by l - 1 + i (fh; by -i for rh), every amount taken mod the width.
// Rows are cut into tiles of TILE = NT * 16 windows that run in parallel; a
// thread owns one chunk of 16 consecutive windows.  l may exceed the tile,
// so i + l can lie many tiles ahead: a thread needs P at its chunk's start
// j0 and at j0 + l.  Five launches:
//
//   1. sums_kernel, grid (nt, B): each chunk's XOR of its terms, one block
//      XOR scan of them: each chunk's exclusive prefix within its tile, and
//      each tile's XOR;
//   2. prefix_kernel, one block a row: an exclusive XOR scan of the tile
//      XORs, P(t T).  P at any chunk start is then P(t T) ^ the chunk's
//      prefix within tile t, two loads; past the row, P(L) (terms past L
//      are 0: code 7's seeds are 0);
//   3. count_kernel, grid (nt, B): a thread loads P(j0) and P(c) for the
//      chunk start c <= j0 + l, adds the (j0 + l) - c terms between, walks
//      its 16 windows and selects; it saves its selection bits and its
//      first 4 survivors' hashes, and the block its survivor count;
//   4. offsets_kernel, one block a row: the tile counts' exclusive sum,
//      n_raw and n_min = min(n_raw, m);
//   5. scatter_kernel: each thread writes its survivors at offset + rank,
//      from the saved hashes, or (more than 4 survivors, a dense select)
//      by walking its windows again; each block writes zeros to 1/nt of the
//      fill with 16-byte stores.
// A walk carries its rotate amounts from position to position, so no
// position is reduced mod 31 at the nthash2 width but the first.
//
// Bound on this card: bytes.  It must read each input element before
// eff_len once (4 bytes a packed element, 1 a code; no window reads past
// it) and write 12 (16 at width 64) bytes an output slot.  It reads those
// elements three times (passes 1 and 3, stream B of pass 3 mostly from L2;
// neither pass loads past eff_len) and writes and reads ~0.75 bytes a window of
// prefixes and selection bits, and 4 (8 at width 64) bytes a survivor;
// pass 3's ~3 rotated terms and one window hash a position cost about as
// much as its bytes.

#include "common.cuh"

namespace {

constexpr int NT = 256;          // threads per block
constexpr int E = 16;            // consecutive windows (positions) a thread
constexpr int TILE = NT * E;     // windows a block
constexpr int NW = NT / 32;      // warps per block
constexpr uint32_t NO_CODE = 7;  // code 7's seeds are 0: the term past L
constexpr int SLOTS = 4;         // survivor hashes pass 3 saves a thread

// The low 3 bits of stream elements p .. p + 15 of a row of L, NO_CODE past
// L, as 16 bytes: from packed int32 elements, or from uint8 xcodes.
template <bool PACKED>
__device__ __forceinline__ uint4 codes16(const void* row, int p, int L) {
  uint32_t w[4];
  if (p + E <= L) {
    if constexpr (PACKED) {
      const int32_t* q = static_cast<const int32_t*>(row) + p;
      if (s2k::misalign(q) == 0) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int4 v = reinterpret_cast<const int4*>(q)[g];
          w[g] = (v.x & 7) | (v.y & 7) << 8 | (v.z & 7) << 16 | (v.w & 7) << 24;
        }
      } else {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          w[g] = (q[4 * g] & 7) | (q[4 * g + 1] & 7) << 8 | (q[4 * g + 2] & 7) << 16 |
                 (q[4 * g + 3] & 7) << 24;
        }
      }
      return make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      const uint4 v = s2k::load16(static_cast<const uint8_t*>(row) + p);
      return make_uint4(v.x & 0x07070707u, v.y & 0x07070707u, v.z & 0x07070707u,
                        v.w & 0x07070707u);
    }
  }
#pragma unroll
  for (int g = 0; g < 4; ++g) w[g] = NO_CODE * 0x01010101u;
#pragma unroll  // constant indices keep w in registers
  for (int e = 0; e < E; ++e) {
    if (p + e < L) {
      const uint32_t c = PACKED ? (uint32_t)static_cast<const int32_t*>(row)[p + e] & 7u
                                : (uint32_t)static_cast<const uint8_t*>(row)[p + e] & 7u;
      w[e >> 2] = (w[e >> 2] & ~(0xFFu << (8 * (e & 3)))) | c << (8 * (e & 3));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A walk over consecutive positions j of one stream: the terms of each
// position, with the rotate amount r = j mod W carried from position to
// position instead of reduced again (a division at width 31).
template <typename H>
struct Walk {
  using T = typename H::T;
  uint32_t r;
  __device__ explicit Walk(uint32_t j) : r(H::red(j)) {}
  // The terms of code c at the current position: (rol(F[c], -j), rol(R[c], j)).
  __device__ void term(const T* seed, uint32_t c, T* f, T* rr) const {
    *f = H::rolr(seed[c], r ? H::W - r : 0u);
    *rr = H::rolr(seed[8 + c], r);
  }
  __device__ void next() { r = r + 1 == H::W ? 0u : r + 1; }
};

// ---- 1. per tile: each chunk's prefix within the tile, and the tile's XOR -

// The scratch a launch shares between its passes, carved by scratch_parts:
// tile XORs [B, nt, 2] and prefixes [B, nt + 1, 2], chunk prefixes within
// their tile [2][B * nt * NT] (F, R), the threads' first SLOTS survivor
// hashes [SLOTS][B * nt * NT] (all of T), their selection bits uint32[B *
// nt * NT], tile counts and offsets int32[B, nt].
template <typename T>
struct Scratch {
  T* tile_xor;
  T* tp;
  T* chunk;
  T* hash;
  uint32_t* sel;
  int32_t* count;
  int32_t* off;
};

template <typename H, bool PACKED>
__global__ void __launch_bounds__(NT) sums_kernel(
    const void* __restrict__ stream, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ eff_len, const typename H::T* __restrict__ seeds,
    Scratch<typename H::T> sc, int L, int l, int nt) {
  using T = typename H::T;
  __shared__ T s_seed[16];
  __shared__ T s_w[2][NW];
  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (tid < 16) s_seed[tid] = seeds[tid];
  __syncthreads();
  const void* row = static_cast<const uint8_t*>(stream) + (size_t)b * L * (PACKED ? 4 : 1);
  const int j0 = t * TILE + tid * E;
  // No window reads a term at or past eff_len (nor any, lengths <= l): the
  // stream is read only before it, and the terms past it are 0 (NO_CODE).
  const int need = lengths[b] > l ? min(eff_len[b], L) : 0;
  const uint4 c = codes16<PACKED>(row, j0, need);
  T v[2] = {0, 0};
  Walk<H> w((uint32_t)j0);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    T f, r;
    w.term(s_seed, s2k::byte_of(c, e), &f, &r);
    w.next();
    v[0] ^= f;
    v[1] ^= r;
  }
  const size_t g = ((size_t)b * nt + t) * NT + tid;
  const size_t n_chunks = (size_t)gridDim.y * nt * NT;
  T inc[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    inc[k] = s2k::warp_xor_scan(v[k], lane);
    if (lane == 31) s_w[k][warp] = inc[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    sc.chunk[k * n_chunks + g] = inc[k] ^ v[k] ^ s2k::xor_below(s_w[k], lane, warp);
    const T tot = s2k::xor_below(s_w[k], lane, NW);
    if (tid == 0) sc.tile_xor[((size_t)b * nt + t) * 2 + k] = tot;
  }
}

// ---- 2. per row: P at each tile's start --------------------------------

template <typename T>
__global__ void __launch_bounds__(NT) prefix_kernel(Scratch<T> sc, int nt) {
  __shared__ T s_w[2][NW];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  T* row_tp = sc.tp + (size_t)b * (nt + 1) * 2;
  T run[2] = {0, 0};
  for (int t0 = 0; t0 < nt; t0 += NT) {
    const int t = t0 + tid;
    T v[2], inc[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      v[k] = t < nt ? sc.tile_xor[((size_t)b * nt + t) * 2 + k] : 0;
      inc[k] = s2k::warp_xor_scan(v[k], lane);
      if (lane == 31) s_w[k][warp] = inc[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 2; ++k) {  // every lane reduces: the reductions are warp-wide
      const T below = s2k::xor_below(s_w[k], lane, warp);
      if (t < nt) row_tp[2 * t + k] = run[k] ^ below ^ inc[k] ^ v[k];
      run[k] ^= s2k::xor_below(s_w[k], lane, NW);
    }
    __syncthreads();  // s_w is read above before the next chunk writes it
  }
  if (tid == 0) {
    row_tp[2 * nt] = run[0];
    row_tp[2 * nt + 1] = run[1];
  }
}

// ---- 3 and 5. the windows: count, then scatter and fill -------------------

struct Out {
  int32_t* start;
  int32_t* end;
  int32_t* hash;
  int32_t* hash_hi;  // width 64 only
};

// P (F and R) at chunk start p of row b: the tile's prefix and the chunk's
// within it, or P(L) past the row's tiles.
template <typename T>
__device__ __forceinline__ void prefix_at(const Scratch<T>& sc, int b, int nt, int p,
                                          T* pf, T* pr) {
  const T* row_tp = sc.tp + (size_t)b * (nt + 1) * 2;
  if (p >= nt * TILE) {
    *pf = row_tp[2 * nt];
    *pr = row_tp[2 * nt + 1];
    return;
  }
  const size_t n_chunks = (size_t)gridDim.y * nt * NT;
  const size_t g = (size_t)b * nt * NT + p / E;
  const int t = p / TILE;
  *pf = row_tp[2 * t] ^ sc.chunk[g];
  *pr = row_tp[2 * t + 1] ^ sc.chunk[n_chunks + g];
}

// The thread's prefixes p = P_F(j0), P_R(j0), P_F(j0 + l), P_R(j0 + l),
// and the codes of its two streams: A at j0, B at j0 + l.
template <typename H, bool PACKED>
__device__ __forceinline__ void thread_start(const Scratch<typename H::T>& sc,
                                             const typename H::T* seed, const void* row,
                                             int b, int nt, int L, int l, int j0,
                                             typename H::T* p, uint4* ca, uint4* cb) {
  using T = typename H::T;
  prefix_at(sc, b, nt, j0, &p[0], &p[1]);
  const int c = (j0 + l) & ~(E - 1), r = (j0 + l) & (E - 1);
  prefix_at(sc, b, nt, c, &p[2], &p[3]);
  const uint4 c0 = codes16<PACKED>(row, c, L);
  Walk<H> w((uint32_t)c);
#pragma unroll
  for (int e = 0; e < E - 1; ++e) {  // the terms from c to j0 + l
    if (e < r) {
      T f, rr;
      w.term(seed, s2k::byte_of(c0, e), &f, &rr);
      p[2] ^= f;
      p[3] ^= rr;
    }
    w.next();
  }
  *ca = codes16<PACKED>(row, j0, L);
  *cb = r ? s2k::bytes_at(c0, codes16<PACKED>(row, c + E, L), r) : c0;
}

// Walks a thread's 16 windows from its prefixes p[4] = P_F(j0), P_R(j0),
// P_F(j0 + l), P_R(j0 + l): visit(e, hash) for each window e <= last.
template <typename H, typename Visit>
__device__ __forceinline__ void walk_windows(const typename H::T* seed, uint4 ca,
                                             uint4 cb, int j0, int l, const typename H::T* p,
                                             int last, Visit visit) {
  using T = typename H::T;
  T pa_f = p[0], pa_r = p[1], pb_f = p[2], pb_r = p[3];
  Walk<H> a((uint32_t)j0), b((uint32_t)(j0 + l));
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e > last) break;
    // Window i = j0 + e: fh = rol(P_F(i + l) ^ P_F(i), l - 1 + i), and
    // l + i = j0 + l + e is b's position, so l - 1 + i = b.r - 1 mod W.
    const T fh = H::rolr(pa_f ^ pb_f, b.r ? b.r - 1 : H::W - 1);
    const T rh = H::rolr(pa_r ^ pb_r, a.r ? H::W - a.r : 0u);
    visit(e, fh < rh ? fh : rh);
    T f, r;
    a.term(seed, s2k::byte_of(ca, e), &f, &r);
    a.next();
    pa_f ^= f;
    pa_r ^= r;
    b.term(seed, s2k::byte_of(cb, e), &f, &r);
    b.next();
    pb_f ^= f;
    pb_r ^= r;
  }
}

// Pass 3: each thread's selection bits and first SLOTS survivor hashes,
// saved for pass 5, and the survivors per tile.
template <typename H, bool PACKED>
__global__ void __launch_bounds__(NT) count_kernel(
    const void* __restrict__ stream, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ eff_len, const typename H::T* __restrict__ seeds,
    Scratch<typename H::T> sc, int L, int l, typename H::T bound, int strict, int hpc_end,
    int nt) {
  using T = typename H::T;
  __shared__ T s_seed[16];
  __shared__ int s_tot[32];
  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  if (tid < 16) s_seed[tid] = seeds[tid];
  __syncthreads();
  const void* row = static_cast<const uint8_t*>(stream) + (size_t)b * L * (PACKED ? 4 : 1);
  const int j0 = t * TILE + tid * E;
  const int lim = min(lengths[b] > l ? eff_len[b] - l - hpc_end : -1, L - l);
  const size_t g = ((size_t)b * nt + t) * NT + tid;
  const size_t n_chunks = (size_t)gridDim.y * nt * NT;
  uint32_t sel = 0;
  if (j0 <= lim) {  // a thread past the last window reads nothing
    T p[4];
    uint4 ca, cb;
    thread_start<H, PACKED>(sc, s_seed, row, b, nt, L, l, j0, p, &ca, &cb);
    int n = 0;
    walk_windows<H>(s_seed, ca, cb, j0, l, p, min(E - 1, lim - j0), [&](int e, T h) {
      if (strict ? h < bound : h <= bound) {
        sel |= 1u << e;
        if (n < SLOTS) sc.hash[n * n_chunks + g] = h;
        ++n;
      }
    });
  }
  sc.sel[g] = sel;
  int total;
  s2k::block_exclusive_sum<NT>(__popc(sel), s_tot, &total);
  if (tid == 0) sc.count[(size_t)b * nt + t] = total;
}

// Pass 5: survivors to offset + rank while below m: a thread with at most
// SLOTS of them copies their saved hashes, one with more walks its windows
// again.  Then 1/nt of the row's zero fill.
template <typename H, bool PACKED>
__global__ void __launch_bounds__(NT) scatter_kernel(
    const void* __restrict__ stream, const typename H::T* __restrict__ seeds,
    Scratch<typename H::T> sc, const int32_t* __restrict__ n_min, Out out, int L, int l,
    int hpc_end, int m, int nt) {
  using T = typename H::T;
  __shared__ T s_seed[16];
  __shared__ int s_tot[32];
  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  if (tid < 16) s_seed[tid] = seeds[tid];
  const size_t out_row = (size_t)b * m;
  if (t < nt) {  // uniform over the block: it may scan
    const size_t g = ((size_t)b * nt + t) * NT + tid;
    const size_t n_chunks = (size_t)gridDim.y * nt * NT;
    const uint32_t sel = sc.sel[g];
    int total;
    int d = sc.off[(size_t)b * nt + t] +
            s2k::block_exclusive_sum<NT>(__popc(sel), s_tot, &total);  // syncs s_seed
    const void* row = static_cast<const uint8_t*>(stream) + (size_t)b * L * (PACKED ? 4 : 1);
    const int32_t* pk = static_cast<const int32_t*>(row);
    const int j0 = t * TILE + tid * E;
    auto write = [&](int i, T h) {  // survivor i at slot d
      int s0 = i, s1 = i + l - 1;
      if (PACKED) {
        s0 = pk[i] >> 3;
        s1 = hpc_end ? (i + l < L ? pk[i + l] >> 3 : L) - 1 : pk[i + l - 1] >> 3;
      }
      out.start[out_row + d] = s0;
      out.end[out_row + d] = s1;
      out.hash[out_row + d] = (int32_t)(uint32_t)h;
      if constexpr (sizeof(T) == 8) out.hash_hi[out_row + d] = (int32_t)(uint32_t)(h >> 32);
      ++d;
    };
    if (__popc(sel) <= SLOTS) {
      uint32_t rest = sel;
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) {
        if (rest && d < m) {
          write(j0 + __ffs(rest) - 1, sc.hash[k * n_chunks + g]);
          rest &= rest - 1;
        }
      }
    } else if (d < m) {
      T p[4];
      uint4 ca, cb;
      thread_start<H, PACKED>(sc, s_seed, row, b, nt, L, l, j0, p, &ca, &cb);
      walk_windows<H>(s_seed, ca, cb, j0, l, p, 31 - __clz(sel), [&](int e, T h) {
        if (sel >> e & 1u && d < m) write(j0 + e, h);
      });
    }
  }
  // The zeros of the output slots [t * TILE, (t + 1) * TILE) past n_min.
  const int lo = max(t * TILE, n_min[b]);
  const int hi = min(m, (t + 1) * TILE);
  if (lo >= hi) return;
  s2k::fill_range<int32_t>(out.start + out_row, lo, hi, 0);
  s2k::fill_range<int32_t>(out.end + out_row, lo, hi, 0);
  s2k::fill_range<int32_t>(out.hash + out_row, lo, hi, 0);
  if (sizeof(T) == 8) s2k::fill_range<int32_t>(out.hash_hi + out_row, lo, hi, 0);
}

// ---- 4. per row: tile offsets, n_raw and n_min ----------------------------

__global__ void __launch_bounds__(NT) offsets_kernel(
    const int32_t* __restrict__ tile_count, int32_t* __restrict__ tile_off,
    int32_t* __restrict__ n_min, int32_t* __restrict__ n_raw, int m, int nt) {
  __shared__ int s_tot[32];
  const int b = blockIdx.x;
  const int32_t* row = tile_count + (size_t)b * nt;
  const int running = s2k::row_exclusive_scan<NT>([&](int t) { return row[t]; },
                                                  tile_off + (size_t)b * nt, nt, s_tot);
  if (threadIdx.x == 0) {
    n_raw[b] = running;
    n_min[b] = min(running, m);
  }
}

// Bytes of each part of the scratch, 16-byte aligned, in Scratch's order;
// -> the total.
size_t scratch_parts(int B, int L, int tsize, size_t* parts) {
  const size_t nt = (size_t)((L + TILE - 1) / TILE), nc = (size_t)B * nt * NT;
  const size_t bytes[7] = {(size_t)B * nt * 2 * tsize, (size_t)B * (nt + 1) * 2 * tsize,
                           2 * nc * tsize, SLOTS * nc * tsize, nc * 4, (size_t)B * nt * 4,
                           (size_t)B * nt * 4};
  size_t at = 0;
  for (int k = 0; k < 7; ++k) {
    if (parts) parts[k] = at;
    at += (bytes[k] + 15) & ~(size_t)15;
  }
  return at;
}

template <typename H, bool PACKED>
cudaError_t launch(const void* stream, const void* lengths, const void* eff_len,
                   const void* seeds, Out out, void* n_min, void* n_raw, void* scratch,
                   int B, int L, int l, uint64_t bound, int strict, int hpc_end, int m,
                   cudaStream_t s) {
  using T = typename H::T;
  const int nt = (L + TILE - 1) / TILE;
  const int nt_fill = (m + TILE - 1) / TILE;
  size_t at[7];
  scratch_parts(B, L, sizeof(T), at);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  const Scratch<T> sc{reinterpret_cast<T*>(base + at[0]), reinterpret_cast<T*>(base + at[1]),
                      reinterpret_cast<T*>(base + at[2]), reinterpret_cast<T*>(base + at[3]),
                      reinterpret_cast<uint32_t*>(base + at[4]),
                      reinterpret_cast<int32_t*>(base + at[5]),
                      reinterpret_cast<int32_t*>(base + at[6])};
  const dim3 grid(nt, B);
  const T* sd = (const T*)seeds;
  sums_kernel<H, PACKED><<<grid, NT, 0, s>>>(stream, (const int32_t*)lengths,
                                             (const int32_t*)eff_len, sd, sc, L, l, nt);
  prefix_kernel<T><<<B, NT, 0, s>>>(sc, nt);
  count_kernel<H, PACKED><<<grid, NT, 0, s>>>(stream, (const int32_t*)lengths,
                                              (const int32_t*)eff_len, sd, sc, L, l,
                                              (T)bound, strict, hpc_end, nt);
  offsets_kernel<<<B, NT, 0, s>>>(sc.count, sc.off, (int32_t*)n_min, (int32_t*)n_raw, m, nt);
  scatter_kernel<H, PACKED><<<dim3(nt > nt_fill ? nt : nt_fill, B), NT, 0, s>>>(
      stream, sd, sc, (const int32_t*)n_min, out, L, l, hpc_end, m, nt);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch s2k_general_scan needs.
extern "C" size_t s2k_general_scan_scratch(int B, int L, int width) {
  return scratch_parts(B, L, width == 64 ? 8 : 4, nullptr);
}
// stream: packed int32[B, L] (packed = 1: the hpc modes) or uint8 xcodes
// [B, L]; lengths, eff_len int32[B]; seeds: 16 values of the width's type
// (forward [0, 8), reverse [8, 16)); width: 16, 32, 64, or 31 (nthash2).
// Outputs int32[B, m] start, end, hash (and hash_hi at width 64), int32[B]
// n_min and n_raw.  hpc_end: mode hpc (end = pos[i + l] - 1, and the last
// window is never emitted).
extern "C" int s2k_general_scan(const void* stream, int packed, const void* lengths,
                                const void* eff_len, const void* seeds, void* out_start,
                                void* out_end, void* out_hash, void* out_hash_hi,
                                void* n_min, void* n_raw, void* scratch, int B, int L,
                                int l, uint64_t bound, int width, int strict, int hpc_end,
                                int m, void* stream_) {
  if (B < 1 || L < 1 || l < 1 || l >= L || L >= (1 << 28) || m < 1)
    return (int)cudaErrorInvalidValue;
  if (width != 64 && bound > 0xFFFFFFFFull) return (int)cudaErrorInvalidValue;
  const Out out{(int32_t*)out_start, (int32_t*)out_end, (int32_t*)out_hash,
                (int32_t*)out_hash_hi};
  const cudaStream_t s = (cudaStream_t)stream_;
#define S2K_GENERAL(H)                                                                   \
  (packed ? launch<H, true>(stream, lengths, eff_len, seeds, out, n_min, n_raw, scratch, \
                            B, L, l, bound, strict, hpc_end, m, s)                       \
          : launch<H, false>(stream, lengths, eff_len, seeds, out, n_min, n_raw,         \
                             scratch, B, L, l, bound, strict, hpc_end, m, s))
  switch (width) {
    case 16: return (int)S2K_GENERAL(s2k::H16);
    case 31: return (int)S2K_GENERAL(s2k::H31);
    case 32: return (int)S2K_GENERAL(s2k::H32);
    case 64: return (int)S2K_GENERAL(s2k::H64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef S2K_GENERAL
}
