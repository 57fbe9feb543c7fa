// K4, ordered masked compaction: per row, the elements of up to four int32
// or uint8 columns where mask[b, n] is set go, in order, to the first slots
// of out[b, 0:m]; slots past the selected count are written with each
// column's fill; selected elements past m are dropped; count[b] is the
// unclipped number selected.
//
// A second form, the HPC compaction of the general path, reads the xcodes
// and lengths instead of a mask and columns: base j of row b is kept when
// its keep bit (8) is set and j < lengths[b], and its one output column is
// (j << 3) | (x & 7), filled with (L << 3) | CODE_PAD, m = L.
//
// Replaces: rust_seq2kminmers_tpu/ops/pallas/compact_kernel.py:
// _compact_kernel (wrapper masked_compact), which the reference package's
// general pipeline runs twice: for the HPC compaction (ops/hpc.py:86-99,
// one packed (pos << 3) | code column, m = L) and for the minimizer stream
// (ops/pipeline.py:264, ops/compact.py:78-98).  What it computes is the
// same.  The TPU's 7-round lane-roll network, cyclic row rotation and SMEM
// running count exist because Mosaic has no dynamic lane addressing and
// runs its grid in order; none of them is carried over, and N need not be
// a multiple of 1024.  The port's general path runs the HPC form; the
// minimizer stream is compacted inside general_scan.cu.
//
// Bound on this card: bytes.  It reads the mask (or the xcodes) twice and
// each column's selected elements once, and writes every output slot once.
// The dense HPC compaction ([32, 1 Mbp], m = N) needs the whole card, so
// each row is cut into tiles of TILE = NT * 16 elements that run in
// parallel, in three launches: (1) each tile counts its mask, (2) one block
// a row scans the tile counts into tile offsets and the row's count, (3)
// each tile scatters.  A thread owns 16 consecutive elements: its mask in
// one 16-byte load, its int32 columns in 16-byte loads of the 4-element
// groups that hold a selected element (so a sparse mask reads few column
// bytes), uint8 columns in one.  Ranks are per-thread popcounts and one
// block scan a tile (2 barriers).  Each warp stages its selected values in
// shared memory at their warp ranks and writes them out at consecutive
// slots, so the stores coalesce although every thread owns a run of
// elements; fills go out in 16-byte stores.  A single decoupled look-back
// pass would save the count launch's read of the mask (1 byte of the ~9 a
// dense element moves) at the cost of a device-wide ordering protocol, so
// the three launches stay.

#include "common.cuh"

namespace {

constexpr int NT = 256;          // threads per block
constexpr int E = 16;            // consecutive elements a thread
constexpr int TILE = NT * E;     // elements (and fill slots) per block
constexpr int NW = NT / 32;      // warps per block
constexpr int MAX_COLS = 4;
constexpr uint32_t CODE_PAD = 6;
constexpr uint32_t KEEP = 8;

struct Cols {
  const void* in[MAX_COLS];
  void* out[MAX_COLS];
  int fill[MAX_COLS];
  int size[MAX_COLS];  // bytes an element: 4 (int32) or 1 (uint8)
};

// The source of the selection: a bool mask, or (HPC form) the xcodes'
// keep bits before each row's length.
struct Src {
  const uint8_t* bytes;     // mask or xcodes [B, N]
  const int32_t* lengths;   // HPC form only
};

// Bit e: element j0 + e of the row is selected (j0 + e < N).  `v` gets the
// 16 source bytes (0 past N).
template <bool HPC>
__device__ __forceinline__ uint32_t select_bits(const Src& src, int b, int N,
                                                int j0, uint4* v) {
  const uint8_t* row = src.bytes + (size_t)b * N;
  uint4 x = make_uint4(0, 0, 0, 0);
  if (j0 + E <= N) {
    x = s2k::load16(row + j0);
  } else {
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll  // constant indices keep w in registers
    for (int e = 0; e < E; ++e) {
      if (j0 + e < N) w[e >> 2] |= (uint32_t)row[j0 + e] << (8 * (e & 3));
    }
    x = make_uint4(w[0], w[1], w[2], w[3]);
  }
  *v = x;
  const int lim = HPC ? min(N, src.lengths[b]) : N;
  uint32_t bits = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const uint32_t c = s2k::byte_of(x, e);
    bits |= (uint32_t)((HPC ? (c & KEEP) != 0 : c != 0) && j0 + e < lim) << e;
  }
  return bits;
}

template <bool HPC>
__global__ void __launch_bounds__(NT) count_kernel(Src src, int32_t* __restrict__ tile_count,
                                                   int N, int nt) {
  __shared__ int s_tot[32];
  const int t = blockIdx.x, b = blockIdx.y;
  const int j0 = t * TILE + threadIdx.x * E;
  uint4 v;
  const int c = j0 < N ? __popc(select_bits<HPC>(src, b, N, j0, &v)) : 0;
  int total;
  s2k::block_exclusive_sum<NT>(c, s_tot, &total);
  if (threadIdx.x == 0) tile_count[(size_t)b * nt + t] = total;
}

__global__ void __launch_bounds__(NT) scan_kernel(
    const int32_t* __restrict__ tile_count, int32_t* __restrict__ tile_off,
    int32_t* __restrict__ count, int nt) {
  __shared__ int s_tot[32];
  const int b = blockIdx.x;
  const int32_t* row = tile_count + (size_t)b * nt;
  const int n = s2k::row_exclusive_scan<NT>([&](int t) { return row[t]; },
                                            tile_off + (size_t)b * nt, nt, s_tot);
  if (threadIdx.x == 0) count[b] = n;
}

// The thread's selected values of a column of W-byte elements, in element
// order, to stage[0 ..); the row starts at element `row`.
template <int W>
__device__ __forceinline__ void gather(const void* col, size_t row, int N, int j0,
                                       uint32_t bits, int32_t* stage) {
  const unsigned char* base = static_cast<const unsigned char*>(col) + row * W;
  int k = 0;
  if (W == 1) {
    uint4 x;
    if (j0 + E <= N) {
      x = s2k::load16(base + j0);
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (j0 + e < N) w[e >> 2] |= (uint32_t)base[j0 + e] << (8 * (e & 3));
      }
      x = make_uint4(w[0], w[1], w[2], w[3]);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (bits >> e & 1u) stage[k++] = (int32_t)s2k::byte_of(x, e);
    }
    return;
  }
  const int32_t* p = reinterpret_cast<const int32_t*>(base) + j0;
  if (j0 + E <= N && s2k::misalign(p) == 0) {
#pragma unroll
    for (int g = 0; g < E / 4; ++g) {
      if ((bits >> (4 * g)) & 0xFu) {
        const int4 q = reinterpret_cast<const int4*>(p)[g];
        if (bits >> (4 * g) & 1u) stage[k++] = q.x;
        if (bits >> (4 * g + 1) & 1u) stage[k++] = q.y;
        if (bits >> (4 * g + 2) & 1u) stage[k++] = q.z;
        if (bits >> (4 * g + 3) & 1u) stage[k++] = q.w;
      }
    }
  } else {
    for (uint32_t m = bits; m; m &= m - 1) stage[k++] = p[__ffs(m) - 1];
  }
}

template <bool HPC>
__global__ void __launch_bounds__(NT) scatter_kernel(
    Src src, const int32_t* __restrict__ tile_off, const int32_t* __restrict__ count,
    Cols cols, int ncols, int N, int m, int nt) {
  __shared__ int s_tot[32];
  __shared__ int32_t s_stage[NW][32 * E];  // each warp's selected values
  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t out_row = (size_t)b * m;
  if (t < nt) {  // uniform over the block: it may scan
    const int j0 = t * TILE + tid * E;
    uint4 v = make_uint4(0, 0, 0, 0);
    const uint32_t bits = j0 < N ? select_bits<HPC>(src, b, N, j0, &v) : 0u;
    const int n = __popc(bits);
    int total;
    const int pre = s2k::block_exclusive_sum<NT>(n, s_tot, &total);
    // The warp's slots start at dst; this thread's at dst + (pre - wpre).
    const int wpre = __shfl_sync(s2k::FULL, pre, 0);
    const int wn = __shfl_sync(s2k::FULL, pre + n, 31) - wpre;
    const int dst = tile_off[(size_t)b * nt + t] + wpre;
    int32_t* stage = s_stage[warp];
    int32_t* mine = stage + (pre - wpre);
    if (dst < m && wn > 0) {  // uniform over the warp
#pragma unroll
      for (int c = 0; c < MAX_COLS; ++c) {
        if (c >= ncols) break;
        if (HPC) {
          int k = 0;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            if (bits >> e & 1u) mine[k++] = ((j0 + e) << 3) | (int)(s2k::byte_of(v, e) & 7u);
          }
        } else if (cols.size[c] == 1) {
          gather<1>(cols.in[c], (size_t)b * N, N, j0, bits, mine);
        } else {
          gather<4>(cols.in[c], (size_t)b * N, N, j0, bits, mine);
        }
        __syncwarp();
        const int hi = min(wn, m - dst);
        if (cols.size[c] == 1) {
          uint8_t* o = static_cast<uint8_t*>(cols.out[c]) + out_row + dst;
          for (int i = lane; i < hi; i += 32) o[i] = (uint8_t)stage[i];
        } else {
          int32_t* o = static_cast<int32_t*>(cols.out[c]) + out_row + dst;
          for (int i = lane; i < hi; i += 32) o[i] = stage[i];
        }
        __syncwarp();  // the stage is read before the next column's writes
      }
    }
  }
  // The fills of the output slots [t * TILE, (t + 1) * TILE) past the count.
  const int lo = max(t * TILE, min(count[b], m));
  const int hi = min(m, (t + 1) * TILE);
  if (lo >= hi) return;
#pragma unroll
  for (int c = 0; c < MAX_COLS; ++c) {
    if (c >= ncols) break;
    if (cols.size[c] == 1) {
      s2k::fill_range<uint8_t>(static_cast<uint8_t*>(cols.out[c]) + out_row, lo, hi,
                               (uint8_t)cols.fill[c]);
    } else {
      s2k::fill_range<int32_t>(static_cast<int32_t*>(cols.out[c]) + out_row, lo, hi,
                               (int32_t)cols.fill[c]);
    }
  }
}

template <bool HPC>
cudaError_t launch(const Src& src, const Cols& cols, int ncols, void* tile_count,
                   void* tile_off, void* count, int B, int N, int m, cudaStream_t s) {
  const int nt = ((N > 1 ? N : 1) + TILE - 1) / TILE;
  const int nt_out = (m + TILE - 1) / TILE;
  count_kernel<HPC><<<dim3(nt, B), NT, 0, s>>>(src, (int32_t*)tile_count, N, nt);
  scan_kernel<<<B, NT, 0, s>>>((const int32_t*)tile_count, (int32_t*)tile_off,
                               (int32_t*)count, nt);
  scatter_kernel<HPC><<<dim3(nt > nt_out ? nt : nt_out, B), NT, 0, s>>>(
      src, (const int32_t*)tile_off, (const int32_t*)count, cols, ncols, N, m, nt);
  return cudaGetLastError();
}

}  // namespace

// cols_in / cols_out: ncols (1 to 4) pointers each; sizes: bytes an element
// of each column (4 or 1); tile_count and tile_off: int32 scratch of B *
// ceil(max(N, 1) / TILE) entries, TILE as s2k_masked_compact_tile() gives
// it.
extern "C" int s2k_masked_compact(const void* mask, const void* const* cols_in,
                                  void* const* cols_out, const int* fills,
                                  const int* sizes, int ncols, void* tile_count,
                                  void* tile_off, void* count, int B, int N, int m,
                                  void* stream) {
  if (ncols < 1 || ncols > MAX_COLS || B < 1 || N < 0 || m < 1)
    return (int)cudaErrorInvalidValue;
  Cols cols = {};
  for (int c = 0; c < ncols; ++c) {
    if (sizes[c] != 1 && sizes[c] != 4) return (int)cudaErrorInvalidValue;
    cols.in[c] = cols_in[c];
    cols.out[c] = cols_out[c];
    cols.fill[c] = fills[c];
    cols.size[c] = sizes[c];
  }
  return (int)launch<false>(Src{(const uint8_t*)mask, nullptr}, cols, ncols, tile_count,
                            tile_off, count, B, N, m, (cudaStream_t)stream);
}

// The HPC form: codes uint8[B, L] xcodes, lengths int32[B] -> packed
// int32[B, L], count int32[B]; scratch as for s2k_masked_compact with N = L.
extern "C" int s2k_hpc_compact(const void* codes, const void* lengths, void* packed,
                               void* tile_count, void* tile_off, void* count, int B,
                               int L, void* stream) {
  if (B < 1 || L < 1 || L >= (1 << 28)) return (int)cudaErrorInvalidValue;
  Cols cols = {};
  cols.out[0] = packed;
  cols.fill[0] = (L << 3) | (int)CODE_PAD;
  cols.size[0] = 4;
  return (int)launch<true>(Src{(const uint8_t*)codes, (const int32_t*)lengths}, cols, 1,
                           tile_count, tile_off, count, B, L, L, (cudaStream_t)stream);
}

// The tile size, for the wrapper's scratch allocation.
extern "C" int s2k_masked_compact_tile() { return TILE; }
