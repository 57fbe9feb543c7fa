// K4, ordered masked compaction: per row, the elements of up to four int32
// columns where mask[b, n] is set go, in order, to the first slots of
// out[b, 0:m]; slots past the selected count are written with each
// column's fill; selected elements past m are dropped; count[b] is the
// unclipped number selected.
//
// Replaces: rust_seq2kminmers_tpu/ops/pallas/compact_kernel.py:
// _compact_kernel (wrapper masked_compact), which the reference package's
// general pipeline runs twice: for the HPC compaction (ops/hpc.py:86-99,
// one packed (pos << 3) | code column, m = L) and for the minimizer stream
// (ops/pipeline.py:264, ops/compact.py:78-98).  What it computes is the
// same.  The TPU's 7-round lane-roll network, cyclic row rotation and SMEM
// running count exist because Mosaic has no dynamic lane addressing and
// runs its grid in order; none of them is carried over, and N need not be
// a multiple of 1024.
//
// Bound on this card: bytes.  It reads the 1-byte mask twice and each
// column's 4 bytes per element once, and writes 4 bytes per column per
// output slot.  The dense HPC compaction ([32, 1 Mbp], m = N) needs the
// whole card, which one block per row (as in K2) would leave at 32 of 132
// SMs, so the work is split into tiles of TILE elements that run in
// parallel: (1) each tile counts its mask, (2) one block per row scans the
// tile counts into tile offsets and the row's count, (3) each tile ranks
// its mask with __ballot_sync/__popc block scans and scatters its selected
// elements to offset + rank (neighbouring selected elements go to
// neighbouring slots, so the stores coalesce), and writes the fills of the
// output slots of its own index range.

#include "common.cuh"

namespace {

constexpr int NT = 512;      // threads per block
constexpr int TILE = 8192;   // mask elements (and fill slots) per block
constexpr int MAX_COLS = 4;

struct Cols {
  const int32_t* in[MAX_COLS];
  int32_t* out[MAX_COLS];
  int32_t fill[MAX_COLS];
};

__global__ void __launch_bounds__(NT) count_kernel(
    const uint8_t* __restrict__ mask, int32_t* __restrict__ tile_count,
    int N, int nt) {
  __shared__ int s_tot[32];
  const int t = blockIdx.x, b = blockIdx.y;
  const uint8_t* row = mask + (size_t)b * N;
  const int j1 = min(N, (t + 1) * TILE);
  int c = 0;
  for (int j = t * TILE + threadIdx.x; j < j1; j += NT) c += row[j] != 0;
  int total;
  s2k::block_exclusive_sum<NT>(c, s_tot, &total);
  if (threadIdx.x == 0) tile_count[(size_t)b * nt + t] = total;
}

__global__ void __launch_bounds__(NT) scan_kernel(
    const int32_t* __restrict__ tile_count, int32_t* __restrict__ tile_off,
    int32_t* __restrict__ count, int nt) {
  __shared__ int s_tot[32];
  const int b = blockIdx.x;
  int running = 0;
  for (int t0 = 0; t0 < nt; t0 += NT) {
    const int t = t0 + threadIdx.x;
    const int c = t < nt ? tile_count[(size_t)b * nt + t] : 0;
    int total;
    const int pre = s2k::block_exclusive_sum<NT>(c, s_tot, &total);
    if (t < nt) tile_off[(size_t)b * nt + t] = running + pre;
    running += total;
    __syncthreads();  // s_tot is read above before the next chunk writes it
  }
  if (threadIdx.x == 0) count[b] = running;
}

__global__ void __launch_bounds__(NT) scatter_kernel(
    const uint8_t* __restrict__ mask, const int32_t* __restrict__ tile_off,
    const int32_t* __restrict__ count, Cols cols, int ncols, int N, int m,
    int nt) {
  __shared__ int s_tot[2][32];  // alternated: one block_rank per chunk
  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t in_row = (size_t)b * N, out_row = (size_t)b * m;
  if (t < nt) {
    const uint8_t* row = mask + in_row;
    const int j1 = min(N, (t + 1) * TILE);
    int dst = tile_off[(size_t)b * nt + t];
    for (int c0 = t * TILE, it = 0; c0 < j1 && dst < m; c0 += NT, ++it) {
      const int j = c0 + tid;
      const bool sel = j < j1 && row[j] != 0;
      int cnt;
      const int d = dst + s2k::block_rank<NT>(sel, s_tot[it & 1], &cnt);
      if (sel && d < m) {
#pragma unroll  // constant indices keep `cols` in the parameter space
        for (int c = 0; c < MAX_COLS; ++c) {
          if (c < ncols) cols.out[c][out_row + d] = cols.in[c][in_row + j];
        }
      }
      dst += cnt;
    }
  }
  // The fills of the output slots [t * TILE, (t + 1) * TILE) past the count.
  const int lo = max(t * TILE, min(count[b], m));
  const int hi = min(m, (t + 1) * TILE);
  for (int d = lo + tid; d < hi; d += NT) {
#pragma unroll
    for (int c = 0; c < MAX_COLS; ++c) {
      if (c < ncols) cols.out[c][out_row + d] = cols.fill[c];
    }
  }
}

}  // namespace

// cols_in / cols_out: ncols (1 to 4) pointers each; tile_count and
// tile_off: int32 scratch of B * ceil(max(N, 1) / TILE) entries, TILE as
// s2k_masked_compact_tile() gives it.
extern "C" int s2k_masked_compact(const void* mask, const void* const* cols_in,
                                  void* const* cols_out, const int* fills,
                                  int ncols, void* tile_count, void* tile_off,
                                  void* count, int B, int N, int m,
                                  void* stream) {
  if (ncols < 1 || ncols > MAX_COLS || B < 1 || N < 0 || m < 1)
    return (int)cudaErrorInvalidValue;
  Cols cols = {};
  for (int c = 0; c < ncols; ++c) {
    cols.in[c] = (const int32_t*)cols_in[c];
    cols.out[c] = (int32_t*)cols_out[c];
    cols.fill[c] = fills[c];
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const int nt = ((N > 1 ? N : 1) + TILE - 1) / TILE;
  const int nt_out = (m + TILE - 1) / TILE;
  count_kernel<<<dim3(nt, B), NT, 0, s>>>((const uint8_t*)mask,
                                          (int32_t*)tile_count, N, nt);
  scan_kernel<<<B, NT, 0, s>>>((const int32_t*)tile_count,
                               (int32_t*)tile_off, (int32_t*)count, nt);
  scatter_kernel<<<dim3(nt > nt_out ? nt : nt_out, B), NT, 0, s>>>(
      (const uint8_t*)mask, (const int32_t*)tile_off, (const int32_t*)count,
      cols, ncols, N, m, nt);
  return (int)cudaGetLastError();
}

// The tile size, for the wrapper's scratch allocation.
extern "C" int s2k_masked_compact_tile() { return TILE; }
