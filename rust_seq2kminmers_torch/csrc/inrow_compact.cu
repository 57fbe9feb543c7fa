// K5 and K6, in-row compaction: for each 128-lane row, left-pack the
// payloads whose keep flag is set, in order, and fill the rest with zeros.
// Up to four payloads share one keep mask.  Payloads are f32 but move as
// their 32-bit patterns, so the move is exact for any value.
//
// Replaces: scripts/prof_mxu_compact.py, the two kernels that profiling
// script races on the same work:
//   K5 roll_kernel (run_roll) -> inrow_compact_ballot.  The TPU has no
//      scatter, so it moved each element by its rank deficit through 7
//      rounds of lane rolls and selects.  Here one warp owns a row, 4
//      elements a thread: __ballot_sync/__popc give each kept element its
//      rank, a scatter into shared memory places it, and the row is written
//      back coalesced with the zero fill.
//   K6 onehot_kernel (run_onehot) -> inrow_compact_mma.  The same function
//      as a one-hot permutation product on the matrix units:
//      out[i] = sum_j x[j] * P[j, i], P[j, i] = keep[j] && rank[j] == i.
//      The TPU ran it in f32 at HIGHEST precision (its default rounds f32
//      through bf16 and corrupted the payloads).  Here the product is
//      integer: the payloads' bytes are the A operand of
//      mma.m16n8k32.s32.u8.u8.s32 (4 payloads x 4 bytes = the 16 rows), P
//      is the B operand, built in registers from the ranks, and every
//      output is one product of a byte with 1 or 0, so s32 accumulation is
//      exact.  128 sources = 4 k-steps, 128 destinations = 16 n-tiles: 64
//      mma a row.  The output bytes are reassembled in shared memory.
//
// Bound on this card: both read 4 bytes a payload and the keep flag per
// element and write 4 bytes a payload (16-20 B an element at 4 payloads),
// so both are memory-bound at the main path's 32 Mi elements; K6 adds 64
// mma and ~32 byte-packing shared loads a thread per row on top of K5's
// work.  The question the profiling script asks is whether that extra
// work hides under the memory time.

#include "common.cuh"

namespace {

constexpr int LANES = 128;  // elements per row
constexpr int ROWS = 8;     // rows per block: one warp each
constexpr int MAXPAY = 4;

struct Payloads {
  const uint32_t* x[MAXPAY];
  uint32_t* o[MAXPAY];
};

// Per thread: the keep flags and in-row ranks of elements q * 32 + lane,
// q < 4, and the row's kept count.
__device__ __forceinline__ int row_ranks(const float* keep_row, int lane,
                                         bool (&kp)[4], int (&rank)[4]) {
  int count = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    kp[q] = keep_row[q * 32 + lane] != 0.0f;
    const unsigned m = __ballot_sync(0xffffffffu, kp[q]);
    rank[q] = count + __popc(m & ((1u << lane) - 1u));
    count += __popc(m);
  }
  return count;
}

__global__ void __launch_bounds__(ROWS * 32)
    inrow_ballot_kernel(Payloads p, const float* __restrict__ keep, int npay,
                        int R) {
  __shared__ uint32_t s_row[ROWS][LANES];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int row = blockIdx.x * ROWS + w;
  if (row >= R) return;  // whole warps only; no block barrier below
  const size_t base = (size_t)row * LANES;
  bool kp[4];
  int rank[4];
  const int count = row_ranks(keep + base, lane, kp, rank);
  uint32_t* s = s_row[w];
#pragma unroll
  for (int pi = 0; pi < MAXPAY; ++pi) {
    if (pi >= npay) break;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (kp[q]) s[rank[q]] = p.x[pi][base + q * 32 + lane];
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = q * 32 + lane;
      p.o[pi][base + i] = i < count ? s[i] : 0u;
    }
    __syncwarp();
  }
}

// D += A * B for one m16n8k32 tile: A 16 x 32 u8 (row-major fragments),
// B 32 x 8 u8 (column-major fragments), D 16 x 8 s32.
__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(ROWS * 32)
    inrow_mma_kernel(Payloads p, const float* __restrict__ keep, int npay,
                     int R) {
  __shared__ uint32_t s_x[ROWS][MAXPAY][LANES];    // payloads (0 past npay)
  __shared__ uint32_t s_out[ROWS][MAXPAY][LANES];  // written byte by byte
  __shared__ uint32_t s_rank[ROWS][LANES / 4];     // u8 ranks, 0xFF = dropped
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int row = blockIdx.x * ROWS + w;
  if (row >= R) return;  // whole warps only; no block barrier below
  const size_t base = (size_t)row * LANES;
  bool kp[4];
  int rank[4];
  row_ranks(keep + base, lane, kp, rank);
  uint8_t* rk8 = reinterpret_cast<uint8_t*>(s_rank[w]);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = q * 32 + lane;
    rk8[j] = kp[q] ? (uint8_t)rank[q] : (uint8_t)0xFF;
#pragma unroll
    for (int pi = 0; pi < MAXPAY; ++pi) {
      s_x[w][pi][j] = pi < npay ? p.x[pi][base + j] : 0u;
    }
  }
  __syncwarp();

  // Fragment coordinates (PTX ISA, mma.m16n8k32 with .u8): g = lane / 4,
  // t = lane % 4.  A register r holds row g (r = 0, 2) or g + 8 (r = 1, 3)
  // and columns 4t .. 4t+3 (r < 2) or 16 + 4t .. (r >= 2).  A row
  // m = 4 * payload + byte: rows g and g + 8 are byte g % 4 of payloads
  // g / 4 and 2 + g / 4.  B register r holds rows 4t .. 4t+3 (+16 for
  // r = 1) of column g.  D holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
  const int g = lane >> 2, t = lane & 3;
  const int byte = g & 3, pa = g >> 2, pb = 2 + (g >> 2);
  const int sh = 8 * byte;
  auto bytes4 = [&](int pay, int j0) {  // byte `byte` of sources j0 .. j0+3
    uint32_t v = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v |= ((s_x[w][pay][j0 + u] >> sh) & 0xFFu) << (8 * u);
    }
    return v;
  };
  uint32_t a[4][4], rw[4][2];
#pragma unroll
  for (int s = 0; s < 4; ++s) {  // k-step s: sources 32s .. 32s+31
    const int j0 = 32 * s + 4 * t;
    a[s][0] = bytes4(pa, j0);
    a[s][1] = bytes4(pb, j0);
    a[s][2] = bytes4(pa, j0 + 16);
    a[s][3] = bytes4(pb, j0 + 16);
    rw[s][0] = s_rank[w][j0 / 4];  // ranks of sources j0 .. j0+3
    rw[s][1] = s_rank[w][j0 / 4 + 4];
  }
  uint8_t* ob = reinterpret_cast<uint8_t*>(s_out[w]);  // [pay][dst][byte]
#pragma unroll 4
  for (int nt = 0; nt < LANES / 8; ++nt) {  // destinations 8nt .. 8nt+7
    // B column g is destination 8nt + g: a 1 where a source's rank is it.
    const uint32_t n4 = (uint32_t)(8 * nt + g) * 0x01010101u;
    int d[4] = {0, 0, 0, 0};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      mma_u8(d, a[s], __vcmpeq4(rw[s][0], n4) & 0x01010101u,
             __vcmpeq4(rw[s][1], n4) & 0x01010101u);
    }
    const int i0 = 8 * nt + 2 * t;
    ob[(pa * LANES + i0) * 4 + byte] = (uint8_t)d[0];
    ob[(pa * LANES + i0 + 1) * 4 + byte] = (uint8_t)d[1];
    ob[(pb * LANES + i0) * 4 + byte] = (uint8_t)d[2];
    ob[(pb * LANES + i0 + 1) * 4 + byte] = (uint8_t)d[3];
  }
  __syncwarp();
#pragma unroll
  for (int pi = 0; pi < MAXPAY; ++pi) {
    if (pi >= npay) break;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = q * 32 + lane;
      p.o[pi][base + i] = s_out[w][pi][i];
    }
  }
}

Payloads payloads(const void* x0, const void* x1, const void* x2,
                  const void* x3, void* o0, void* o1, void* o2, void* o3) {
  Payloads p;
  const void* xs[MAXPAY] = {x0, x1, x2, x3};
  void* os[MAXPAY] = {o0, o1, o2, o3};
  for (int i = 0; i < MAXPAY; ++i) {
    p.x[i] = (const uint32_t*)xs[i];
    p.o[i] = (uint32_t*)os[i];
  }
  return p;
}

}  // namespace

// x0..x3 and o0..o3: f32[R, 128] payloads and outputs, the first npay
// given (the rest may be null); keep: f32[R, 128], nonzero = keep.
#define S2K_INROW_ENTRY(NAME, KERNEL)                                        \
  extern "C" int NAME(const void* x0, const void* x1, const void* x2,        \
                      const void* x3, const void* keep, void* o0, void* o1,  \
                      void* o2, void* o3, int npay, int R, void* stream) {   \
    if (npay < 1 || npay > MAXPAY || R < 1) return (int)cudaErrorInvalidValue; \
    KERNEL<<<(R + ROWS - 1) / ROWS, ROWS * 32, 0, (cudaStream_t)stream>>>(   \
        payloads(x0, x1, x2, x3, o0, o1, o2, o3), (const float*)keep, npay,  \
        R);                                                                  \
    return (int)cudaGetLastError();                                          \
  }

S2K_INROW_ENTRY(s2k_inrow_compact_ballot, inrow_ballot_kernel)
S2K_INROW_ENTRY(s2k_inrow_compact_mma, inrow_mma_kernel)

#undef S2K_INROW_ENTRY
