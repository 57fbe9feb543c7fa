// K3, k-min-mer assembly: mix of each minimizer hash to u64 (xorshift of a
// u32, murmur of a u16, identity of a u64 given as (hi, lo) words), then
// per k-window the canonical minimizer-space NtHash
//   f = XOR_q rol64(m_{w+q}, k-1-q),  r = XOR_q rol64(m_{w+q}, q),
//   hash = min(f, r),  rev = r < f
// (the rotate-by-rank form of the TPU kernel, with the window's own rank
// folded in).  Given the stream's counts n_min, it also writes the final
// k-min-mer fields of the pipeline: windows w < n_km = max(n_min - (k-1),
// 0) get their hash, rev, start = min_start[w] and end = min_end[w+k-1];
// later windows are zero (false), and n_kminmers = n_km.
//
// Replaces: rust_seq2kminmers_tpu/ops/pallas/assemble_kernel.py:
// _assemble_kernel (wrapper assemble_kminmers_pallas), which takes the
// xorshift mix only, and the masking after it
// (rust_seq2kminmers_tpu/ops/pipeline.py:477-495); the reference package
// runs the u16 and u64 mixes in XLA (ops/pipeline.py:448-470).  The TPU
// emulated u64 as (hi, lo) int32 pairs and fell back to XLA above 32768
// slots; here it is native uint64_t with no size limit, and the mix is a
// template parameter.
//
// Bound on this card: bytes (the valid windows' words, starts and ends
// read; 17 bytes a window written).  Each thread takes G = 8 consecutive
// windows of the flat [B * (M-k+1)] output: it loads and mixes each of
// the G + k - 1 words under them once, computes its first window directly
// and rolls to the next G - 1 (f' = rol(f, 1) ^ rol(m_w, k) ^ m_{w+k},
// r' = ror(r ^ m_w, 1) ^ rol(m_{w+k}, k-1)), and stores each column with
// 16-byte stores (8 bytes for rev), aligned because G windows of the flat
// output start at a multiple of 8.  A group of windows wholly past its
// row's n_km loads nothing.  The few groups that straddle two rows, or
// end the output, take each window on its own with scalar stores.

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int G = 8;  // windows a thread

struct Args {
  const int32_t* min_hash;     // [B, M] low words
  const int32_t* min_hash_hi;  // [B, M] high words, width 64 only
  const int32_t* min_start;    // [B, M], with n_min
  const int32_t* min_end;      // [B, M], with n_min
  const int32_t* n_min;        // [B] or null: every window is valid
  int32_t* out_hi;             // [B, nwin]
  int32_t* out_lo;
  uint8_t* out_rev;
  int32_t* out_start;  // with n_min
  int32_t* out_end;    // with n_min
  int32_t* n_kminmers;  // [B], with n_min
  int M, k, nwin;
  size_t total;  // B * nwin
};

// Word j of a row, mixed to u64.
template <int WIDTH>
__device__ __forceinline__ uint64_t mix(const int32_t* __restrict__ lo,
                                        const int32_t* __restrict__ hi, int j) {
  if constexpr (WIDTH == 64) {
    return ((uint64_t)(uint32_t)hi[j] << 32) | (uint32_t)lo[j];
  } else if constexpr (WIDTH == 16) {
    uint64_t x = (uint32_t)lo[j] & 0xFFFFu;
    x ^= s2k::rol64(x, 33);
    x *= 0xFF51AFD7ED558CCDull;
    x ^= s2k::rol64(x, 33);
    x *= 0xC4CEB9FE1A85EC53ull;
    return x ^ s2k::rol64(x, 33);
  } else {
    uint64_t x = (uint32_t)lo[j];
    x ^= x << 13;
    x ^= x >> 7;
    x ^= x << 17;
    return x;
  }
}

__device__ __forceinline__ int kminmers_of(const Args& a, size_t b) {
  return a.n_min ? max(a.n_min[b] - (a.k - 1), 0) : a.nwin;
}

// One window at flat index f, from its k words; scalar stores.
template <int WIDTH>
__device__ void one_window(const Args& a, size_t f) {
  const size_t b = f / a.nwin;
  const int w = (int)(f - b * a.nwin);
  const int n_km = kminmers_of(a, b);
  if (w == 0 && a.n_kminmers) a.n_kminmers[b] = n_km;
  uint32_t hi = 0, lo = 0;
  int32_t st = 0, en = 0;
  bool rev = false;
  if (w < n_km) {
    const size_t row = b * a.M + w;
    uint64_t fh = 0, rh = 0;
    for (int q = 0; q < a.k; ++q) {
      const uint64_t x = mix<WIDTH>(a.min_hash + row, a.min_hash_hi + row, q);
      fh ^= s2k::rol64(x, (uint32_t)(a.k - 1 - q));
      rh ^= s2k::rol64(x, (uint32_t)q);
    }
    rev = rh < fh;
    const uint64_t h = rev ? rh : fh;
    hi = (uint32_t)(h >> 32);
    lo = (uint32_t)h;
    if (a.n_min) {
      st = a.min_start[row];
      en = a.min_end[row + a.k - 1];
    }
  }
  a.out_hi[f] = (int32_t)hi;
  a.out_lo[f] = (int32_t)lo;
  a.out_rev[f] = rev;
  if (a.n_min) {
    a.out_start[f] = st;
    a.out_end[f] = en;
  }
}

__device__ __forceinline__ void store8(int32_t* p, const uint32_t* v) {
  int4* q = reinterpret_cast<int4*>(p);
  q[0] = make_int4((int)v[0], (int)v[1], (int)v[2], (int)v[3]);
  q[1] = make_int4((int)v[4], (int)v[5], (int)v[6], (int)v[7]);
}

template <int WIDTH>
__global__ void __launch_bounds__(NT) assemble_kernel(const Args a) {
  const size_t g0 = ((size_t)blockIdx.x * NT + threadIdx.x) * G;
  if (g0 >= a.total) return;
  const size_t b = g0 / a.nwin;
  const int w0 = (int)(g0 - b * a.nwin);
  if (w0 + G > a.nwin || g0 + G > a.total) {  // straddles rows, or the end
    for (int i = 0; i < G && g0 + i < a.total; ++i) one_window<WIDTH>(a, g0 + i);
    return;
  }
  const int k = a.k;
  const int n_km = kminmers_of(a, b);
  if (w0 == 0 && a.n_kminmers) a.n_kminmers[b] = n_km;
  uint32_t hi[G], lo[G], st[G], en[G];
  uint32_t rev_lo = 0, rev_hi = 0;  // rev of windows 0-3 and 4-7, a byte each
#pragma unroll
  for (int i = 0; i < G; ++i) hi[i] = lo[i] = st[i] = en[i] = 0;
  if (w0 < n_km) {
    const size_t row = b * a.M + w0;
    const int32_t* wl = a.min_hash + row;
    const int32_t* wh = a.min_hash_hi + row;
    // x[j] = word j mixed: the words the rolls drop, and the first words
    // of window 0.
    uint64_t x[G - 1];
#pragma unroll
    for (int j = 0; j < G - 1; ++j) x[j] = mix<WIDTH>(wl, wh, j);
    uint64_t f = 0, r = 0;
#pragma unroll
    for (int j = 0; j < G - 1; ++j) {
      if (j < k) {
        f ^= s2k::rol64(x[j], (uint32_t)(k - 1 - j));
        r ^= s2k::rol64(x[j], (uint32_t)j);
      }
    }
    for (int j = G - 1; j < k; ++j) {
      const uint64_t v = mix<WIDTH>(wl, wh, j);
      f ^= s2k::rol64(v, (uint32_t)(k - 1 - j));
      r ^= s2k::rol64(v, (uint32_t)j);
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (i > 0) {  // roll from window i - 1: drop word i - 1, add word i - 1 + k
        const int jin = i - 1 + k;
        uint64_t v = 0;
        if (jin < G - 1) {  // mixed already (k < G - 1): select it
#pragma unroll
          for (int j = 0; j < G - 1; ++j)
            if (j == jin) v = x[j];
        } else {
          v = mix<WIDTH>(wl, wh, jin);
        }
        f = s2k::rol64(f, 1) ^ s2k::rol64(x[i - 1], (uint32_t)k) ^ v;
        r = s2k::rol64(r ^ x[i - 1], 63) ^ s2k::rol64(v, (uint32_t)(k - 1));
      }
      if (w0 + i < n_km) {
        const bool rv = r < f;
        const uint64_t h = rv ? r : f;
        hi[i] = (uint32_t)(h >> 32);
        lo[i] = (uint32_t)h;
        if (i < 4) rev_lo |= (uint32_t)rv << (8 * i);
        else rev_hi |= (uint32_t)rv << (8 * (i - 4));
        if (a.n_min) {
          st[i] = (uint32_t)a.min_start[row + i];
          en[i] = (uint32_t)a.min_end[row + i + k - 1];
        }
      }
    }
  }
  store8(a.out_hi + g0, hi);
  store8(a.out_lo + g0, lo);
  *reinterpret_cast<uint2*>(a.out_rev + g0) = make_uint2(rev_lo, rev_hi);
  if (a.n_min) {
    store8(a.out_start + g0, st);
    store8(a.out_end + g0, en);
  }
}

}  // namespace

// min_hash_hi is read only at hash_width 64.  With n_min (int32[B]), the
// masked fields: min_start, min_end, out_start, out_end and n_kminmers must
// be given too; without it, every window is computed and those are null.
// The outputs are [B, M - k + 1], each 16-byte aligned.
extern "C" int s2k_assemble(const void* min_hash, const void* min_hash_hi,
                            const void* min_start, const void* min_end,
                            const void* n_min, void* out_hi, void* out_lo,
                            void* out_rev, void* out_start, void* out_end,
                            void* n_kminmers, int B, int M, int k,
                            int hash_width, void* stream) {
  const bool masked = n_min != nullptr;
  if (B < 1 || k < 1 || k > M || (hash_width == 64 && min_hash_hi == nullptr))
    return (int)cudaErrorInvalidValue;
  const void* const with_n_min[] = {min_start, min_end, out_start, out_end,
                                    n_kminmers};
  for (const void* p : with_n_min)
    if ((p != nullptr) != masked) return (int)cudaErrorInvalidValue;
  // Below width 64 the high words are never read; the row pointers the
  // kernel forms from them stay inside the low words' allocation.
  Args a{(const int32_t*)min_hash,
         (const int32_t*)(min_hash_hi ? min_hash_hi : min_hash),
         (const int32_t*)min_start, (const int32_t*)min_end,
         (const int32_t*)n_min, (int32_t*)out_hi, (int32_t*)out_lo,
         (uint8_t*)out_rev, (int32_t*)out_start, (int32_t*)out_end,
         (int32_t*)n_kminmers, M, k, M - k + 1, (size_t)B * (M - k + 1)};
  const size_t groups = (a.total + G - 1) / G;
  const unsigned blocks = (unsigned)((groups + NT - 1) / NT);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (hash_width) {
    case 16: assemble_kernel<16><<<blocks, NT, 0, s>>>(a); break;
    case 32: assemble_kernel<32><<<blocks, NT, 0, s>>>(a); break;
    case 64: assemble_kernel<64><<<blocks, NT, 0, s>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* s2k_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
