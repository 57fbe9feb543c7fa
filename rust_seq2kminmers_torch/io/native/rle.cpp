// Host string kernels behind the port's string API, built by g++ into a
// plain C library and loaded with ctypes (io/native_ext.py):
//
//   * run-length collapse (hpc_strings.py: hpc, encode_rle,
//     encode_rle_simd; the reference crate's src/hpc.rs): the kept bytes
//     and, where asked for, each one's position in the input;
//   * xcode encoding (constants.encode_xcodes): (keep << 3) | code, keep
//     set where a byte differs from the byte before it.
//
// A port of the reference package's rust_seq2kminmers_tpu/io/native/
// rle_kernels.h with its CPython entry points (s2kext.cpp: rle, rle_loop,
// xcode) turned into extern "C" functions.  The AVX-512 path builds each
// 64-byte step's keep mask from one shifted byte compare and writes the kept
// bytes (epi8) and positions (epi32 / epi64) with VBMI2 compress-stores;
// the scalar path is a byte loop.  A ctypes caller cannot write into a new
// str's buffer, so the collapse runs in two calls: s2k_rle_plan counts the
// kept bytes (and, from 4 MB on, each thread's share and offset), the
// caller allocates exact-size arrays, s2k_rle_store fills them (no
// worst-case buffer is ever touched).  Every entry point takes `path`: 0
// picks the AVX-512 kernels where the CPU has them, 1 forces the scalar
// ones.

#include <immintrin.h>
#include <malloc.h>

#include <algorithm>
#include <array>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kParallelMin = 4 << 20;  // bytes: the plan's threads above this
constexpr int64_t kMaxThreads = 4;
constexpr int kPathScalar = 1;

// Error codes of the entry points (0 is success).
constexpr int kErrArgs = 1;     // an argument is out of range
constexpr int kErrPos32 = 2;    // 32-bit positions for n >= 2^31
constexpr int kErrNoMemory = 3;

const std::array<bool, 256>& collapsible_table() {
  static const std::array<bool, 256> t = [] {
    std::array<bool, 256> a{};
    for (const char* p = "ACTGactgNn"; *p; p++) a[static_cast<uint8_t>(*p)] = true;
    return a;
  }();
  return t;
}

inline bool kept(const uint8_t* seq, int64_t i, int collapse_any,
                 const std::array<bool, 256>& coll) {
  return seq[i] != seq[i - 1] || (!collapse_any && !coll[seq[i]]);
}

// out_pos may be null (hpc needs only the kept bytes).
template <typename PosT>
int64_t rle_scalar(const uint8_t* seq, int64_t i0, int64_t i1, int collapse_any,
                   uint8_t* out_chars, PosT* out_pos, int64_t m) {
  const auto& coll = collapsible_table();
  for (int64_t i = i0; i < i1; i++) {
    if (kept(seq, i, collapse_any, coll)) {
      out_chars[m] = seq[i];
      if (out_pos) out_pos[m] = static_cast<PosT>(i);
      m++;
    }
  }
  return m;
}

int64_t rle_count_scalar(const uint8_t* seq, int64_t i0, int64_t i1, int collapse_any) {
  const auto& coll = collapsible_table();
  int64_t cnt = 0;
  for (int64_t i = i0; i < i1; i++) cnt += kept(seq, i, collapse_any, coll);
  return cnt;
}

#if defined(__AVX512F__) && defined(__AVX512BW__) && defined(__AVX512VBMI__) && \
    defined(__AVX512VBMI2__)
#define S2K_AVX512_RLE 1
#define S2K_RLE_TARGET \
  __attribute__((target("avx512f,avx512bw,avx512vbmi,avx512vbmi2,popcnt")))

// The collapsible table of encode_rle over the low 7 bits (bytes >= 128 are
// never collapsible; keep_mask masks those lanes out by their high bit).
struct RleLut {
  __m512i lut0, lut1;
};

S2K_RLE_TARGET inline RleLut rle_lut() {
  alignas(64) uint8_t lut[128] = {};
  for (const char* p = "ACTGactgNn"; *p; p++) lut[static_cast<uint8_t>(*p)] = 1;
  return {_mm512_load_si512(lut), _mm512_load_si512(lut + 64)};
}

S2K_RLE_TARGET inline __mmask64 keep_mask(const uint8_t* seq, int64_t i, int collapse_any,
                                          const RleLut& lut) {
  __m512i v = _mm512_loadu_si512(seq + i);
  __m512i p = _mm512_loadu_si512(seq + i - 1);
  __mmask64 k = _mm512_cmpneq_epi8_mask(v, p);
  if (!collapse_any) {
    __m512i cv = _mm512_permutex2var_epi8(lut.lut0, v, lut.lut1);
    __mmask64 coll = _mm512_test_epi8_mask(cv, cv) & ~_mm512_movepi8_mask(v);
    k |= ~coll;  // bytes that do not collapse are always kept
  }
  return k;
}

// Kept bytes in [i0, i1), i0 >= 1, counted without stores.
S2K_RLE_TARGET int64_t rle_count_avx512(const uint8_t* seq, int64_t i0, int64_t i1,
                                        int collapse_any) {
  const RleLut lut = rle_lut();
  int64_t cnt = 0, i = i0;
  for (; i + 64 <= i1; i += 64) cnt += __builtin_popcountll(keep_mask(seq, i, collapse_any, lut));
  return cnt + rle_count_scalar(seq, i, i1, collapse_any);
}

// The compress-store pass over [i0, i1), writing from element m.  m_cap
// bounds the writable region in elements: while m + 64 <= m_cap, a whole
// vector of compressed elements is stored (up to 64 past the kept ones,
// inside the region that the next steps overwrite); nearer the end, the
// exact (slower) masked compress-store.  Threads that share an output pass
// their own share's end, so no store reaches a neighbour's share.
template <typename PosT>
S2K_RLE_TARGET int64_t rle_avx512(const uint8_t* seq, int64_t i0, int64_t i1,
                                  int collapse_any, uint8_t* out_chars, PosT* out_pos,
                                  int64_t m, int64_t m_cap) {
  const RleLut lut = rle_lut();
  const __m512i iota16 = _mm512_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
  const __m512i iota8 = _mm512_setr_epi64(0, 1, 2, 3, 4, 5, 6, 7);
  int64_t i = i0;
  for (; i + 64 <= i1; i += 64) {
    __mmask64 k = keep_mask(seq, i, collapse_any, lut);
    __m512i v = _mm512_loadu_si512(seq + i);
    int64_t mq = m;
    if (m + 64 <= m_cap) {
      _mm512_storeu_si512(out_chars + m, _mm512_maskz_compress_epi8(k, v));
      if (out_pos && sizeof(PosT) == 4) {
        for (int q = 0; q < 4; q++) {
          __mmask16 kq = static_cast<__mmask16>(k >> (16 * q));
          __m512i pos = _mm512_add_epi32(iota16, _mm512_set1_epi32(static_cast<int32_t>(i) + 16 * q));
          _mm512_storeu_si512(reinterpret_cast<int32_t*>(out_pos) + mq,
                              _mm512_maskz_compress_epi32(kq, pos));
          mq += __builtin_popcount(kq);
        }
      } else if (out_pos) {
        // 32-bit offsets in the step compressed, then widened and added to
        // the 64-bit base (i may pass the int32 range).  The second half is
        // stored whatever the count: a branch on it mispredicts at genomic
        // keep rates, and the store stays inside the region.
        for (int q = 0; q < 4; q++) {
          __mmask16 kq = static_cast<__mmask16>(k >> (16 * q));
          __m512i cr = _mm512_maskz_compress_epi32(kq, _mm512_add_epi32(iota16, _mm512_set1_epi32(16 * q)));
          __m512i base = _mm512_set1_epi64(i);
          int64_t* dst = reinterpret_cast<int64_t*>(out_pos) + mq;
          _mm512_storeu_si512(dst, _mm512_add_epi64(base, _mm512_cvtepu32_epi64(_mm512_castsi512_si256(cr))));
          _mm512_storeu_si512(dst + 8, _mm512_add_epi64(base, _mm512_cvtepu32_epi64(_mm512_extracti64x4_epi64(cr, 1))));
          mq += __builtin_popcount(kq);
        }
      }
      m += __builtin_popcountll(k);
      continue;
    }
    _mm512_mask_compressstoreu_epi8(out_chars + m, k, v);
    if (out_pos && sizeof(PosT) == 4) {
      for (int q = 0; q < 4; q++) {
        __mmask16 kq = static_cast<__mmask16>(k >> (16 * q));
        __m512i pos = _mm512_add_epi32(iota16, _mm512_set1_epi32(static_cast<int32_t>(i) + 16 * q));
        _mm512_mask_compressstoreu_epi32(reinterpret_cast<int32_t*>(out_pos) + mq, kq, pos);
        mq += __builtin_popcount(kq);
      }
    } else if (out_pos) {
      for (int q = 0; q < 8; q++) {
        __mmask8 kq = static_cast<__mmask8>(k >> (8 * q));
        __m512i pos = _mm512_add_epi64(iota8, _mm512_set1_epi64(i + 8 * q));
        _mm512_mask_compressstoreu_epi64(reinterpret_cast<int64_t*>(out_pos) + mq, kq, pos);
        mq += __builtin_popcount(kq);
      }
    }
    m += __builtin_popcountll(k);
  }
  return rle_scalar(seq, i, i1, collapse_any, out_chars, out_pos, m);
}
#endif  // S2K_AVX512_RLE

bool rle_avx512_ok() {
#if defined(S2K_AVX512_RLE)
  return __builtin_cpu_supports("avx512vbmi2") && __builtin_cpu_supports("avx512vbmi");
#else
  return false;
#endif
}

// The plan of one collapse, in a caller-owned int64 array:
//   [0] the kept count (the input's first byte is always kept),
//   [1] 1 where the AVX-512 kernels run,
//   [2] T, the threads of the store (0: one pass on the calling thread),
//   [3 .. 3+T] the T+1 bounds of the threads' input shares,
//   [4+T .. 4+2T) each share's first output element.
constexpr int kPlanWords = 4 + 2 * kMaxThreads + 1;
struct Plan {
  int64_t* w;
  int64_t& total() { return w[0]; }
  int64_t& avx() { return w[1]; }
  int64_t& threads() { return w[2]; }
  int64_t* lo() { return w + 3; }
  int64_t* base() { return w + 4 + w[2]; }
};

void rle_plan(const uint8_t* seq, int64_t n, int collapse_any, int path, Plan p) {
  p.total() = 0;
  p.avx() = 0;
  p.threads() = 0;
  if (n <= 0) return;
#if defined(S2K_AVX512_RLE)
  if (path != kPathScalar && n >= 128 && rle_avx512_ok()) {
    p.avx() = 1;
    const int64_t hw = std::thread::hardware_concurrency();
    if (n >= kParallelMin && hw >= 2) {
      const int64_t T = std::min<int64_t>(hw, kMaxThreads);
      p.threads() = T;
      int64_t* lo = p.lo();
      for (int64_t t = 0; t < T; t++) lo[t] = 1 + ((n - 1) * t / T & ~int64_t(63));
      lo[T] = n;
      std::vector<int64_t> cnt(T);
      std::vector<std::thread> pool;
      for (int64_t t = 1; t < T; t++)
        pool.emplace_back([&, t] { cnt[t] = rle_count_avx512(seq, lo[t], lo[t + 1], collapse_any); });
      cnt[0] = rle_count_avx512(seq, lo[0], lo[1], collapse_any);
      for (auto& th : pool) th.join();
      int64_t acc = 1;
      for (int64_t t = 0; t < T; t++) {
        p.base()[t] = acc;
        acc += cnt[t];
      }
      p.total() = acc;
      return;
    }
    p.total() = 1 + rle_count_avx512(seq, 1, n, collapse_any);
    return;
  }
#endif
  p.total() = 1 + rle_count_scalar(seq, 1, n, collapse_any);
}

// The store into exactly p.total() elements; out_pos may be null.
template <typename PosT>
void rle_store(Plan p, const uint8_t* seq, int64_t n, int collapse_any, uint8_t* out_chars,
               PosT* out_pos) {
  if (n <= 0) return;
  out_chars[0] = seq[0];
  if (out_pos) out_pos[0] = 0;
#if defined(S2K_AVX512_RLE)
  if (p.avx()) {
    const int64_t T = p.threads();
    if (T == 0) {
      rle_avx512<PosT>(seq, 1, n, collapse_any, out_chars, out_pos, 1, p.total());
      return;
    }
    int64_t *lo = p.lo(), *base = p.base();
    auto share = [&, lo, base](int64_t t) {
      const int64_t cap = t + 1 < T ? base[t + 1] : p.total();
      rle_avx512<PosT>(seq, lo[t], lo[t + 1], collapse_any, out_chars, out_pos, base[t], cap);
    };
    std::vector<std::thread> pool;
    for (int64_t t = 1; t < T; t++) pool.emplace_back(share, t);
    share(0);
    for (auto& th : pool) th.join();
    return;
  }
#endif
  rle_scalar<PosT>(seq, 1, n, collapse_any, out_chars, out_pos, 1);
}

// One collapse into worst-case (n-element) buffers: the timed loop's form.
// Below kParallelMin one pass on the calling thread (the buffers are large
// enough without a count); above it the plan's count and threaded store.
template <typename PosT>
int64_t rle_dispatch(const uint8_t* seq, int64_t n, int collapse_any, int path,
                     uint8_t* out_chars, PosT* out_pos) {
  if (n <= 0) return 0;
#if defined(S2K_AVX512_RLE)
  if (path != kPathScalar && n >= 128 && n < kParallelMin && rle_avx512_ok()) {
    out_chars[0] = seq[0];
    if (out_pos) out_pos[0] = 0;
    return rle_avx512<PosT>(seq, 1, n, collapse_any, out_chars, out_pos, 1, n);
  }
#endif
  int64_t words[kPlanWords];
  Plan p{words};
  rle_plan(seq, n, collapse_any, path, p);
  rle_store<PosT>(p, seq, n, collapse_any, out_chars, out_pos);
  return p.total();
}

// Large freed outputs stay in the malloc arena instead of going back to the
// system: an int64 position array of tens of MB is past glibc's mmap
// threshold, and each call would otherwise pay its page faults anew.
void malloc_tune() {
  static bool done = [] {
    mallopt(M_MMAP_THRESHOLD, 256 << 20);
    mallopt(M_TRIM_THRESHOLD, 256 << 20);
    return true;
  }();
  (void)done;
}

#if defined(__AVX512F__) && defined(__AVX512BW__) && defined(__AVX512VBMI__)
#define S2K_AVX512_XCODE 1
// The 256-entry table as two permutex2var lookups on the low 7 bits,
// chosen by the byte's high bit; the keep flag from one shifted compare.
__attribute__((target("avx512f,avx512bw,avx512vbmi"))) void xcode_avx512(
    const uint8_t* seq, int64_t n, const uint8_t* table, uint8_t* out) {
  const __m512i t0 = _mm512_loadu_si512(table);
  const __m512i t1 = _mm512_loadu_si512(table + 64);
  const __m512i t2 = _mm512_loadu_si512(table + 128);
  const __m512i t3 = _mm512_loadu_si512(table + 192);
  const __m512i eight = _mm512_set1_epi8(8);
  out[0] = table[seq[0]] | 8;
  int64_t i = 1;
  for (; i + 64 <= n; i += 64) {
    __m512i v = _mm512_loadu_si512(seq + i);
    __m512i p = _mm512_loadu_si512(seq + i - 1);
    __mmask64 keep = _mm512_cmpneq_epi8_mask(v, p);
    __m512i lo = _mm512_permutex2var_epi8(t0, v, t1);
    __m512i hi = _mm512_permutex2var_epi8(t2, v, t3);
    __m512i code = _mm512_mask_blend_epi8(_mm512_movepi8_mask(v), lo, hi);
    _mm512_storeu_si512(out + i, _mm512_mask_add_epi8(code, keep, code, eight));
  }
  for (; i < n; i++) out[i] = table[seq[i]] | ((seq[i] != seq[i - 1]) << 3);
}
#endif

bool xcode_avx512_ok() {
#if defined(S2K_AVX512_XCODE)
  return __builtin_cpu_supports("avx512vbmi");
#else
  return false;
#endif
}

}  // namespace

extern "C" {

// 1 where `path` 0 runs the AVX-512 kernels on this CPU: bit 0 the
// collapse, bit 1 the xcode encoder.
int s2k_native_avx512() { return (rle_avx512_ok() ? 1 : 0) | (xcode_avx512_ok() ? 2 : 0); }

int s2k_rle_plan_words() { return kPlanWords; }

// Count pass: fills `plan` (s2k_rle_plan_words() int64s); -> the kept count.
int64_t s2k_rle_plan(const uint8_t* seq, int64_t n, int collapse_any, int path, int64_t* plan) {
  rle_plan(seq, n, collapse_any, path, Plan{plan});
  return plan[0];
}

// Store pass of a plan: the kept bytes into out_chars[plan[0]] and, unless
// out_pos is null, their positions into out_pos[plan[0]] of pos_bytes (4 or
// 8) each.
int s2k_rle_store(const int64_t* plan, const uint8_t* seq, int64_t n, int collapse_any,
                  uint8_t* out_chars, void* out_pos, int pos_bytes) {
  if (pos_bytes != 4 && pos_bytes != 8) return kErrArgs;
  if (out_pos && pos_bytes == 4 && n >= (int64_t(1) << 31)) return kErrPos32;
  malloc_tune();
  Plan p{const_cast<int64_t*>(plan)};
  if (pos_bytes == 4)
    rle_store<int32_t>(p, seq, n, collapse_any, out_chars, static_cast<int32_t*>(out_pos));
  else
    rle_store<int64_t>(p, seq, n, collapse_any, out_chars, static_cast<int64_t*>(out_pos));
  return 0;
}

// The collapse repeated into preallocated worst-case buffers until min_ms
// have passed, timed inside the library (no call overhead in the loop):
// -> *iters passes in *ns nanoseconds, after one untimed pass.  Output
// buffers are reused, not allocated per pass.
int s2k_rle_loop(const uint8_t* seq, int64_t n, int collapse_any, int pos_bytes, int want_pos,
                 int64_t min_ms, int path, int64_t* iters, int64_t* ns) {
  *iters = 0;
  *ns = 0;
  if (pos_bytes != 4 && pos_bytes != 8) return kErrArgs;
  if (want_pos && pos_bytes == 4 && n >= (int64_t(1) << 31)) return kErrPos32;
  if (n <= 0) return 0;
  malloc_tune();
  uint8_t* out_chars = static_cast<uint8_t*>(malloc(n));
  void* out_pos = want_pos ? malloc(static_cast<size_t>(n) * pos_bytes) : nullptr;
  if (!out_chars || (want_pos && !out_pos)) {
    free(out_chars);
    free(out_pos);
    return kErrNoMemory;
  }
  auto run = [&]() -> int64_t {
    if (pos_bytes == 8)
      return rle_dispatch<int64_t>(seq, n, collapse_any, path, out_chars, static_cast<int64_t*>(out_pos));
    return rle_dispatch<int32_t>(seq, n, collapse_any, path, out_chars, static_cast<int32_t*>(out_pos));
  };
  volatile int64_t sink = run();
  const int64_t min_ns = min_ms * 1000000;
  const auto t0 = std::chrono::steady_clock::now();
  do {
    sink = sink + run() + out_chars[0];
    ++*iters;
    *ns = std::chrono::duration_cast<std::chrono::nanoseconds>(std::chrono::steady_clock::now() - t0).count();
  } while (*ns < min_ns);
  free(out_chars);
  free(out_pos);
  return 0;
}

// out[i] = table[seq[i]] | (seq[i] != seq[i-1]) << 3, the first byte kept.
int s2k_xcode(const uint8_t* seq, int64_t n, const uint8_t* table, uint8_t* out, int path) {
  if (n <= 0) return 0;
#if defined(S2K_AVX512_XCODE)
  if (path != kPathScalar && n >= 128 && xcode_avx512_ok()) {
    xcode_avx512(seq, n, table, out);
    return 0;
  }
#endif
  out[0] = table[seq[0]] | 8;
  for (int64_t i = 1; i < n; i++) out[i] = table[seq[i]] | ((seq[i] != seq[i - 1]) << 3);
  return 0;
}

}  // extern "C"
