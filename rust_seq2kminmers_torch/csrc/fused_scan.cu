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
//      steps of threads x run bases (ScanShape<H>), each thread a run of
//      16 consecutive bases read straight from device memory by one
//      16-byte load, coalesced across the warp.  Width 64 runs the same
//      steps in its own kernel, scan_kernel<H64>, in other frames (its
//      note, below).
//
// The window hash: the pre-rotated terms af[e] = rol(seed[c], -r) and
// ar[e] = rol(seed'[c], r) combine only by XOR, so the block keeps running
// prefixes PF(r) = af[..] ^ ... ^ af[r] and PR(r) instead of the terms, and
// the window at rank f is PF(f + l - 1) ^ PF(f - 1): two loads, not 2 * l.
// Prefixes and positions live in a ring in shared memory indexed by rank
// (a power of two that holds a step and the l + 1 ranks before it, one
// slot of padding every 16 so that threads whose ranks lie 16 apart use
// different banks), so nothing is copied from step to step.
//
// A step of pass 3:
//   a. each thread builds its run's keep mask in a register (the tile's
//      ends, the read's length and the load's misalignment as one range
//      mask) and walks its 16 positions once for the run's kept count n and
//      its XORs of terms rotated by their rank inside the run,
//        xf = XOR_i rol(seed[c_i], -i),  xr = XOR_i rol(seed'[c_i], i),
//      keeping each prefix of them in registers;
//   b. one block scan of (n, xf, xr) under
//        (n1, f1, r1) o (n2, f2, r2) = (n1 + n2, f1 ^ rol(f2, -n1), r1 ^ rol(r2, n1)),
//      associative because rotations compose mod the width (16, 31, 32,
//      64): five shuffle levels in the warp, then the warps' totals
//      through shared memory (barrier 1).  A thread's exclusive value
//      gives its first rank and, rotated by -base and XORed with
//      PF(base - 1), its PF and PR before its run; the block's total moves
//      base and PF(base - 1) on, in registers;
//   c. each thread turns its register prefixes into PF and PR (one
//      rotation by -first each) and writes the kept ones and their
//      positions into the ring (barrier 2);
//   d. each thread evaluates the window each kept base emits: its own PF
//      and PR from registers, PF(f - 1) and PR(f - 1) from the ring; a
//      survivor count, one more block exclusive scan (barrier 3), and the
//      thread writes its survivors in stream order, each hash computed
//      again from the ring.
// Steps a, c and d walk every position without a branch, a position not
// kept adding nothing, so that each step's shared-memory loads issue
// together, not one latency at a time behind a branch a base.
// Three barriers a step of 96 x 16 bases; the design before it had four for
// every 640 bases, one base a thread, and two more for a stage of the
// codes in shared memory.
//
// Shape (ScanShape<H>), from measurement on the H100: 96 threads (64 and
// 128 ran slower at every width), runs of 16 bases, a ring of 2048 ranks
// in 2176 slots.  Widths 16, 31 and 32: 26,112 bytes and 80 registers (at
// 32 one 4-byte spill, a store and a load a step), 8 blocks a SM.  Width
// 64, its own kernel (scan_kernel<H64>, below): 43,520 bytes and 128
// registers, 5 blocks a SM, as many as the shared memory holds (the
// template gave it 168 registers and 4).  Runs of 8 there (a ring of 1024
// ranks, 23,040 bytes, 8 blocks a SM at 80 registers) ran slower: the
// block scan's share of a step doubles, and the warps a SM were not what
// bound it.
//
// Bound on this card: it reads 1 byte per base twice (passes 1 and 3) and
// writes ~12 bytes per survivor (~1% of bases), so bytes allow ~0.01 ms at
// the [32, 1 Mbp] main-path shape.  What binds pass 3 is its instructions
// per base, most of them on the integer pipe (64 lanes a clock a SM): by
// cuobjdump -sass, a step of the loop executes ~63 a base at width 32
// (~42 on that pipe; a step of 16 bases ~1000: the keep mask, seed loads,
// rotations and XORs of a and c, the ring's addresses and stores, d's
// loads and hashes, the scans), against ~247 a base before (the 640-thread
// loop's body for each base), and ~86 at width 64 (~60 on that pipe),
// against ~122 (~86) when width 64 ran the template; and the ring's banks,
// where the hpc modes' ragged runs put threads' ranks at random distances
// (at width 64 8-byte accesses conflict less there than 4-byte halves).
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

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NT = 640;  // pass 2: threads per block
constexpr int LMAX = 255;   // largest l: the pending prefix is l elements
constexpr int RANKS_SMEM = 12000;  // pass 2 searches ranks in shared memory
                                   // up to this many tiles
constexpr int NT1 = 256, CH = 4;  // pass 1: threads, 16-byte chunks a thread
constexpr int TPB = 64;  // pass 2: tiles' pending prefixes a block

using s2k::FULL;
using s2k::H16;
using s2k::H31;
using s2k::H32;
using s2k::H64;
using s2k::byte_of;
using s2k::misalign;

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

constexpr int pow2_at_least(int n, int p = 1) {
  return p >= n ? p : pow2_at_least(n, 2 * p);
}

// Pass 3's shape at hash H: `threads` a block, each taking a run of `run`
// consecutive bases a step (one 16-byte load); a ring of `ring` ranks, a
// power of two that holds a step and the l + 1 ranks before it, in `slots`
// slots, one of padding every 16.  Chosen by measurement (the note at the
// head of the file).
template <typename H>
struct ScanShape {
  static constexpr int run = 16;
  static constexpr int threads = 96;
  static constexpr int min_blocks = sizeof(typename H::T) == 8 ? 5 : 8;
  static constexpr int ring = pow2_at_least(threads * run + LMAX + 1);
  static constexpr int slots = ring + ring / 16;
};

// Rank r's slot in a ring of RING ranks (r may be negative).
template <int RING>
__device__ __forceinline__ int ring_slot(int r) {
  const int s = r & (RING - 1);
  return s + (s >> 4);
}

// PF(r) and PR(r) side by side: one load or store of 8 (16) bytes.
template <typename H>
struct alignas(2 * sizeof(typename H::T)) Pair {
  typename H::T f, r;
};

// A stretch of the stream for the block scan: its kept count and the XORs
// of its terms, each rotated by its rank inside the stretch.
template <typename H>
struct Seg {
  int n;
  typename H::T f, r;
};

// a, then b: b's ranks move up by a.n.
template <typename H>
__device__ __forceinline__ Seg<H> then(const Seg<H>& a, const Seg<H>& b) {
  return {a.n + b.n, a.f ^ H::rol(b.f, H::neg((uint32_t)a.n)),
          a.r ^ H::rol(b.r, (uint32_t)a.n)};
}

// Bit i set where byte i of w has bit 3 (the HPC keep flag) set.
__device__ __forceinline__ uint32_t keep_bits(uint32_t w) {
  return (((w >> 3) & 0x01010101u) * 0x01020408u) >> 24;
}

// Rotate by r <= W (by any r at width 32, whose funnel shift wraps).
template <typename H>
__device__ __forceinline__ typename H::T rol_small(typename H::T x, uint32_t r) {
  if constexpr (std::is_same<H, H32>::value) {
    return __funnelshift_l(x, x, r);
  } else {
    return H::rolr(x, r);
  }
}

// Rotate by any r.
template <typename H>
__device__ __forceinline__ typename H::T rol_any(typename H::T x, uint32_t r) {
  if constexpr (std::is_same<H, H32>::value) {
    return __funnelshift_l(x, x, r);
  } else {
    return H::rol(x, r);
  }
}

// The canonical hash of the window at rank f >= 0 from PF(f + l - 1) ^
// PF(f - 1) and PR(f + l - 1) ^ PR(f - 1).
template <typename H>
__device__ __forceinline__ typename H::T window_hash(typename H::T xf,
                                                     typename H::T xr, int f,
                                                     int l) {
  using T = typename H::T;
  const T fh = rol_any<H>(xf, (uint32_t)(l - 1 + f));
  const T rh = rol_any<H>(xr, H::neg((uint32_t)f));
  return fh < rh ? fh : rh;
}

// Step d for a run: bit i set where kept position i emits a window (rank
// f = e - l + 1, or e - l with HE, hpc_end, whose window ends at e - 1)
// that is valid (f <= ulim as unsigned: 0 <= f <= limit) and whose hash
// is at most hb.  PF(f + l - 1) from the registers (pf[i], or with HE the
// value before it: pf[i - 1], or PF(first - 1)), PF(f - 1) from the ring.
template <typename H, bool HE, int V, int RING, typename P>
__device__ __forceinline__ uint32_t windows(const typename H::T (&pf)[V],
                                            const typename H::T (&pr)[V],
                                            typename H::T bf, typename H::T br,
                                            const P* s_p, uint32_t mask,
                                            int first, int l, uint32_t ulim,
                                            typename H::T hb) {
  using T = typename H::T;
  uint32_t sel = 0;
  int e = first;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int f = e - l + 1 - HE;
    const P p = s_p[ring_slot<RING>(f - 1)];
    const T lf = HE ? (i ? pf[i > 0 ? i - 1 : 0] : bf) : pf[i];
    const T lr = HE ? (i ? pr[i > 0 ? i - 1 : 0] : br) : pr[i];
    const T h = window_hash<H>(lf ^ p.f, lr ^ p.r, f, l);
    const uint32_t k = mask >> i & 1u;
    sel |= (k & (uint32_t)((uint32_t)f <= ulim) & (uint32_t)(h <= hb)) << i;
    e += k;
  }
  return sel;
}

template <typename H>
__global__ void __launch_bounds__(ScanShape<H>::threads, ScanShape<H>::min_blocks)
scan_kernel(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ limits,
    const typename H::T* __restrict__ seeds,
    const int32_t* __restrict__ base_in, const int32_t* __restrict__ pending,
    int32_t* __restrict__ out_start, int32_t* __restrict__ out_end,
    int32_t* __restrict__ out_hash, int32_t* __restrict__ out_hash_hi,
    int32_t* __restrict__ counts, int L, int l, typename H::T bound,
    int strict, int do_hpc, int hpc_end, int tile, int cap, int nt) {
  using T = typename H::T;
  using S = ScanShape<H>;
  using P = Pair<H>;
  constexpr int V = S::run, TH = S::threads, NW = TH / 32;
  static_assert(V == 16, "a run is one 16-byte load");
  // The ring, by rank r at ring_slot(r): PF(r) and PR(r), then r's position.
  extern __shared__ __align__(16) unsigned char smem[];
  P* s_p = reinterpret_cast<P*>(smem);
  int32_t* s_pos = reinterpret_cast<int32_t*>(s_p + S::slots);
  __shared__ P s_seed[8];  // code c: (forward seed, reverse seed)
  __shared__ Seg<H> s_warp[NW];  // each warp's (n, xf, xr)
  __shared__ int s_sel[NW];  // each warp's survivors

  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (tid < 8) s_seed[tid] = P{seeds[tid], seeds[8 + tid]};
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
        xf ^= H::rol(s_seed[p & 7].f, H::neg((uint32_t)r));
        xr ^= H::rol(s_seed[p & 7].r, (uint32_t)r);
      }
    }
    T pf = s2k::warp_xor_scan(xf, lane) ^ xf;
    T pr = s2k::warp_xor_scan(xr, lane) ^ xr;
    for (int k = k0; k < k1; ++k) {
      const int32_t p = pend[k];
      const int r = base - l + k;
      if (r >= 0) {
        pf ^= H::rol(s_seed[p & 7].f, H::neg((uint32_t)r));
        pr ^= H::rol(s_seed[p & 7].r, (uint32_t)r);
      }
      s_p[ring_slot<S::ring>(r)] = P{pf, pr};
      s_pos[ring_slot<S::ring>(r)] = p >> 3;  // arithmetic: carried positions are negative
    }
    if (lane == 0) s_p[ring_slot<S::ring>(base - l - 1)] = P{0, 0};
  }
  __syncthreads();
  P pb = s_p[ring_slot<S::ring>(base - 1)];  // PF(base - 1), PR(base - 1)

  const int length = lengths[b], limit = limits[b];
  const int t0 = t * tile, t1 = min(L, t0 + tile);
  const int hi = do_hpc ? min(t1, length) : t1;  // kept positions lie below
  const uint8_t* row = codes + (size_t)b * L;
  const int lo = t0 - misalign(row + t0);  // position of run 0's byte 0
  const uint4* src = reinterpret_cast<const uint4*>(row + lo);
  const int nrun = (t1 - lo + V - 1) / V;
  // A window is valid at 0 <= f <= limit, and selected at hash <= hb.
  const uint32_t ulim = (uint32_t)limit;
  const T hb = strict ? bound - 1 : bound;
  const uint32_t any = limit >= 0 && !(strict && bound == 0) ? ~0u : 0u;
  int tile_raw = 0;
  uint4 next = tid < nrun ? src[tid] : make_uint4(0, 0, 0, 0);
  for (int q0 = 0; q0 < nrun; q0 += TH) {
    const int q = q0 + tid;
    const uint4 v = next;
    if (q + TH < nrun) next = src[q + TH];
    const int p0 = lo + V * q;
    // a. The run's keep mask, and its XORs by rank inside the run.
    const int a = min(max(t0 - p0, 0), V), z = min(max(hi - p0, 0), V);
    uint32_t mask = ((1u << z) - 1u) & ~((1u << a) - 1u);
    if (do_hpc) {
      mask &= keep_bits(v.x) | keep_bits(v.y) << 4 | keep_bits(v.z) << 8 |
              keep_bits(v.w) << 12;
    }
    // Every position is walked without a branch, kept or not, so that the
    // compiler issues a phase's shared-memory loads together: a position
    // that is not kept adds nothing and stores nothing.
    T pf[V], pr[V];  // the run's prefixes by rank inside it, then PF, PR
    Seg<H> own = {0, 0, 0};
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const uint32_t k = mask >> i & 1u;
      const T km = (T)0 - (T)k;  // all ones where kept
      const P s = s_seed[byte_of(v, i) & 7u];
      own.f ^= rol_small<H>(s.f, H::W - own.n) & km;  // own.n < V <= W
      own.r ^= rol_small<H>(s.r, own.n) & km;
      own.n += k;
      pf[i] = own.f;
      pr[i] = own.r;
    }
    // b. The block scan of (n, xf, xr): the warp's by shuffles, then the
    // warps' totals.
    Seg<H> inc = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const Seg<H> u = {__shfl_up_sync(FULL, inc.n, o), __shfl_up_sync(FULL, inc.f, o),
                        __shfl_up_sync(FULL, inc.r, o)};
      if (lane >= o) inc = then<H>(u, inc);
    }
    if (lane == 31) s_warp[warp] = inc;
    __syncthreads();
    // The thread's exclusive value in its warp (inc = exc, then own), then
    // in the block.
    const int en = inc.n - own.n;
    const Seg<H> exc = {en, inc.f ^ H::rol(own.f, H::neg((uint32_t)en)),
                        inc.r ^ H::rol(own.r, (uint32_t)en)};
    Seg<H> before = {0, 0, 0}, total = {0, 0, 0};
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (w == warp) before = total;
      total = then<H>(total, s_warp[w]);
    }
    before = then<H>(before, exc);
    const int first = base + before.n;  // the rank of the thread's first element
    // PF(first - 1) and PR(first - 1); PF and PR before the next step.
    const T bf = pb.f ^ H::rol(before.f, H::neg((uint32_t)base));
    const T br = pb.r ^ H::rol(before.r, (uint32_t)base);
    pb.f ^= H::rol(total.f, H::neg((uint32_t)base));
    pb.r ^= H::rol(total.r, (uint32_t)base);
    // c. PF and PR at every position (at one not kept, those of the last
    // kept element before it, or PF(first - 1)); the kept ones, with their
    // positions, into the ring.
    {
      const uint32_t nf = H::red(H::neg((uint32_t)first)), rf = H::red((uint32_t)first);
      int r = first;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        pf[i] = bf ^ rol_small<H>(pf[i], nf);
        pr[i] = br ^ rol_small<H>(pr[i], rf);
        if (mask >> i & 1u) {
          const int slot = ring_slot<S::ring>(r);
          s_p[slot] = P{pf[i], pr[i]};
          s_pos[slot] = p0 + i;
        }
        r += mask >> i & 1u;
      }
    }
    __syncthreads();
    // d. The window each kept element emits: selected or not.
    uint32_t sel = hpc_end
        ? windows<H, true, V, S::ring>(pf, pr, bf, br, s_p, mask, first, l, ulim, hb)
        : windows<H, false, V, S::ring>(pf, pr, bf, br, s_p, mask, first, l, ulim, hb);
    sel &= any;
    // The survivors' slots: an exclusive scan of their counts.
    const int sn = __popc(sel);
    int sinc = sn;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, sinc, o);
      if (lane >= o) sinc += u;
    }
    if (lane == 31) s_sel[warp] = sinc;
    __syncthreads();
    int o = tile_raw + sinc - sn, stotal = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (w < warp) o += s_sel[w];
      stotal += s_sel[w];
    }
    // Each survivor's hash again, from the ring, so that no thread keeps it.
    for (uint32_t rest = sel; rest && o < cap; rest &= rest - 1, ++o) {
      const int i = __ffs(rest) - 1;
      const int e = first + __popc(mask & ((1u << i) - 1u));
      const int f = e - l + 1 - hpc_end;
      const P last = s_p[ring_slot<S::ring>(f + l - 1)], p = s_p[ring_slot<S::ring>(f - 1)];
      const T h = window_hash<H>(last.f ^ p.f, last.r ^ p.r, f, l);
      const size_t oi = ((size_t)b * nt + t) * cap + o;
      out_start[oi] = s_pos[ring_slot<S::ring>(f)];
      out_end[oi] = p0 + i - hpc_end;
      out_hash[oi] = (int32_t)(uint32_t)h;
    }
    tile_raw += stotal;
    base += total.n;
  }
  if (tid == 0) {
    int32_t* c = counts + ((size_t)b * nt + t) * 3;
    c[0] = min(tile_raw, cap);
    c[1] = tile_raw;
    c[2] = base - base_in[bt];
  }
}

// ---- pass 3 at width 64: scan_kernel<H64> ----------------------------------
//
// The same steps, in frames that spare the 64-bit values their rotates a
// base.  Width 64 keeps a rank's values as G(r) = rol(PF(r), r) and Q(r) =
// rol(PR(r), l - 1 - r).  The window at f whose last rank is w = f + l - 1
// then has
//   fh = rol(PF(w) ^ PF(f - 1), w) = G(w) ^ rol(G(f - 1), l),
//   rh = rol(PR(w) ^ PR(f - 1), -f) = Q(w) ^ rol(Q(f - 1), -l),
// and along the stream G(r) = rol(G(r - 1), 1) ^ seed[c_r] and Q(r) =
// rol(Q(r - 1), -1) ^ rol(seed'[c_r], l - 1): rotates by the kept bit a
// base, and by l, fixed for the launch, a window.  A value is two 32-bit
// halves, rotated by funnel shifts, by 32 by swapping them.  The block
// scan stays in PF and PR.

// By any r, taken mod 64: the halves swapped where bit 5 of r is set (a
// clamped funnel shift by 0 or 32 each), then a funnel shift each.
__device__ __forceinline__ uint64_t rol64_halves(uint64_t x, uint32_t r) {
  const uint32_t x0 = (uint32_t)x, x1 = (uint32_t)(x >> 32), s = r & 32u;
  const uint32_t lo = __funnelshift_lc(x1, x0, s), hi = __funnelshift_lc(x0, x1, s);
  return (uint64_t)__funnelshift_l(lo, hi, r) << 32 | __funnelshift_l(hi, lo, r);
}

// By n and by -n, n taken mod 32 as a funnel shift takes it: no swap.
__device__ __forceinline__ uint64_t rol64_below32(uint64_t x, uint32_t n) {
  const uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
  return (uint64_t)__funnelshift_l(lo, hi, n) << 32 | __funnelshift_l(hi, lo, n);
}

__device__ __forceinline__ uint64_t ror64_below32(uint64_t x, uint32_t n) {
  const uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
  return (uint64_t)__funnelshift_r(hi, lo, n) << 32 | __funnelshift_r(lo, hi, n);
}

__device__ __forceinline__ Seg<H64> then64(const Seg<H64>& a, const Seg<H64>& b) {
  return {a.n + b.n, a.f ^ rol64_halves(b.f, 0u - (uint32_t)a.n),
          a.r ^ rol64_halves(b.r, (uint32_t)a.n)};
}

// The ring at width 64: G at `slot` of the first array, Q of the second;
// then the positions.  One 8-byte access a value, as its register pair
// holds it.
struct Ring64 {
  static constexpr int slots = ScanShape<H64>::slots;
  uint64_t* mem;

  __device__ __forceinline__ uint64_t get(int a, int slot) const { return mem[a * slots + slot]; }
  __device__ __forceinline__ void put(int slot, uint64_t g, uint64_t q) const {
    mem[slot] = g;
    mem[slots + slot] = q;
  }
  __device__ __forceinline__ int32_t* pos() const {
    return reinterpret_cast<int32_t*>(mem + 2 * slots);
  }
};

// x rotated by 32 where SW is 1: its halves' registers swapped.
template <uint32_t SW>
__device__ __forceinline__ uint64_t turn32(uint64_t x) {
  return SW ? x << 32 | x >> 32 : x;
}

// Step d at width 64, as windows(): G(w), Q(w) from the registers (g[i],
// or with HE g[i - 1], or G(first - 1)), G(f - 1), Q(f - 1) from the ring,
// rotated by l and -l: by 32 where SF (SR), bit 5 of l (-l), is set, which
// swaps registers, then by a funnel shift a half.  A window is selected
// where either strand's hash is at most hb, which takes no 64-bit min.
template <bool HE, uint32_t SF, uint32_t SR, int V>
__device__ __forceinline__ uint32_t windows64(const uint64_t (&g)[V], const uint64_t (&q)[V],
                                              uint64_t gb, uint64_t qb, const Ring64& ring,
                                              uint32_t mask, int first, int l, uint32_t ulim,
                                              uint64_t hb) {
  constexpr int RING = ScanShape<H64>::ring;
  const uint32_t lf = (uint32_t)l, lr = 0u - lf;
  uint32_t sel = 0;
  int e = first;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int f = e - l + 1 - HE;
    const int slot = ring_slot<RING>(f - 1);
    const uint64_t gw = HE ? (i ? g[i > 0 ? i - 1 : 0] : gb) : g[i];
    const uint64_t qw = HE ? (i ? q[i > 0 ? i - 1 : 0] : qb) : q[i];
    const uint64_t fh = gw ^ rol64_below32(turn32<SF>(ring.get(0, slot)), lf);
    const uint64_t rh = qw ^ rol64_below32(turn32<SR>(ring.get(1, slot)), lr);
    const uint32_t k = mask >> i & 1u;
    sel |= (k & (uint32_t)((uint32_t)f <= ulim) & (uint32_t)((fh <= hb) | (rh <= hb))) << i;
    e += k;
  }
  return sel;
}

// windows64 for the launch's turn = (bit 5 of l) * 2 + (bit 5 of -l): a
// branch that every thread takes alike, step after step.
template <bool HE, int V>
__device__ __forceinline__ uint32_t windows64(uint32_t turn, const uint64_t (&g)[V],
                                              const uint64_t (&q)[V], uint64_t gb, uint64_t qb,
                                              const Ring64& ring, uint32_t mask, int first, int l,
                                              uint32_t ulim, uint64_t hb) {
  switch (turn) {
    case 0: return windows64<HE, 0, 0>(g, q, gb, qb, ring, mask, first, l, ulim, hb);
    case 1: return windows64<HE, 0, 1>(g, q, gb, qb, ring, mask, first, l, ulim, hb);
    case 2: return windows64<HE, 1, 0>(g, q, gb, qb, ring, mask, first, l, ulim, hb);
    default: return windows64<HE, 1, 1>(g, q, gb, qb, ring, mask, first, l, ulim, hb);
  }
}

template <>
__global__ void __launch_bounds__(ScanShape<H64>::threads, ScanShape<H64>::min_blocks)
scan_kernel<H64>(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ limits, const uint64_t* __restrict__ seeds,
    const int32_t* __restrict__ base_in, const int32_t* __restrict__ pending,
    int32_t* __restrict__ out_start, int32_t* __restrict__ out_end,
    int32_t* __restrict__ out_hash, int32_t* __restrict__ out_hash_hi,
    int32_t* __restrict__ counts, int L, int l, uint64_t bound,
    int strict, int do_hpc, int hpc_end, int tile, int cap, int nt) {
  using T = uint64_t;
  using S = ScanShape<H64>;
  using P = Pair<H64>;
  constexpr int V = S::run, TH = S::threads, NW = TH / 32;
  static_assert(V == 16, "a run is one 16-byte load");
  extern __shared__ __align__(16) unsigned char smem[];
  const Ring64 ring{reinterpret_cast<uint64_t*>(smem)};
  int32_t* s_pos = ring.pos();
  __shared__ P s_seed[8];  // code c: (forward seed, reverse seed)
  __shared__ P s_term[8];  // code c's terms of G and Q: (seed[c], rol(seed'[c], l - 1))
  __shared__ Seg<H64> s_warp[NW];  // each warp's (n, xf, xr)
  __shared__ int s_sel[NW];  // each warp's survivors

  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (tid < 8) {
    s_seed[tid] = P{seeds[tid], seeds[8 + tid]};
    s_term[tid] = P{seeds[tid], rol64_halves(seeds[8 + tid], (uint32_t)(l - 1))};
  }
  __syncthreads();
  const size_t bt = (size_t)b * (nt + 1) + t;
  int base = base_in[bt];  // the rank of the next stream element

  // The pending prefix, ranks base - l .. base - 1, by warp 0, 8 a lane:
  // PF and PR as in scan_kernel<H>, into the ring as G and Q.
  if (warp == 0) {
    const int32_t* pend = pending + bt * l;
    const int k0 = lane * 8, k1 = min(l, k0 + 8);
    T xf = 0, xr = 0;
    for (int k = k0; k < k1; ++k) {
      const int32_t p = pend[k];
      const int r = base - l + k;
      if (r >= 0) {
        xf ^= rol64_halves(s_seed[p & 7].f, 0u - (uint32_t)r);
        xr ^= rol64_halves(s_seed[p & 7].r, (uint32_t)r);
      }
    }
    T pf = s2k::warp_xor_scan(xf, lane) ^ xf;
    T pr = s2k::warp_xor_scan(xr, lane) ^ xr;
    for (int k = k0; k < k1; ++k) {
      const int32_t p = pend[k];
      const int r = base - l + k;
      if (r >= 0) {
        pf ^= rol64_halves(s_seed[p & 7].f, 0u - (uint32_t)r);
        pr ^= rol64_halves(s_seed[p & 7].r, (uint32_t)r);
      }
      const int slot = ring_slot<S::ring>(r);
      ring.put(slot, rol64_halves(pf, (uint32_t)r), rol64_halves(pr, (uint32_t)(l - 1 - r)));
      s_pos[slot] = p >> 3;  // arithmetic: carried positions are negative
    }
    if (lane == 0) ring.put(ring_slot<S::ring>(base - l - 1), 0, 0);
  }
  __syncthreads();
  // PF(base - 1) and PR(base - 1), from G and Q.
  P pb = {rol64_halves(ring.get(0, ring_slot<S::ring>(base - 1)), (uint32_t)(1 - base)),
          rol64_halves(ring.get(1, ring_slot<S::ring>(base - 1)), (uint32_t)(base - l))};

  const int length = lengths[b], limit = limits[b];
  const int t0 = t * tile, t1 = min(L, t0 + tile);
  const int hi = do_hpc ? min(t1, length) : t1;  // kept positions lie below
  const uint8_t* row = codes + (size_t)b * L;
  const int lo = t0 - misalign(row + t0);  // position of run 0's byte 0
  const uint4* src = reinterpret_cast<const uint4*>(row + lo);
  const int nrun = (t1 - lo + V - 1) / V;
  // A window is valid at 0 <= f <= limit, and selected at hash <= hb.
  const uint32_t ulim = (uint32_t)limit;
  const T hb = strict ? bound - 1 : bound;
  const uint32_t any = limit >= 0 && !(strict && bound == 0) ? ~0u : 0u;
  const uint32_t turn = ((uint32_t)l >> 4 & 2u) | ((0u - (uint32_t)l) >> 5 & 1u);
  int tile_raw = 0;
  uint4 next = tid < nrun ? src[tid] : make_uint4(0, 0, 0, 0);
  for (int q0 = 0; q0 < nrun; q0 += TH) {
    const int q = q0 + tid;
    const uint4 v = next;
    if (q + TH < nrun) next = src[q + TH];
    const int p0 = lo + V * q;
    // a. The run's keep mask, and its XORs by rank inside the run: G's and
    // Q's recurrences from 0, which leave them rotated by n - 1 and by l - n
    // for n kept, turned back after.
    const int a = min(max(t0 - p0, 0), V), z = min(max(hi - p0, 0), V);
    uint32_t mask = ((1u << z) - 1u) & ~((1u << a) - 1u);
    if (do_hpc) {
      mask &= keep_bits(v.x) | keep_bits(v.y) << 4 | keep_bits(v.z) << 8 |
              keep_bits(v.w) << 12;
    }
    Seg<H64> own = {__popc(mask), 0, 0};
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const uint32_t k = mask >> i & 1u;
      const T km = (T)(0u - k) << 32 | (0u - k);  // all ones where kept
      const P s = s_term[byte_of(v, i) & 7u];
      own.f = rol64_below32(own.f, k) ^ (s.f & km);
      own.r = ror64_below32(own.r, k) ^ (s.r & km);
    }
    own.f = rol64_halves(own.f, (uint32_t)(1 - own.n));
    own.r = rol64_halves(own.r, (uint32_t)(own.n - l));
    // b. The block scan of (n, xf, xr): the counts by shuffles first, then
    // each thread's XORs, moved to its first rank in the warp, by XOR
    // scans; then the warps' totals.
    Seg<H64> inc = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, inc.n, o);
      if (lane >= o) inc.n += u;
    }
    const int en = inc.n - own.n;
    const T mf = rol64_halves(own.f, 0u - (uint32_t)en), mr = rol64_halves(own.r, (uint32_t)en);
    inc.f = s2k::warp_xor_scan(mf, lane);
    inc.r = s2k::warp_xor_scan(mr, lane);
    if (lane == 31) s_warp[warp] = inc;
    __syncthreads();
    const Seg<H64> exc = {en, inc.f ^ mf, inc.r ^ mr};
    Seg<H64> before = {0, 0, 0}, total = {0, 0, 0};
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (w == warp) before = total;
      total = then64(total, s_warp[w]);
    }
    before = then64(before, exc);
    const int first = base + before.n;  // the rank of the thread's first element
    // PF(first - 1) and PR(first - 1) as G(first - 1) and Q(first - 1); PF
    // and PR before the next step.
    const T gb = rol64_halves(pb.f ^ rol64_halves(before.f, 0u - (uint32_t)base),
                              (uint32_t)(first - 1));
    const T qb = rol64_halves(pb.r ^ rol64_halves(before.r, (uint32_t)base),
                              (uint32_t)(l - first));
    pb.f ^= rol64_halves(total.f, 0u - (uint32_t)base);
    pb.r ^= rol64_halves(total.r, (uint32_t)base);
    // c. G and Q at every position (at one not kept, those of the last kept
    // element before it, or of first - 1), by their recurrences; the kept
    // ones, with their positions, into the ring.
    T g[V], gq[V];
    {
      T x = gb, y = qb;
      int r = first;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const uint32_t k = mask >> i & 1u;
        const T km = (T)(0u - k) << 32 | (0u - k);
        const P s = s_term[byte_of(v, i) & 7u];
        x = rol64_below32(x, k) ^ (s.f & km);
        y = ror64_below32(y, k) ^ (s.r & km);
        g[i] = x;
        gq[i] = y;
        if (k) {
          const int slot = ring_slot<S::ring>(r);
          ring.put(slot, x, y);
          s_pos[slot] = p0 + i;
        }
        r += k;
      }
    }
    __syncthreads();
    // d. The window each kept element emits: selected or not.
    uint32_t sel = hpc_end ? windows64<true>(turn, g, gq, gb, qb, ring, mask, first, l, ulim, hb)
                           : windows64<false>(turn, g, gq, gb, qb, ring, mask, first, l, ulim, hb);
    sel &= any;
    // The survivors' slots: an exclusive scan of their counts.
    const int sn = __popc(sel);
    int sinc = sn;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, sinc, o);
      if (lane >= o) sinc += u;
    }
    if (lane == 31) s_sel[warp] = sinc;
    __syncthreads();
    int o = tile_raw + sinc - sn, stotal = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (w < warp) o += s_sel[w];
      stotal += s_sel[w];
    }
    // Each survivor's hash again, from the ring, so that no thread keeps it.
    for (uint32_t rest = sel; rest && o < cap; rest &= rest - 1, ++o) {
      const int i = __ffs(rest) - 1;
      const int e = first + __popc(mask & ((1u << i) - 1u));
      const int f = e - l + 1 - hpc_end;
      const int sw = ring_slot<S::ring>(f + l - 1), sf = ring_slot<S::ring>(f - 1);
      const T fh = ring.get(0, sw) ^ rol64_halves(ring.get(0, sf), (uint32_t)l);
      const T rh = ring.get(1, sw) ^ rol64_halves(ring.get(1, sf), 0u - (uint32_t)l);
      const T h = fh < rh ? fh : rh;
      const size_t oi = ((size_t)b * nt + t) * cap + o;
      out_start[oi] = s_pos[ring_slot<S::ring>(f)];
      out_end[oi] = p0 + i - hpc_end;
      out_hash[oi] = (int32_t)(uint32_t)h;
      out_hash_hi[oi] = (int32_t)(uint32_t)(h >> 32);
    }
    tile_raw += stotal;
    base += total.n;
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
  using S = ScanShape<H>;
  constexpr int smem = S::slots * (int)(sizeof(Pair<H>) + sizeof(int32_t));
  static_assert(smem <= 48 * 1024, "more needs cudaFuncSetAttribute");
  scan_kernel<H><<<dim3(nt, B), S::threads, smem, s>>>(
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
