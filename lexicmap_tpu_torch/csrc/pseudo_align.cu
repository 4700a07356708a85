// Phase-4 pseudo-alignment of a batch of windows for NVIDIA Hopper (sm_90a):
// two kernels, pseudo_probe and pseudo_chain.
//
// pseudo_probe replaces lexicmap_tpu/parallel/pseudo_device.py::build_probe_fn
// (its resident form, with resident.py::extract_packed fused in); pseudo_chain
// replaces ::build_chain_fn.  Both reproduce the port's native oracle
// exactly: native/core.cpp compare_probe_codes, the sort / nested-anchor
// removal / tandem trim of compare_prepare, chain2_forward, and
// chain2_backtrack with c2_region.
//
// pseudo_probe, one CTA (512 threads, 69 KB of shared memory, three per SM)
// per window:
//   1. read the window's 2-bit words from the resident genome blob into
//      shared memory: funnel shift by the phase, and for a reverse-complement
//      window take the geometry block's words back to front, reversed in-word
//      and complemented (extract_packed's arithmetic, word by word);
//   2. one thread per position builds the forward and reverse-complement
//      31-mers from three shared words, drops homopolymers, loads both
//      strands' bounds from the query's 16-bit prefix bucket table at once,
//      and runs a lower_bound over its sorted k-mers; every pair that passes
//      the strand and begin/end rules takes a slot (one shared atomicAdd per
//      group of lanes that append together) and is written as one u64 key
//      (qb, K - ln, tb, emission tag 2*position + strand): the host's order,
//      equal anchors in emission order, in one word;
//   3. bitonic sort of the keys, padded to a power of two of at least 128:
//      merges within 128-key blocks run in registers (shuffles and in-lane
//      swaps), only partners 128 or more apart go through shared memory
//      between block barriers;
//   4. nested-anchor removal, one thread per anchor: anchor i against every
//      earlier anchor of the sorted, uncompacted array from
//      lower_bound(qe_i - k), as the host loop does, so no window cap; the
//      keep bits are each warp's ballot;
//   5. a stable compaction (a scan of the keep words), then the trim on one
//      thread, with its two double compares made in double as on the host.
// pseudo_chain, one warp per window (four per block): the window's q, t, ln
// and the DP's ms (score + ln) and prev sit in the warp's 1,280-anchor slice
// of shared memory, or past it in global memory through the same code.
// Anchor i scans its predecessors 32 at a time, lane l taking j = i-1-32c-l:
// a ballot of eligibility and a prefix popcount give each lane the host
// loop's band_count before and after j, a ballot of the two break rules
// finds the first breaking lane, and a warp max (ties to the largest lane,
// the smallest j) merges with the running best by s >= m, exactly as the
// host's serial scan.  The backtrack keeps the explicit region stack (left
// region pushed first, so the right one pops first: the recursion's
// emission order) walked by every lane in step, the region maxima as warp
// reductions (strict >, ties to the smallest i), lane 0 writing the rows;
// the pident gate in double.
//
// Bound.  Both kernels move few bytes and do few operations (chip_smoke.py
// computes the bounds from the run's own data; PERF.md has the times).
// pseudo_probe is bound by latency: the dependent table and k-mer loads of
// the probe (now half its cycles), then the sort's shared-memory stages and
// barriers.  pseudo_chain is bound by the serial DP: each warp step waits
// on the previous anchor's score, so a window costs its count of 32-
// predecessor chunk steps (~2,500 on the 1 GB set) of a few shared-memory
// round trips and warp reductions each; the warp makes the loads coalesced
// and 32-wide, the slices in shared memory make them short.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int K = 31;
constexpr int L_CAP = 16384;
constexpr int A_CAP = 8192;
constexpr int S_CAP = 64;
constexpr int QTAB_BITS = 16;
constexpr int COORD_BITS = 21;
constexpr uint64_t COORD_MAX = (1ull << COORD_BITS) - 1;
constexpr uint64_t M62 = (1ull << 62) - 1;
constexpr int TAG_BITS = 15;  // emission tags 2 * position + strand < 2 * L_CAP
constexpr int PROBE_THREADS = 512;
constexpr int PROBE_BLOCKS_PER_SM = 3;  // 69 KB of shared memory each
constexpr int SORT_E = 4;               // keys a lane holds in the sort's register stages
constexpr int SORT_BLOCK = 32 * SORT_E;  // keys a warp sorts in registers
constexpr int CHAIN_WARPS = 4;      // windows per pseudo_chain block, a warp each
constexpr int CHAIN_SLICE = 1280;   // anchors a warp stages in shared memory
constexpr unsigned FULL = 0xffffffffu;

constexpr int F_ANCHOR_OVERFLOW = 1;
constexpr int F_CHAIN_OVERFLOW = 16;
constexpr int F_STACK_OVERFLOW = 32;

constexpr size_t CHAIN_SMEM = (size_t)CHAIN_WARPS * 5 * CHAIN_SLICE * sizeof(int32_t);
constexpr size_t PROBE_SMEM = A_CAP * sizeof(uint64_t) + (L_CAP / 16 + 2) * sizeof(uint32_t);
static_assert(L_CAP / 16 + 2 >= A_CAP / 32, "the keep bits reuse the window's words");
static_assert(2 * L_CAP <= (1 << TAG_BITS), "emission tags fit the key's tag field");
static_assert(A_CAP / 32 <= PROBE_THREADS, "one keep word per thread in the compaction scan");

__device__ __forceinline__ uint32_t rev_pairs32(uint32_t x) {
  x = ((x & 0x33333333u) << 2) | ((x >> 2) & 0x33333333u);
  x = ((x & 0x0F0F0F0Fu) << 4) | ((x >> 4) & 0x0F0F0F0Fu);
  x = ((x & 0x00FF00FFu) << 8) | ((x >> 8) & 0x00FF00FFu);
  return (x << 16) | (x >> 16);
}

__device__ __forceinline__ uint64_t homopolymer(uint64_t b) {
  uint64_t v = 0;
  for (int z = 0; z < K; ++z) v = (v << 2) | b;
  return v;
}

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// first index in [lo, hi) of the sorted u64 table with t[idx] >= x
__device__ __forceinline__ int64_t lower_bound_u64(const int64_t* __restrict__ t,
                                                   int64_t lo, int64_t hi, uint64_t x) {
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if ((uint64_t)t[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// A slot for this lane's anchor: the lanes that reach the append together
// take consecutive slots with one shared atomicAdd, made by the first of them.
__device__ __forceinline__ int warp_slot(int* counter) {
  const unsigned act = __activemask();
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(act) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(counter, __popc(act));
  return __shfl_sync(act, base, leader) + __popc(act & ((1u << lane) - 1u));
}

// The anchor sort key, the host's order in one u64: qb ascending in bits
// 41-61, qe descending as K - ln in bits 36-40 (qe = qb + ln, ln <= K), tb
// ascending in bits 15-35, and the emission tag 2 * position + strand
// (< 2^15) in bits 0-14, which orders equal (qb, qe, tb) as the host emits
// them.  ~0 pads the sort.
constexpr int LN_SHIFT = TAG_BITS + COORD_BITS;
constexpr int QB_SHIFT = LN_SHIFT + 5;

__device__ __forceinline__ uint64_t anchor_key(int64_t qb, int64_t ln, int64_t tb, uint32_t tag) {
  return ((uint64_t)qb << QB_SHIFT) | ((uint64_t)(K - ln) << LN_SHIFT) |
         ((uint64_t)tb << TAG_BITS) | tag;
}
__device__ __forceinline__ int64_t key_qb(uint64_t key) { return (int64_t)(key >> QB_SHIFT); }
__device__ __forceinline__ int64_t key_ln(uint64_t key) {
  return K - (int64_t)((key >> LN_SHIFT) & 31);
}
__device__ __forceinline__ int64_t key_qe(uint64_t key) { return key_qb(key) + key_ln(key); }
__device__ __forceinline__ int64_t key_tb(uint64_t key) {
  return (int64_t)((key >> TAG_BITS) & COORD_MAX);
}

// the trim's run condition (core.cpp compare_prepare): a in front of b,
// `prev` the run's previous anchor whose length divides the overlap
__device__ bool trim_cond(const uint64_t* keys, int a, int b, int prev) {
  const int64_t qa = key_qb(keys[a]), qb2 = key_qb(keys[b]);
  const int64_t ta = key_tb(keys[a]), tb2 = key_tb(keys[b]);
  const int64_t la = key_ln(keys[a]);
  const int64_t lp = key_ln(keys[prev]);
  const int64_t dq = qa > qb2 ? qa - qb2 : qb2 - qa;
  const int64_t dt = ta > tb2 ? ta - tb2 : tb2 - ta;
  if (!((double)(dq > dt ? dq : dt) < 100.0)) return false;
  if (qa == qb2 || ta == tb2) return true;
  const int64_t gap = dq > dt ? dq - dt : dt - dq;
  int64_t qo = 0, to = 0;
  if (qb2 >= qa && qb2 <= qa + la) qo = qa + la - qb2 + 1;
  if (tb2 >= ta && tb2 <= ta + la) to = ta + la - tb2 + 1;
  return gap > 11 && (double)(qo > to ? qo : to) / (double)lp > 0.8;
}

// ---- the bitonic sort of the keys.  A stage compares each key i with its
// partner i ^ j, ascending where i & k2 == 0.  Lane l of a warp holds keys
// base + l + 32 e (e < SORT_E) of a SORT_BLOCK-key block in registers: a
// partner fewer than 32 keys away is a shuffle away, one 32 or 64 away sits
// in the same lane.  Only stages with j >= SORT_BLOCK go through shared
// memory, between block barriers.

template <int D>  // partners 32 * D apart: registers e and e + D of a lane
__device__ __forceinline__ void stage_in_lane(uint64_t (&x)[SORT_E], int i0, int k2) {
#pragma unroll
  for (int e = 0; e < SORT_E; ++e) {
    if (e & D) continue;
    const bool up = ((i0 + 32 * e) & k2) == 0;
    const uint64_t a = x[e], b = x[e + D];
    const bool sw = up ? b < a : a < b;
    x[e] = sw ? b : a;
    x[e + D] = sw ? a : b;
  }
}

__device__ __forceinline__ void stage_shuffle(uint64_t (&x)[SORT_E], int i0, int k2, int j) {
#pragma unroll
  for (int e = 0; e < SORT_E; ++e) {
    const int i = i0 + 32 * e;
    const uint64_t y = __shfl_xor_sync(FULL, x[e], j);
    const bool keep_min = ((i & j) == 0) == ((i & k2) == 0);
    x[e] = keep_min == (x[e] < y) ? x[e] : y;
  }
}

// the stages j = j_top .. 1 of merge k2 within one block (i0 = base + lane)
__device__ __forceinline__ void stages_in_block(uint64_t (&x)[SORT_E], int i0, int k2, int j_top) {
  static_assert(SORT_E == 4, "the in-lane stages are written for 4 keys a lane");
  if (j_top >= 64) stage_in_lane<2>(x, i0, k2);
  if (j_top >= 32) stage_in_lane<1>(x, i0, k2);
  for (int j = j_top < 16 ? j_top : 16; j > 0; j >>= 1) stage_shuffle(x, i0, k2, j);
}

// keys[0, P) ascending; P a power of two in [SORT_BLOCK, A_CAP]
__device__ void sort_keys(uint64_t* keys, int P) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int WARPS = PROBE_THREADS / 32;
  uint64_t x[SORT_E];
  // merges k2 = 2 .. SORT_BLOCK: each block wholly in one warp's registers
  for (int base = warp * SORT_BLOCK; base < P; base += WARPS * SORT_BLOCK) {
#pragma unroll
    for (int e = 0; e < SORT_E; ++e) x[e] = keys[base + lane + 32 * e];
    for (int k2 = 2; k2 <= SORT_BLOCK; k2 <<= 1) stages_in_block(x, base + lane, k2, k2 >> 1);
#pragma unroll
    for (int e = 0; e < SORT_E; ++e) keys[base + lane + 32 * e] = x[e];
  }
  __syncthreads();
  for (int k2 = 2 * SORT_BLOCK; k2 <= P; k2 <<= 1) {
    for (int j = k2 >> 1; j >= SORT_BLOCK; j >>= 1) {
      for (int p = tid; p < P / 2; p += PROBE_THREADS) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));  // bit j of i clear
        const uint64_t a = keys[i], b = keys[i + j];
        if ((i & k2) == 0 ? b < a : a < b) {
          keys[i] = b;
          keys[i + j] = a;
        }
      }
      __syncthreads();
    }
    for (int base = warp * SORT_BLOCK; base < P; base += WARPS * SORT_BLOCK) {
#pragma unroll
      for (int e = 0; e < SORT_E; ++e) x[e] = keys[base + lane + 32 * e];
      stages_in_block(x, base + lane, k2, SORT_BLOCK / 2);
#pragma unroll
      for (int e = 0; e < SORT_E; ++e) keys[base + lane + 32 * e] = x[e];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(PROBE_THREADS, PROBE_BLOCKS_PER_SM) pseudo_probe_kernel(
    const uint32_t* __restrict__ blob, int64_t n_words,
    const int64_t* __restrict__ win,       // [W, 8]
    int words_out,
    const int64_t* __restrict__ qk,        // concatenated sorted query k-mers
    const int32_t* __restrict__ qv,        // pos << 1 | strand
    const int64_t* __restrict__ qoff,      // [NQ + 1]
    const uint32_t* __restrict__ qtab,     // [NQ, 2^16 + 1]
    int32_t* __restrict__ out_qb, int32_t* __restrict__ out_tb,
    int32_t* __restrict__ out_ln,          // [W, A_CAP]
    int32_t* __restrict__ counts, int32_t* __restrict__ flags) {
  extern __shared__ uint64_t smem[];
  uint64_t* keys = smem;                               // [A_CAP]
  uint32_t* words = (uint32_t*)(keys + A_CAP);         // [L_CAP/16 + 2]; later keep bits
  __shared__ int s_n, s_lo, s_cnt;
  __shared__ int s_warp[PROBE_THREADS / 32];
  __shared__ int s_woff[A_CAP / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w = blockIdx.x;
  const int64_t* g = win + (int64_t)w * 8;
  const int64_t word_base = g[0];
  const int phase = (int)g[1];
  const int L = (int)g[2];
  const bool rc = g[3] != 0;
  const int qi = (int)g[4];
  const int64_t begin = g[5], end = g[6];
  const int m = (int)g[7];

  // ---- 1. window words (extract_packed, fused) ----
  const int nwin = (L + 15) >> 4;
  const int lw = L >> 4;
  for (int j = tid; j < nwin + 2; j += blockDim.x) {
    uint32_t a = 0;
    if (j < nwin) {
      const int64_t jb = rc ? (int64_t)words_out - 1 - j : j;
      const int64_t i0 = clamp64(word_base + jb, 0, n_words - 1);
      const int64_t i1 = clamp64(word_base + jb + 1, 0, n_words - 1);
      const uint32_t r0 = __ldg(blob + i0), r1 = __ldg(blob + i1);
      const uint32_t sh = 2u * (uint32_t)phase;
      a = sh ? (r0 >> sh) | (r1 << (32u - sh)) : r0;
      if (rc) a = ~rev_pairs32(a);
      if (j == lw) a &= (1u << (2 * (L & 15))) - 1u;
    }
    words[j] = a;
  }
  if (tid == 0) s_n = 0;
  __syncthreads();

  // ---- 2. probe (compare_probe_codes) ----
  const int64_t q0 = qoff[qi], nq = qoff[qi + 1] - q0;
  const int64_t* qkq = qk + q0;
  const int32_t* qvq = qv + q0;
  const uint32_t* tab = qtab + (int64_t)qi * ((1 << QTAB_BITS) + 1);
  const uint64_t suf = (1ull << (2 * (K - m))) - 1;
  const bool use_tab = 2 * m >= QTAB_BITS;
  const uint64_t ccc = homopolymer(1), ggg = homopolymer(2), ttt = homopolymer(3);
  const int npos = nq > 0 ? L - K + 1 : 0;
  for (int i = tid; i < npos; i += blockDim.x) {
    const int wi = i >> 4, sh = 2 * (i & 15);
    uint64_t x = ((uint64_t)words[wi] | ((uint64_t)words[wi + 1] << 32)) >> sh;
    if (sh) x |= (uint64_t)words[wi + 2] << (64 - sh);
    x &= M62;  // codes i..i+30, code i at bits 0-1
    uint64_t y = __brevll(x);
    y = ((y >> 1) & 0x5555555555555555ull) | ((y & 0x5555555555555555ull) << 1);
    const uint64_t fwd = y >> 2;  // code i in the top pair
    if (fwd == 0 || fwd == ccc || fwd == ggg || fwd == ttt) continue;
    const uint64_t rcm = ~x & M62;
    // both strands' bucket bounds at once: four independent loads
    int64_t bnd[2][2] = {{0, nq}, {0, nq}};
    if (use_tab) {
      const uint64_t bf = fwd >> (2 * K - QTAB_BITS), br = rcm >> (2 * K - QTAB_BITS);
      bnd[0][0] = tab[bf];
      bnd[0][1] = tab[bf + 1];
      bnd[1][0] = tab[br];
      bnd[1][1] = tab[br + 1];
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const uint64_t t = s == 0 ? fwd : rcm;
      const uint64_t lb = t & ~suf, rb = t | suf;
      const int64_t jhi = bnd[s][1];
      if (bnd[s][0] >= jhi) continue;
      for (int64_t j = lower_bound_u64(qkq, bnd[s][0], jhi, lb);
           j < jhi && (uint64_t)qkq[j] <= rb; ++j) {
        const uint64_t d = t ^ (uint64_t)qkq[j];
        const int lcp = d == 0 ? K : (__clzll((long long)d) >> 1) + (K - 32);
        const uint32_t v = (uint32_t)qvq[j];
        int64_t aq, at;
        if (s == 0) {
          if (v & 1) continue;
          aq = v >> 1;
          if (aq < begin || aq + lcp > end) continue;
          at = i;
        } else {
          if (!(v & 1)) continue;
          aq = (int64_t)(v >> 1) + K - lcp;
          if (aq + lcp < begin || aq > end) continue;
          at = i + K - lcp;
        }
        const int slot = warp_slot(&s_n);
        if (slot < A_CAP) keys[slot] = anchor_key(aq, lcp, at, 2u * (uint32_t)i + (uint32_t)s);
      }
    }
  }
  __syncthreads();
  const int n = s_n;
  if (n > A_CAP || n == 0) {
    if (tid == 0) {
      counts[w] = 0;
      flags[w] = n > A_CAP ? F_ANCHOR_OVERFLOW : 0;
    }
    return;
  }

  // ---- 3. sort (key, tag), padded to a power of two ----
  int P = SORT_BLOCK;
  while (P < n) P <<= 1;
  for (int i = n + tid; i < P; i += blockDim.x) keys[i] = ~0ull;
  __syncthreads();
  sort_keys(keys, P);

  // ---- 4. nested-anchor removal: anchor i against every earlier anchor of
  // the sorted array from lower_bound(qe_i - k); a warp's ballot is the
  // keep bits of its 32 anchors (the window's words are no longer read) ----
  uint32_t* keep = words;  // [A_CAP / 32]
  for (int base = 0; base < n; base += PROBE_THREADS) {
    const int i = base + tid;
    bool kept = i < n;
    if (i > 0 && i < n) {
      const uint64_t ki = keys[i];
      const int64_t qe = key_qe(ki), tb0 = key_tb(ki);
      const int64_t te = tb0 + key_ln(ki);
      const uint64_t first = (uint64_t)(qe > K ? qe - K : 0) << QB_SHIFT;
      int lo = 0, hi = i + 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (keys[mid] < first) lo = mid + 1; else hi = mid;
      }
      for (int j = lo; j < i; ++j) {
        const uint64_t kj = keys[j];
        const int64_t tbj = key_tb(kj);
        if (qe <= key_qe(kj) && tb0 >= tbj && te <= tbj + key_ln(kj)) { kept = false; break; }
      }
    }
    const unsigned bits = __ballot_sync(FULL, kept);
    if (lane == 0) keep[(base >> 5) + warp] = bits;
  }
  __syncthreads();

  // ---- 5a. stable compaction: each keep word's offset by a block scan, then
  // the kept keys move down in rounds of PROBE_THREADS ----
  const int nw = (n + 31) >> 5;  // <= A_CAP / 32 <= PROBE_THREADS
  const int c = tid < nw ? __popc(keep[tid]) : 0;
  int incl = c;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0, nk = 0;
  for (int k = 0; k < PROBE_THREADS / 32; ++k) {
    before += k < warp ? s_warp[k] : 0;
    nk += s_warp[k];
  }
  if (tid < nw) s_woff[tid] = before + incl - c;
  __syncthreads();
  for (int base = 0; base < n; base += PROBE_THREADS) {
    const int i = base + tid;
    const uint32_t word = i < n ? keep[i >> 5] : 0;
    const bool kept = (word >> (i & 31)) & 1u;
    const uint64_t key = kept ? keys[i] : 0;
    const int pos = kept ? s_woff[i >> 5] + __popc(word & ((1u << (i & 31)) - 1u)) : 0;
    __syncthreads();
    if (kept) keys[pos] = key;
    __syncthreads();
  }

  // ---- 5b. tandem-repeat trim on one thread ----
  if (tid == 0) {
    int lo = 0, cnt = nk;
    if (nk >= 2) {
      int start = 0, prev = 0;
      for (int i = 1; i < nk; ++i) {
        if (!trim_cond(keys, prev, i, prev)) break;
        start = i - 1;
        prev = i;
      }
      int endi = nk - 1;
      prev = nk - 1;
      for (int i = nk - 2; i >= 0; --i) {
        if (!trim_cond(keys, i, prev, prev)) break;
        endi = i;
        prev = i;
      }
      if (!(start == 0 && endi == nk - 1)) {
        if (start >= endi) cnt = 0;
        else { lo = start; cnt = endi - start + 1; }
      }
    }
    s_lo = lo;
    s_cnt = cnt;
    counts[w] = cnt;
    flags[w] = 0;
  }
  __syncthreads();
  const int lo = s_lo, cnt = s_cnt;
  int32_t* oq = out_qb + (int64_t)w * A_CAP;
  int32_t* ot = out_tb + (int64_t)w * A_CAP;
  int32_t* ol = out_ln + (int64_t)w * A_CAP;
  for (int x = tid; x < cnt; x += blockDim.x) {
    const uint64_t key = keys[lo + x];
    oq[x] = (int32_t)key_qb(key);
    ot[x] = (int32_t)key_tb(key);
    ol[x] = (int32_t)key_ln(key);
  }
}

// ---------------------------------------------------------------------------
// pseudo_chain

struct Region {
  int lo, hi, mi;
};

// The first index of the largest score ms[i] - ln[i] over [lo, hi) (strict
// >, so ties go to the smallest i), reduced over the warp; every lane gets
// (best, bi).  An empty range gives (INT_MIN, INT_MAX).
__device__ __forceinline__ void region_max(const int32_t* cm, const int32_t* cl, int lo, int hi,
                                           int lane, int& best, int& bi) {
  int b = INT_MIN, x = INT_MAX;
  for (int i = lo + lane; i < hi; i += 32) {
    const int v = cm[i] - cl[i];
    if (v > b) { b = v; x = i; }
  }
  best = __reduce_max_sync(FULL, b);
  bi = __reduce_min_sync(FULL, b == best ? x : INT_MAX);
}

__global__ void __launch_bounds__(CHAIN_WARPS * 32) pseudo_chain_kernel(
    const int32_t* __restrict__ aqb, const int32_t* __restrict__ atb,
    const int32_t* __restrict__ aln,        // [W, A_CAP]
    const int32_t* __restrict__ acnt, const int32_t* __restrict__ aflg,
    int W, int band_base, int band_count, int max_gap, double min_score,
    int min_align_len, double heur,
    int32_t* __restrict__ ms, int32_t* __restrict__ pv,  // [W, A_CAP], past CHAIN_SLICE
    int64_t* __restrict__ rows, int32_t* __restrict__ ccnt, int32_t* __restrict__ cflg,
    int c_cap) {
  extern __shared__ int32_t chain_smem[];  // [CHAIN_WARPS][5][CHAIN_SLICE]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = blockIdx.x * CHAIN_WARPS + warp;
  if (w >= W) return;  // a whole warp: nothing below syncs across warps
  const int n = aflg[w] ? 0 : acnt[w];
  int nout = 0, flag = 0;
  int64_t* out = rows + (int64_t)w * c_cap * 8;
  const int32_t* gq = aqb + (int64_t)w * A_CAP;
  const int32_t* gt = atb + (int64_t)w * A_CAP;
  const int32_t* gl = aln + (int64_t)w * A_CAP;

  if (n == 1) {  // align_paths' single-anchor rule
    const int64_t s = gl[0];
    if ((double)s >= min_score && s >= min_align_len) {
      const int64_t r[8] = {1, s, s, s, gq[0], gq[0] + s - 1, gt[0], gt[0] + s - 1};
      if (lane < 8) out[lane] = r[lane];
      nout = 1;
    }
  } else if (n >= 2) {
    // the window's columns q, t, ln and the DP's ms (= score + ln) and prev:
    // in the warp's slice of shared memory when they fit it, else read from
    // global memory through the same code (the scratch holds ms and prev)
    const int32_t *cq = gq, *ct = gt, *cl = gl;
    int32_t* cm = ms + (int64_t)w * A_CAP;
    int32_t* cp = pv + (int64_t)w * A_CAP;
    if (n <= CHAIN_SLICE) {
      int32_t* s = chain_smem + warp * 5 * CHAIN_SLICE;
      for (int j = lane; j < n; j += 32) {
        s[j] = gq[j];
        s[CHAIN_SLICE + j] = gt[j];
        s[2 * CHAIN_SLICE + j] = gl[j];
      }
      cq = s;
      ct = s + CHAIN_SLICE;
      cl = s + 2 * CHAIN_SLICE;
      cm = s + 3 * CHAIN_SLICE;
      cp = s + 4 * CHAIN_SLICE;
      __syncwarp();
    }

    // ---- chain2_forward: anchor i scans its predecessors 32 at a time ----
    int max_ln = 0;
    for (int j = lane; j < n; j += 32) max_ln = max(max_ln, cl[j]);
    max_ln = __reduce_max_sync(FULL, max_ln);
    if (lane == 0) {
      cm[0] = 2 * cl[0];
      cp[0] = 0;
    }
    __syncwarp();
    const unsigned earlier = (1u << lane) - 1u;  // lanes the host loop visits first
    for (int i = 1; i < n; ++i) {
      const int aq = cq[i], at = ct[i], al = cl[i];
      const int thr = aq - max_ln - band_base;
      int m = al, mj = i, bcount = 0;
      for (int top = i - 1; top >= 0; top -= 32) {
        const int j = top - lane;  // lane l of the chunk: the l-th predecessor visited
        int qj = 0, tj = 0, lj = 0, mlj = 0;
        if (j >= 0) {
          qj = cq[j];
          tj = ct[j];
          lj = cl[j];
          mlj = cm[j];
        }
        const bool elig = j >= 0 && qj != aq && tj <= at;
        const unsigned eb = __ballot_sync(FULL, elig);
        // bcount as the host loop holds it on reaching j, and after j
        const int before = bcount + __popc(eb & earlier);
        const bool brk = j >= 0 && ((before >= band_count && qj < thr) ||
                                    (elig && aq - qj - lj > band_base && before + 1 > band_count));
        const unsigned bb = __ballot_sync(FULL, brk);
        const unsigned open = bb ? (bb & (0u - bb)) - 1u : FULL;  // lanes before the first break
        const int qd = aq - qj, td = at - tj;
        const int g = qd > td ? qd - td : td - qd;
        const int s = elig && ((open >> lane) & 1u) && g <= max_gap ? mlj - g : INT_MIN;
        const int best = __reduce_max_sync(FULL, s);
        if (best != INT_MIN && best >= m) {  // ties: the largest lane is the smallest j
          m = best;
          mj = top - (31 - __clz(__ballot_sync(FULL, s == best)));
        }
        if (bb) break;
        bcount += __popc(eb);
      }
      if (lane == 0) {
        cm[i] = m + al;
        cp[i] = mj;
      }
      __syncwarp();
    }

    // ---- chain2_backtrack / c2_region with an explicit stack: every lane
    // walks it in step (uniform loads), the region scans are warp-wide, and
    // lane 0 writes the rows ----
    int M, Mi;
    region_max(cm, cl, 0, n, lane, M, Mi);
    if (M <= 0) {  // the host's scan starts from (0, 0)
      M = 0;
      Mi = 0;
    }
    if (!((double)M < min_score)) {
      Region stack[S_CAP];
      int sp = 0;
      stack[sp++] = {0, n, Mi};
      while (sp > 0 && !flag) {
        const Region r = stack[--sp];
        const int lo = r.lo, hi = r.hi;
        int mi = r.mi;
        if (mi < 0) {
          int best;
          region_max(cm, cl, lo, hi, lane, best, mi);
          if ((double)best < min_score) continue;
        }
        int i = mi;
        bool first = true, left_exit = false, emit = false;
        int64_t n_anchors = 0, n_matched = 0, naq = 0, nat = 0, begin_next = 0;
        int64_t qb_b = 0, tb_b = 0, qe = 0, te = 0;
        while (true) {
          const int j = cp[i];
          if (j < lo) { left_exit = true; break; }
          ++n_anchors;
          const int64_t qi = cq[i], ti = ct[i], li = cl[i];
          if (first) {
            first = false;
            qe = qi + li - 1;
            te = ti + li - 1;
            n_matched += li;
          } else {
            n_matched += qi + li - 1 >= begin_next ? begin_next - qi : li;
          }
          qb_b = qi;
          tb_b = ti;
          begin_next = qi;
          if (i == j) {
            naq += qe - qb_b + 1;
            if (naq < min_align_len) break;
            nat += te - tb_b + 1;
            const double pident =
                (double)n_matched / (double)(naq > nat ? naq : nat) * 100.0;
            emit = !(pident < heur);
            break;
          }
          i = j;
        }
        if (left_exit && n_anchors > 0) {
          naq += qe - qb_b + 1;
          nat += te - tb_b + 1;
          if (naq >= min_align_len) {
            const double pident =
                (double)n_matched / (double)(naq > nat ? naq : nat) * 100.0;
            emit = pident >= heur;
          }
        }
        if (emit) {
          if (nout == c_cap) { flag = F_CHAIN_OVERFLOW; break; }
          const int64_t r8[8] = {n_anchors, naq, nat, n_matched, qb_b, qe, tb_b, te};
          if (lane < 8) out[nout * 8 + lane] = r8[lane];
          ++nout;
        }
        // left region first, so the right region pops first
        if (i > lo) {
          if (sp == S_CAP) { flag = F_STACK_OVERFLOW; break; }
          stack[sp++] = {lo, i, -1};
        }
        if (mi + 1 < hi) {
          if (sp == S_CAP) { flag = F_STACK_OVERFLOW; break; }
          stack[sp++] = {mi + 1, hi, -1};
        }
      }
    }
  }
  if (lane == 0) {
    ccnt[w] = flag ? 0 : nout;
    cflg[w] = flag;
  }
}

}  // namespace

extern "C" {

// Both entry points launch on `stream` and return cudaGetLastError() after
// the launch (cudaErrorInvalidValue for capacities this build was not
// compiled for).
int pseudo_probe(const void* blob, int64_t n_words, const void* win, int W, int words_out,
                 const void* qk, const void* qv, const void* qoff, const void* qtab,
                 int a_cap, int l_cap, void* out_qb, void* out_tb, void* out_ln,
                 void* counts, void* flags, void* stream) {
  if (a_cap != A_CAP || l_cap != L_CAP || n_words <= 0) return (int)cudaErrorInvalidValue;
  if (W <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(pseudo_probe_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)PROBE_SMEM);
  if (e != cudaSuccess) return (int)e;
  pseudo_probe_kernel<<<W, PROBE_THREADS, PROBE_SMEM, (cudaStream_t)stream>>>(
      (const uint32_t*)blob, n_words, (const int64_t*)win, words_out,
      (const int64_t*)qk, (const int32_t*)qv, (const int64_t*)qoff, (const uint32_t*)qtab,
      (int32_t*)out_qb, (int32_t*)out_tb, (int32_t*)out_ln, (int32_t*)counts,
      (int32_t*)flags);
  return (int)cudaGetLastError();
}

int pseudo_chain(const void* qb, const void* tb, const void* ln, const void* counts,
                 const void* flags, int W, int a_cap, int band_base, int band_count,
                 int max_gap, double min_score, int min_align_len, double heur,
                 void* ms, void* pv, void* rows, void* ccnt, void* cflg, int c_cap,
                 void* stream) {
  if (a_cap != A_CAP || c_cap <= 0) return (int)cudaErrorInvalidValue;
  if (W <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(pseudo_chain_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)CHAIN_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (W + CHAIN_WARPS - 1) / CHAIN_WARPS;
  pseudo_chain_kernel<<<blocks, CHAIN_WARPS * 32, CHAIN_SMEM, (cudaStream_t)stream>>>(
      (const int32_t*)qb, (const int32_t*)tb, (const int32_t*)ln, (const int32_t*)counts,
      (const int32_t*)flags, W, band_base, band_count, max_gap, min_score, min_align_len,
      heur, (int32_t*)ms, (int32_t*)pv, (int64_t*)rows, (int32_t*)ccnt, (int32_t*)cflg,
      c_cap);
  return (int)cudaGetLastError();
}

const char* pseudo_align_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
