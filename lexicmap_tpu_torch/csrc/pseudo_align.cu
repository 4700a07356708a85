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
// pseudo_probe, one CTA (512 threads) per window:
//   1. read the window's 2-bit words from the resident genome blob into
//      shared memory: funnel shift by the phase, and for a reverse-complement
//      window take the geometry block's words back to front, reversed in-word
//      and complemented (extract_packed's arithmetic, word by word);
//   2. one thread per position builds the forward and reverse-complement
//      31-mers from three shared words, drops homopolymers, and probes the
//      query's 16-bit prefix bucket table plus a lower_bound over its sorted
//      k-mers; every pair that passes the strand and begin/end rules is
//      appended with a shared atomic, keyed (qb, A - qe, tb) in 63 bits and
//      tagged with its emission order 2*position + strand, which is the
//      host's order among equal keys;
//   3. bitonic sort of (key, tag) in shared memory;
//   4. nested-anchor removal, one thread per anchor: anchor i against every
//      earlier anchor of the sorted, uncompacted array from
//      lower_bound(qe_i - k), as the host loop does, so no window cap;
//   5. a stable compaction (block scan), then the trim on one thread, with
//      its two double compares made in double as on the host.
// pseudo_chain, one thread per window: the integer DP with the early-exit
// and band_count rules as written, ties to the smallest j, then the
// backtrack with an explicit region stack (the left region pushed first, so
// the right one pops first: the recursion's emission order), the pident
// gate in double.
//
// Bound.  pseudo_probe moves few bytes (the window's 2-bit codes, the query
// table entries it probes, the anchors it writes) and does few operations;
// it is bound by the latency of the dependent probes and by the block-wide
// barriers of the sort.  pseudo_chain is bound by its serial DP: one thread
// per window walks ~70 predecessors per anchor, and since neighbouring
// threads read different windows its loads are neither coalesced nor
// overlapped, so each costs a full L2 round trip.  chip_smoke.py computes
// both bounds from the run's own data (PERF.md has the times).  Making them
// fast (a warp per window scanning 32 predecessors at once with ballots, a
// segmented sort) is later work.

#include <cuda_runtime.h>
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
constexpr int PROBE_THREADS = 512;
constexpr int PER_THREAD = A_CAP / PROBE_THREADS;
constexpr int CHAIN_THREADS = 64;

constexpr int F_ANCHOR_OVERFLOW = 1;
constexpr int F_CHAIN_OVERFLOW = 16;
constexpr int F_STACK_OVERFLOW = 32;

constexpr size_t PROBE_SMEM =
    A_CAP * sizeof(uint64_t) + A_CAP * sizeof(uint32_t) + (L_CAP / 16 + 2) * sizeof(uint32_t);

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

__device__ __forceinline__ bool pair_less(uint64_t ka, uint32_t ta, uint64_t kb, uint32_t tb) {
  return ka < kb || (ka == kb && ta < tb);
}

__device__ __forceinline__ int64_t key_qb(uint64_t key) { return (int64_t)(key >> (2 * COORD_BITS)); }
__device__ __forceinline__ int64_t key_qe(uint64_t key) {
  return (int64_t)(COORD_MAX - ((key >> COORD_BITS) & COORD_MAX));
}
__device__ __forceinline__ int64_t key_tb(uint64_t key) { return (int64_t)(key & COORD_MAX); }

// the trim's run condition (core.cpp compare_prepare): a in front of b,
// `prev` the run's previous anchor whose length divides the overlap
__device__ bool trim_cond(const uint64_t* keys, int a, int b, int prev) {
  const int64_t qa = key_qb(keys[a]), qb2 = key_qb(keys[b]);
  const int64_t ta = key_tb(keys[a]), tb2 = key_tb(keys[b]);
  const int64_t la = key_qe(keys[a]) - qa;
  const int64_t lp = key_qe(keys[prev]) - key_qb(keys[prev]);
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

__global__ void __launch_bounds__(PROBE_THREADS) pseudo_probe_kernel(
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
  uint32_t* tags = (uint32_t*)(keys + A_CAP);          // [A_CAP]
  uint32_t* words = tags + A_CAP;                      // [L_CAP/16 + 2]
  __shared__ int s_n, s_lo, s_cnt;
  __shared__ int s_scan[PROBE_THREADS];

  const int tid = threadIdx.x;
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
    for (int s = 0; s < 2; ++s) {
      const uint64_t t = s == 0 ? fwd : rcm;
      const uint64_t lb = t & ~suf, rb = t | suf;
      int64_t lo, jhi;
      if (use_tab) {
        const uint64_t b = t >> (2 * K - QTAB_BITS);
        const int64_t blo = tab[b], bhi = tab[b + 1];
        if (blo >= bhi) continue;
        lo = lower_bound_u64(qkq, blo, bhi, lb);
        jhi = bhi;
      } else {
        lo = lower_bound_u64(qkq, 0, nq, lb);
        jhi = nq;
      }
      for (int64_t j = lo; j < jhi && (uint64_t)qkq[j] <= rb; ++j) {
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
        const int slot = atomicAdd(&s_n, 1);
        if (slot < A_CAP) {
          keys[slot] = ((uint64_t)aq << (2 * COORD_BITS)) |
                       ((COORD_MAX - (uint64_t)(aq + lcp)) << COORD_BITS) | (uint64_t)at;
          tags[slot] = 2u * (uint32_t)i + (uint32_t)s;
        }
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

  // ---- 3. bitonic sort of (key, tag) ----
  int P = 1;
  while (P < n) P <<= 1;
  for (int i = n + tid; i < P; i += blockDim.x) {
    keys[i] = ~0ull;
    tags[i] = ~0u;
  }
  __syncthreads();
  for (int k2 = 2; k2 <= P; k2 <<= 1) {
    for (int j = k2 >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < P; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const bool up = (i & k2) == 0;
          const uint64_t ka = keys[i], kb = keys[ixj];
          const uint32_t ta = tags[i], tb = tags[ixj];
          if (pair_less(kb, tb, ka, ta) == up) {
            keys[i] = kb; keys[ixj] = ka;
            tags[i] = tb; tags[ixj] = ta;
          }
        }
      }
      __syncthreads();
    }
  }

  // ---- 4. nested-anchor removal (keep flags into tags) ----
  for (int i = tid; i < n; i += blockDim.x) {
    uint32_t keep = 1;
    if (i > 0) {
      const uint64_t ki = keys[i];
      const int64_t qe = key_qe(ki), tb0 = key_tb(ki);
      const int64_t te = tb0 + qe - key_qb(ki);
      int64_t up = qe - K;
      if (up < 0) up = 0;
      int lo = 0, hi = i + 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (key_qb(keys[mid]) < up) lo = mid + 1; else hi = mid;
      }
      for (int j = lo; j < i; ++j) {
        const uint64_t kj = keys[j];
        const int64_t qej = key_qe(kj), tbj = key_tb(kj);
        if (qe <= qej && tb0 >= tbj && te <= tbj + qej - key_qb(kj)) { keep = 0; break; }
      }
    }
    tags[i] = keep;  // only keys are read in this loop
  }
  __syncthreads();

  // ---- 5a. stable compaction of the kept anchors ----
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int s0 = min(n, tid * per), s1 = min(n, s0 + per);
  int mine = 0;
  for (int i = s0; i < s1; ++i) mine += (int)tags[i];
  s_scan[tid] = mine;
  __syncthreads();
  for (int d = 1; d < (int)blockDim.x; d <<= 1) {
    const int v = tid >= d ? s_scan[tid - d] : 0;
    __syncthreads();
    s_scan[tid] += v;
    __syncthreads();
  }
  const int base = s_scan[tid] - mine;
  const int nk = s_scan[blockDim.x - 1];
  uint64_t buf[PER_THREAD];
  int c = 0;
  for (int i = s0; i < s1; ++i)
    if (tags[i]) buf[c++] = keys[i];
  __syncthreads();
  for (int x = 0; x < c; ++x) keys[base + x] = buf[x];
  __syncthreads();

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
    const int64_t qb = key_qb(key);
    oq[x] = (int32_t)qb;
    ot[x] = (int32_t)key_tb(key);
    ol[x] = (int32_t)(key_qe(key) - qb);
  }
}

// ---------------------------------------------------------------------------
// pseudo_chain

struct Region {
  int lo, hi, mi;
};

__global__ void __launch_bounds__(CHAIN_THREADS) pseudo_chain_kernel(
    const int32_t* __restrict__ aqb, const int32_t* __restrict__ atb,
    const int32_t* __restrict__ aln,        // [W, A_CAP]
    const int32_t* __restrict__ acnt, const int32_t* __restrict__ aflg,
    int W, int band_base, int band_count, int max_gap, double min_score,
    int min_align_len, double heur,
    int32_t* __restrict__ ms, int32_t* __restrict__ pv,  // scratch [W, A_CAP]
    int64_t* __restrict__ rows, int32_t* __restrict__ ccnt, int32_t* __restrict__ cflg,
    int c_cap) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const int n = aflg[w] ? 0 : acnt[w];
  int nout = 0, flag = 0;
  int64_t* out = rows + (int64_t)w * c_cap * 8;
  const int32_t* cq = aqb + (int64_t)w * A_CAP;
  const int32_t* ct = atb + (int64_t)w * A_CAP;
  const int32_t* cl = aln + (int64_t)w * A_CAP;
  int32_t* sc = ms + (int64_t)w * A_CAP;
  int32_t* pp = pv + (int64_t)w * A_CAP;

  if (n == 1) {  // align_paths' single-anchor rule
    const int64_t s = cl[0];
    if ((double)s >= min_score && s >= min_align_len) {
      const int64_t r[8] = {1, s, s, s, cq[0], cq[0] + s - 1, ct[0], ct[0] + s - 1};
      for (int c = 0; c < 8; ++c) out[c] = r[c];
      nout = 1;
    }
  } else if (n >= 2) {
    // ---- chain2_forward ----
    int max_ln = 0;
    for (int j = 0; j < n; ++j) max_ln = max(max_ln, cl[j]);
    sc[0] = cl[0];
    pp[0] = 0;
    for (int i = 1; i < n; ++i) {
      const int aq = cq[i], at = ct[i];
      const int thr = aq - max_ln - band_base;
      int m = cl[i], mj = i, bcount = 0;
      for (int j = i - 1; j >= 0; --j) {
        const int bq2 = cq[j];
        if (bcount >= band_count && bq2 < thr) break;
        const int bt2 = ct[j];
        if (bq2 == aq || bt2 > at) continue;
        ++bcount;
        const int blj = cl[j];
        if (aq - bq2 - blj > band_base && bcount > band_count) break;
        const int qd = aq - bq2, td = at - bt2;
        const int g = qd > td ? qd - td : td - qd;
        if (g > max_gap) continue;
        const int s = sc[j] + blj - g;
        if (s >= m) { m = s; mj = j; }
      }
      sc[i] = m;
      pp[i] = mj;
    }

    // ---- chain2_backtrack / c2_region with an explicit stack ----
    int M = 0, Mi = 0;
    for (int i = 0; i < n; ++i)
      if (sc[i] > M) { M = sc[i]; Mi = i; }
    if (!((double)M < min_score)) {
      Region stack[S_CAP];
      int sp = 0;
      stack[sp++] = {0, n, Mi};
      while (sp > 0 && !flag) {
        const Region r = stack[--sp];
        const int lo = r.lo, hi = r.hi;
        int mi = r.mi;
        if (mi < 0) {
          mi = lo;
          int best = sc[lo];
          for (int i = lo + 1; i < hi; ++i)
            if (sc[i] > best) { best = sc[i]; mi = i; }
          if ((double)best < min_score) continue;
        }
        int i = mi;
        bool first = true, left_exit = false, emit = false;
        int64_t n_anchors = 0, n_matched = 0, naq = 0, nat = 0, begin_next = 0;
        int64_t qb_b = 0, tb_b = 0, qe = 0, te = 0;
        while (true) {
          const int j = pp[i];
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
          for (int c = 0; c < 8; ++c) out[nout * 8 + c] = r8[c];
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
  ccnt[w] = flag ? 0 : nout;
  cflg[w] = flag;
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
  const int blocks = (W + CHAIN_THREADS - 1) / CHAIN_THREADS;
  pseudo_chain_kernel<<<blocks, CHAIN_THREADS, 0, (cudaStream_t)stream>>>(
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
