// Single-query >=p-prefix seed match with best LCP, for NVIDIA Hopper (sm_90a).
//
// Replaces lexicmap_tpu/parallel/pallas_kernels.py::seed_match_pallas (B3,
// body _seed_match_kernel).  For every packed table row m, with the query's
// k-mer split into (qhi, qlo) words like the table's:
//
//     suf = 2^(32-2p) - 1,  lb = qhi & ~suf,  rb = qhi | suf
//     e0[m]       = #{e < cnt[m] : hi[m,e] <  lb}
//     n_hits[m]   = #{e < cnt[m] : lb <= hi[m,e] <= rb}
//     best_lcp[m] = max over those in-range e of
//                   min(clz64((hi,lo)[m,e] ^ (qhi,qlo)) / 2, k)
//
// all 0 where query_valid[m] is 0, best_lcp 0 where nothing is in range.
// Rows are sorted ascending by the full (hi, lo) word over [0, cnt); no
// entry at or past cnt[m] takes part, whatever its hi and lo words hold.
//
// What bounds it on this card.  A few integer operations per word read, so
// memory: scattered 32-byte sectors, served far below the 3.35 TB/s
// streaming rate, and, with one query per row, the row's own chain of
// dependent loads, which 20,000 threads (one wave) cannot hide.  B2
// (seed_locate.cu) has the same two limits on the hi words alone.
//
// Design.  B2's search first (seed_search.cuh: the top head loaded with the
// query, a bisection of the heads row[j*RUN] with lb's and rb's probes
// shared, then the runs after the last head below each bound read whole),
// which gives e0, end and the hi words of the runs around both bounds in
// registers.  Then the lo words, only where the slice [e0, end) is not
// empty (most rows at p >= 11 with random queries read no lo word at all):
//  - the slice lies in the runs already in registers (at most one head
//    inside it): the lo words of those of them that the slice meets, read
//    whole in one round trip, and the max over every in-range entry;
//  - a longer slice (small p, long runs of equal hi words): its heads are
//    all in range, so a bisection of them on the full (hi, lo) key finds
//    the run that holds the query's insertion point, whose hi (unless it
//    is one of the two in registers) and lo words are read whole.  Along
//    a sorted row the LCP only falls away from the insertion point, so the
//    best in-range LCP is at one of its two neighbours: both lie in that
//    run or at the head after it, whose key the bisection read.
// Three bisections one after the other (lb, then rb from lb's answer, then
// the full key over the slice) and the two neighbours' reads give the same
// outputs from ~28 dependent loads at E = 10,240 and the sectors of three
// searches; this design reads ~40% fewer sectors there and runs about twice
// as fast (PERF.md).
//
// RUN = 8, B2's 16 halved: a run is one 32-byte sector of hi and one of lo,
// so a slice within a run costs one lo sector, for one more head level.
// Device time in turns on an NVIDIA H100 80GB HBM3 at 700 W, 20,000 rows x
// 10,240, p = 15, against this source built with other choices: RUN = 16
// 3-7% slower, RUN = 32 17-25% slower; reading only the 16-byte lo pieces
// that meet the slice instead of whole runs no faster at RUN = 16 and ~4%
// slower at RUN = 8.  Numbers in PERF.md.  To time another RUN, pass a copy
// of this file with RUN changed (seed_search.cuh beside it) to
// chip_smoke.py --compare-source.
//
// Row offsets are int64.  Runs are read in 16-byte loads only where E is a
// multiple of RUN and both tables are 16-byte aligned, else word by word.

#include "seed_search.cuh"

namespace {

using namespace seed_search;

constexpr int THREADS = 64;  // small blocks: 20,000 rows reach every SM

constexpr int RUN = 8;  // entries a head stands for, see the note

__device__ __forceinline__ int lcp_bases(uint64_t a, uint64_t b, int k) {
  const uint64_t x = a ^ b;
  const int bits = x == 0 ? 64 : __clzll((long long)x);
  return min(bits >> 1, k);
}

// The best LCP with q over the entries of the run at b inside [first, end),
// from their hi words v and lo words w.
__device__ __forceinline__ int run_best(const uint32_t (&v)[RUN], const uint32_t (&w)[RUN],
                                        int b, int first, int end, uint64_t q, int k) {
  int best = 0;
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    if (b + i >= first && b + i < end)
      best = max(best, lcp_bases(((uint64_t)v[i] << 32) | w[i], q, k));
  }
  return best;
}

// B3: a thread per row, see the note.
__global__ void __launch_bounds__(THREADS)
match_single(const uint32_t* __restrict__ seed_hi,     // [Mb, E], rows sorted by (hi, lo)
             const uint32_t* __restrict__ seed_lo,     // [Mb, E]
             const int32_t* __restrict__ seed_cnt,     // [Mb]
             const uint32_t* __restrict__ query_hi,    // [Mb]
             const uint32_t* __restrict__ query_lo,    // [Mb]
             const uint8_t* __restrict__ query_valid,  // [Mb], 0 or 1
             int32_t* __restrict__ n_hits, int32_t* __restrict__ e0_out,
             int32_t* __restrict__ lcp_out, int Mb, int E, uint32_t suf, int k, bool vec) {
  const int64_t m = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= Mb) return;
  const uint32_t* hrow = seed_hi + m * E;
  const uint32_t* lrow = seed_lo + m * E;
  // the top head, validity, query words and count in one round trip
  const int half = ((E + RUN - 1) / RUN) >> 1;
  const uint32_t top = E > 0 ? __ldg(hrow + (int64_t)half * RUN) : 0u;
  const bool ok = query_valid[m];
  const uint32_t qhi = query_hi[m], qlo = query_lo[m];
  const int cnt = ok ? min(max(seed_cnt[m], 0), E) : 0;
  RowRuns<RUN> r;
  locate_runs(hrow, top, half, cnt, qhi & ~suf, qhi | suf, vec, r);
  const int first = r.e0, end = r.end;
  int best = 0;
  if (end > first) {
    const uint64_t q = ((uint64_t)qhi << 32) | qlo;
    if (r.c1 - r.c0 <= 1) {
      // the slice lies in the runs in registers: their lo words where the
      // slice meets them
      const int b0 = (r.c0 - 1) * RUN, b1 = (r.c1 - 1) * RUN;
      const bool use0 = r.c0 > 0 && first < b0 + RUN, use1 = r.c1 != r.c0;
      uint32_t w0[RUN], w1[RUN];
      if (use0) run_load(lrow, b0, cnt, vec, w0);
      if (use1) run_load(lrow, b1, cnt, vec, w1);
      if (use0) best = run_best(r.v0, w0, b0, first, end, q, k);
      if (use1) best = max(best, run_best(r.v1, w1, b1, first, end, q, k));
    } else {
      // heads c0 .. c1 - 1 are all in range: the first of them with a key
      // >= q, a (c1 if none), and its key kh
      int a = r.c0, b = r.c1;
      uint64_t kh = 0;
      while (a < b) {
        const int mid = (a + b) >> 1;
        const int64_t at = (int64_t)mid * RUN;
        const uint64_t key = ((uint64_t)__ldg(hrow + at) << 32) | __ldg(lrow + at);
        if (key < q) {
          a = mid + 1;
        } else {
          b = mid;
          kh = key;
        }
      }
      // the insertion point is in (R, R + RUN] for R = (a - 1) * RUN (0 if
      // a is 0), and R + RUN is head a's index
      if (a < r.c1) best = lcp_bases(kh, q, k);
      if (a * RUN > first) {  // the run meets the slice
        const int R = (a - 1) * RUN;
        const bool held = a == r.c0 || a == r.c1;  // the run of v0 or v1
        uint32_t v[RUN], w[RUN];
        if (!held) run_load(hrow, R, cnt, vec, v);
        run_load(lrow, R, cnt, vec, w);
        if (held) {
#pragma unroll
          for (int i = 0; i < RUN; ++i) v[i] = a == r.c0 ? r.v0[i] : r.v1[i];
        }
        best = max(best, run_best(v, w, R, first, end, q, k));
      }
    }
  }
  n_hits[m] = end - first;
  e0_out[m] = first;
  lcp_out[m] = best;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch.
int seed_match(const void* seed_hi, const void* seed_lo, const void* seed_cnt,
               const void* query_hi, const void* query_lo, const void* query_valid,
               void* n_hits, void* e0, void* best_lcp, int Mb, int E,
               unsigned int suf, int k, void* stream) {
  if (Mb == 0) return (int)cudaSuccess;
  // a run inside its row and 16-byte aligned in both tables
  const bool vec = E % RUN == 0 && (((uintptr_t)seed_hi | (uintptr_t)seed_lo) & 15) == 0;
  match_single<<<(unsigned)(((int64_t)Mb + THREADS - 1) / THREADS), THREADS, 0,
                 (cudaStream_t)stream>>>(
      (const uint32_t*)seed_hi, (const uint32_t*)seed_lo, (const int32_t*)seed_cnt,
      (const uint32_t*)query_hi, (const uint32_t*)query_lo, (const uint8_t*)query_valid,
      (int32_t*)n_hits, (int32_t*)e0, (int32_t*)best_lcp, Mb, E, (uint32_t)suf, k, vec);
  return (int)cudaGetLastError();
}

// The run length compiled in, for the host's replay of the search.
int seed_match_run() { return RUN; }

const char* seed_match_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
