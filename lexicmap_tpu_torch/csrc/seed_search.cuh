// Device code shared by seed_locate.cu (B1, B2) and seed_match.cu (B3): the
// paired bisection of a prefix range's two bounds, and B2's search of one
// sorted row for one query over its heads and runs of RUN entries
// (seed_locate.cu's note says why it has this shape; each kernel picks its
// RUN).  kernels/build.py hashes this header into the name of every library
// whose source includes it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace seed_search {

// s[i * STRIDE], through the read-only path from global memory.
template <bool GLOBAL, int STRIDE>
__device__ __forceinline__ uint32_t word(const uint32_t* __restrict__ s, int i) {
  return GLOBAL ? __ldg(s + (int64_t)i * STRIDE) : s[i * STRIDE];
}

// Over sorted s[i * STRIDE]: lo0 becomes the first index of [lo0, hi0) with
// s[i * STRIDE] >= lb (hi0 if none), lo1 the first of [lo1, hi1) with one
// > rb.  One bisection step of each per round; while the two intervals are
// one, so is the probe, and after they part both probes are issued before
// either compare.
template <bool GLOBAL, int STRIDE = 1>
__device__ __forceinline__ void search_pair(const uint32_t* __restrict__ s, uint32_t lb,
                                            uint32_t rb, int& lo0, int hi0, int& lo1, int hi1) {
  while (lo0 < hi0 || lo1 < hi1) {
    const bool a0 = lo0 < hi0, a1 = lo1 < hi1;
    const int m0 = (lo0 + hi0) >> 1, m1 = (lo1 + hi1) >> 1;
    const bool own1 = a1 && !(a0 && m0 == m1);
    uint32_t v0 = 0, v1 = 0;
    if (a0) v0 = word<GLOBAL, STRIDE>(s, m0);
    if (own1) v1 = word<GLOBAL, STRIDE>(s, m1);
    if (!own1) v1 = v0;
    if (a0) {
      if (v0 < lb) lo0 = m0 + 1; else hi0 = m0;
    }
    if (a1) {
      if (v1 <= rb) lo1 = m1 + 1; else hi1 = m1;
    }
  }
}

// The run row[b .. b + RUN) whole: 16-byte loads where `vec` (the row
// 16-byte aligned and the run inside it), else the words below cnt alone.
// Every load is issued before any word is used.
template <int RUN>
__device__ __forceinline__ void run_load(const uint32_t* __restrict__ row, int b, int cnt,
                                         bool vec, uint32_t (&v)[RUN]) {
  static_assert(RUN % 4 == 0, "runs are read in 16-byte loads");
  if (vec) {
    const uint4* r4 = reinterpret_cast<const uint4*>(row + b);
#pragma unroll
    for (int i = 0; i < RUN / 4; ++i) {
      const uint4 w = __ldg(r4 + i);
      v[4 * i] = w.x;
      v[4 * i + 1] = w.y;
      v[4 * i + 2] = w.z;
      v[4 * i + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < RUN; ++i) v[i] = b + i < cnt ? __ldg(row + b + i) : 0u;
  }
}

// Entries of the run at b below cnt on the left of x (le: <= x, else < x).
template <int RUN>
__device__ __forceinline__ int run_count(const uint32_t (&v)[RUN], int b, int cnt, uint32_t x,
                                         bool le) {
  int c = 0;
#pragma unroll
  for (int i = 0; i < RUN; ++i) c += (b + i < cnt) & (le ? v[i] <= x : v[i] < x);
  return c;
}

// One query's bounds in one row sorted over [0, cnt), in heads and runs.
template <int RUN>
struct RowRuns {
  int c0, c1;        // heads row[j * RUN], j < ceil(cnt / RUN), below lb / at or below rb
  int e0, end;       // the in-range slice [e0, end)
  uint32_t v0[RUN];  // the run at (c0 - 1) * RUN, where c0 > 0
  uint32_t v1[RUN];  // the run at (c1 - 1) * RUN, where c1 > 0 (v0's when c1 == c0)
};

// B2's search: `top` is the top head row[half * RUN], half = ceil(E/RUN)/2,
// which the caller loads with its query in the first round trip.  The top
// level (a top head at or past cnt is above every bound), then a bisection
// of the heads left, lb and rb sharing their probes, then the run after
// the last head below each bound read whole and counted.
template <int RUN>
__device__ __forceinline__ void locate_runs(const uint32_t* __restrict__ row, uint32_t top,
                                            int half, int cnt, uint32_t lb, uint32_t rb,
                                            bool vec, RowRuns<RUN>& r) {
  const int n = (cnt + RUN - 1) / RUN;  // heads below cnt
  const bool l0 = half < n && top < lb, l1 = half < n && top <= rb;
  r.c0 = l0 ? half + 1 : 0;
  r.c1 = l1 ? half + 1 : 0;
  search_pair<true, RUN>(row, lb, rb, r.c0, l0 ? n : min(half, n), r.c1, l1 ? n : min(half, n));
  // c0 heads lie below lb: e0 is in the run of head c0 - 1 (0 if none)
  const int b0 = (r.c0 - 1) * RUN, b1 = (r.c1 - 1) * RUN;
  const bool own1 = r.c1 > 0 && r.c1 != r.c0;
  if (r.c0 > 0) run_load(row, b0, cnt, vec, r.v0);
  if (own1) run_load(row, b1, cnt, vec, r.v1);
  if (!own1) {
#pragma unroll
    for (int i = 0; i < RUN; ++i) r.v1[i] = r.v0[i];
  }
  r.e0 = r.c0 > 0 ? b0 + run_count(r.v0, b0, cnt, lb, false) : 0;
  r.end = r.c1 > 0 ? b1 + run_count(r.v1, b1, cnt, rb, true) : 0;
}

}  // namespace seed_search
