// Single-query >=p-prefix seed match with best LCP, for NVIDIA Hopper (sm_90a).
//
// Replaces lexicmap_tpu/parallel/pallas_kernels.py::seed_match_pallas (body
// _seed_match_kernel).  For every packed table row m, with the query's
// k-mer split into (qhi, qlo) words like the table's:
//
//     suf = 2^(32-2p) - 1,  lb = qhi & ~suf,  rb = qhi | suf
//     e0[m]       = #{e < cnt[m] : hi[m,e] <  lb}
//     n_hits[m]   = #{e < cnt[m] : lb <= hi[m,e] <= rb}
//     best_lcp[m] = max over those in-range e of
//                   min(clz64((hi,lo)[m,e] ^ (qhi,qlo)) / 2, k)
//
// all 0 where query_valid[m] is 0, best_lcp 0 where nothing is in range.
// Lanes at or past cnt[m] are never read (validity is out of band, as in
// seed_locate.cu).
//
// Design.  The TPU kernel scans each [tile, E] block of hi AND lo densely
// in VMEM.  Rows are sorted ascending by the full (hi, lo) word, so here
// each row runs the two hi-word bisections of seed_locate.cu, then one more
// bisection of the full 64-bit query over the in-range slice [e0, end).
// Along a sorted row the LCP with the query can only fall away from the
// query's insertion point, so the best in-range LCP is at one of the two
// in-range entries beside that point: two LCPs, not n_hits of them.
// One thread per row.
//
// Bound.  Bytes: the distinct 32-byte hi and lo sectors the three
// bisections and the two neighbour reads touch (at most the 1.64 GB of hi
// plus lo at Mb = 20,000, E = 10,240), plus the queries and the three
// outputs.  chip_smoke.py replays the bisections on the card to count them.
// Each thread makes ~3*log2(E) dependent loads, so the kernel is latency
// bound at the first version's one thread per row; staging a row in shared
// memory is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int lower_bound_u32(const uint32_t* __restrict__ row,
                                               int lo, int hi, uint32_t x) {
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (__ldg(row + mid) < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int upper_bound_u32(const uint32_t* __restrict__ row,
                                               int lo, int hi, uint32_t x) {
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (__ldg(row + mid) <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ uint64_t key_at(const uint32_t* __restrict__ hi,
                                           const uint32_t* __restrict__ lo, int e) {
  return ((uint64_t)__ldg(hi + e) << 32) | (uint64_t)__ldg(lo + e);
}

__device__ __forceinline__ int lcp_bases(uint64_t a, uint64_t b, int k) {
  const uint64_t x = a ^ b;
  const int bits = x == 0 ? 64 : __clzll((long long)x);
  return min(bits >> 1, k);
}

__global__ void seed_match_kernel(
    const uint32_t* __restrict__ seed_hi,     // [Mb, E], rows sorted by (hi, lo)
    const uint32_t* __restrict__ seed_lo,     // [Mb, E]
    const int32_t* __restrict__ seed_cnt,     // [Mb]
    const uint32_t* __restrict__ query_hi,    // [Mb]
    const uint32_t* __restrict__ query_lo,    // [Mb]
    const uint8_t* __restrict__ query_valid,  // [Mb], 0 or 1
    int32_t* __restrict__ n_hits,             // [Mb]
    int32_t* __restrict__ e0_out,             // [Mb]
    int32_t* __restrict__ lcp_out,            // [Mb]
    int Mb, int E, uint32_t suf, int k) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= Mb) return;
  if (!query_valid[m]) {
    n_hits[m] = 0;
    e0_out[m] = 0;
    lcp_out[m] = 0;
    return;
  }
  const uint32_t qhi = query_hi[m];
  const int cnt = min(max(seed_cnt[m], 0), E);
  const uint32_t* hi = seed_hi + (int64_t)m * E;
  const uint32_t* lo = seed_lo + (int64_t)m * E;
  const int first = lower_bound_u32(hi, 0, cnt, qhi & ~suf);
  const int end = upper_bound_u32(hi, first, cnt, qhi | suf);
  int best = 0;
  if (end > first) {
    const uint64_t q = ((uint64_t)qhi << 32) | (uint64_t)query_lo[m];
    int a = first, b = end;  // first in-range index with key >= q
    while (a < b) {
      int mid = (a + b) >> 1;
      if (key_at(hi, lo, mid) < q) a = mid + 1; else b = mid;
    }
    if (a > first) best = lcp_bases(key_at(hi, lo, a - 1), q, k);
    if (a < end) best = max(best, lcp_bases(key_at(hi, lo, a), q, k));
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
  if (Mb > 0) {
    const int threads = 256;
    const int blocks = (Mb + threads - 1) / threads;
    seed_match_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)seed_hi, (const uint32_t*)seed_lo, (const int32_t*)seed_cnt,
        (const uint32_t*)query_hi, (const uint32_t*)query_lo,
        (const uint8_t*)query_valid, (int32_t*)n_hits, (int32_t*)e0,
        (int32_t*)best_lcp, Mb, E, (uint32_t)suf, k);
  }
  return (int)cudaGetLastError();
}

const char* seed_match_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
