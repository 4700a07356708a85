// Batched >=p-prefix seed locate for NVIDIA Hopper (sm_90a).
//
// Replaces lexicmap_tpu/parallel/pallas_kernels.py::seed_locate_batch_pallas
// (body _seed_locate_kernel) and, launched at B = 1, ::seed_locate_pallas
// (the same body for one query; kernels/seed_locate.py::seed_locate).  For
// every query b and packed table row m:
//
//     suf = 2^(32-2p) - 1,  lb = qhi & ~suf,  rb = qhi | suf
//     e0[b,m]     = #{e < cnt[m] : hi[m,e] <  lb}
//     n_hits[b,m] = #{e < cnt[m] : lb <= hi[m,e] <= rb}
//
// both 0 where query_valid[b,m] is 0.  Validity is out of band: a poly-T
// query k-mer has qhi == 0xFFFFFFFF and still counts, and lanes at or past
// cnt[m] (PAD_HI padding) are never read, so a saturated rb cannot count
// them.
//
// Design.  The TPU kernel scans each [tile, E] block of the table densely
// in VMEM (O(E) compares per query).  Rows are sorted ascending over
// [0, cnt), so here each (b, m) runs two lower-bound bisections instead:
// e0 = lower_bound(lb) over [0, cnt), end = upper_bound(rb) over [e0, cnt),
// n_hits = end - e0.  One thread per (b, m), with b the fastest index: for
// B = 32 one warp holds the 32 queries of one row, so the first bisection
// levels read the same table words (one broadcast load per warp) and the
// deeper levels hit the same L1/L2 sectors.
//
// Bound.  The kernel is bound by bytes: it does ~2*log2(E) integer compares
// per (b, m) and no arithmetic to speak of.  The bytes it must move are the
// distinct 32-byte table sectors its probes touch (at most the whole table:
// 819 MB at Mb = 20,000, E = 10,240), plus the queries, the counts and the
// two outputs.  chip_smoke.py replays the same bisection on the card to
// count those sectors for its run and reports the bound beside the time.
// Making the kernel fast (one warp or CTA per row, the row staged in shared
// memory, all B queries against it) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// first index in [lo, hi) with row[idx] >= x (row sorted ascending)
__device__ __forceinline__ int lower_bound_u32(const uint32_t* __restrict__ row,
                                               int lo, int hi, uint32_t x) {
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (__ldg(row + mid) < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// first index in [lo, hi) with row[idx] > x
__device__ __forceinline__ int upper_bound_u32(const uint32_t* __restrict__ row,
                                               int lo, int hi, uint32_t x) {
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (__ldg(row + mid) <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void seed_locate_batch_kernel(
    const uint32_t* __restrict__ seed_hi,     // [Mb, E], rows sorted over [0, cnt)
    const int32_t* __restrict__ seed_cnt,     // [Mb]
    const uint32_t* __restrict__ query_hi,    // [B, Mb]
    const uint8_t* __restrict__ query_valid,  // [B, Mb], 0 or 1
    int32_t* __restrict__ n_hits,             // [B, Mb]
    int32_t* __restrict__ e0_out,             // [B, Mb]
    int B, int Mb, int E, uint32_t suf) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;  // m * B + b
  if (i >= (int64_t)B * Mb) return;
  const int m = (int)(i / B);
  const int b = (int)(i - (int64_t)m * B);
  const int64_t q = (int64_t)b * Mb + m;
  if (!query_valid[q]) {
    n_hits[q] = 0;
    e0_out[q] = 0;
    return;
  }
  const uint32_t qhi = query_hi[q];
  const uint32_t lb = qhi & ~suf;
  const uint32_t rb = qhi | suf;
  const int cnt = min(max(seed_cnt[m], 0), E);
  const uint32_t* row = seed_hi + (int64_t)m * E;
  const int lo = lower_bound_u32(row, 0, cnt, lb);
  const int end = upper_bound_u32(row, lo, cnt, rb);
  n_hits[q] = end - lo;
  e0_out[q] = lo;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch.
int seed_locate_batch(const void* seed_hi, const void* seed_cnt,
                      const void* query_hi, const void* query_valid,
                      void* n_hits, void* e0, int B, int Mb, int E,
                      unsigned int suf, void* stream) {
  const int64_t n = (int64_t)B * Mb;
  if (n > 0) {
    const int threads = 256;
    const int64_t blocks = (n + threads - 1) / threads;
    seed_locate_batch_kernel<<<(unsigned int)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
        (const uint32_t*)seed_hi, (const int32_t*)seed_cnt,
        (const uint32_t*)query_hi, (const uint8_t*)query_valid,
        (int32_t*)n_hits, (int32_t*)e0, B, Mb, E, (uint32_t)suf);
  }
  return (int)cudaGetLastError();
}

const char* seed_locate_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
