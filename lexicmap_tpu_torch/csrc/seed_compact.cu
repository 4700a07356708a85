// The seed matcher's compaction for NVIDIA Hopper (sm_90a).
//
// compact_count + compact_write replace the tail of
// lexicmap_tpu/parallel/device_search.py::DeviceSeedMatcher._bucket_fn (B4:
// after B1's pallas_call, each query's row outputs sorted by mask id and
// counted), together with the host sort and chunk merge that the matcher's
// batch needs after it, for every bucket of a batch in one pass.
//
// Inputs.  stk (int32): bucket k's B1 outputs [2, B, Mb_k] (n_hits, then
// e0) at element 2 * B * starts[k], Mb_k = starts[k+1] - starts[k].  The
// matcher's static row order: perm[i], the global row starts[k] + r of
// ordered row i, all device rows sorted by (mask, chunk base); cont[i] = 1
// where row i is the chunk of row i-1's mask that follows it (base[i] =
// base[i-1] + cnt[i-1]); gid[i] and base[i] (int64), the mask id and the
// chunk's first entry in its mask.  With, for query b, v(i) = n_hits and
// e(i) = e0 + base[i]:
//
//     merged(i) = cont[i] && v(i) > 0 && v(i-1) > 0 && e(i-1) + v(i-1) == e(i)
//     start(i)  = v(i) > 0 && !merged(i)
//
// each start gives one triple (gid[i], e(i), v(i) + v of the merged rows
// after it), query by query in row order, which is (mask, e0) order since a
// hit's e(i) lies in [base[i], base[i] + cnt[i]).  Out: int64 [3, T]
// (masks, e0, n_hits) and offsets int64 [B + 1], query b's triples at
// [offsets[b], offsets[b+1]).  No truncation: every hit is kept.
//
// What bounds it on this card.  No arithmetic to speak of: it reads one
// int32 n_hits per (query, row), e0, gid and base only where a row hits, and
// writes 24 bytes a triple, so bytes.  The reads go through perm: within a
// bucket the ordered rows rise with the row, so a warp's 32 rows fall on a
// few runs of each bucket's rows, not on 32 scattered sectors.  The order
// is built once when the matcher packs its rows, so no sort runs here.
//
// Design.  A unit is one query and a span of SPAN ordered rows (the wrapper
// picks SPAN), a warp each: at the 10k shape (B = 32, 20,000 rows) some
// 5,000 warps, where a block per query would fill 32 of the 132 SMs.
//  - compact_count: each warp reads its rows 32 at a time, the row before
//    from the lane before (a shuffle; lane 0 from the previous round's lane
//    31), and counts its starts with a ballot.  The last block to finish
//    (a ticket after a fence) scans the units' counts in (query, span)
//    order into int64 offsets: a thread per run of consecutive counts, then
//    a block scan of the runs' sums.
//  - the host reads offsets[B], the triple count, and sizes the output;
//  - compact_write: each warp finds its starts again and writes them from
//    its unit's offset plus the ballot's prefix count.  A start walks on
//    over the rows with cont set while they merge, summing n_hits; a mask
//    has few chunk rows, so the walk is short, and rows not chunked stop at
//    one byte read.

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BUCKETS = 32;
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Rows {
  const int32_t* stk;
  const int32_t* perm;
  const uint8_t* cont;
  const int64_t* gid;
  const int64_t* base;
  int64_t R;  // ordered rows
  int B;
  int U;     // units a query: ceil(R / span)
  int span;  // ordered rows a unit
};

__device__ __forceinline__ void stage_starts(const int32_t* starts, int nb, int32_t* st) {
  for (int i = threadIdx.x; i <= nb; i += blockDim.x) st[i] = starts[i];
  __syncthreads();
}

// n_hits of query b at ordered row i; e its mask-global e0 where it hits.
__device__ __forceinline__ int load_row(const Rows& a, const int32_t* st, int b, int64_t i,
                                        int64_t& e) {
  const int32_t g = __ldg(a.perm + i);
  int k = 0;
  while (g >= st[k + 1]) ++k;
  const int64_t s0 = st[k], mb = st[k + 1] - s0;
  const int32_t* at = a.stk + 2 * (int64_t)a.B * s0 + (int64_t)b * mb + (g - s0);
  const int v = __ldg(at);
  e = v > 0 ? (int64_t)__ldg(at + (int64_t)a.B * mb) + __ldg(a.base + i) : 0;
  return v;
}

// The starts of unit u (query b, ordered rows [r0, r1)) for one warp; with
// WRITE, each start's triple goes to slot `at` + its rank of out [3, T].
// Returns the unit's count of starts (the same in every lane).
template <bool WRITE>
__device__ int unit_starts(const Rows& a, const int32_t* st, int64_t u, int64_t at, int64_t T,
                           int64_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int b = (int)(u / a.U);
  const int64_t r0 = (u - (int64_t)b * a.U) * a.span;
  const int64_t r1 = min(r0 + a.span, a.R);
  int vp = 0;  // the row before this round's lane 0: n_hits and e0 + n_hits
  int64_t endp = 0;
  if (r0 > 0) {
    int64_t e;
    vp = load_row(a, st, b, r0 - 1, e);
    endp = e + vp;
  }
  int n = 0;
  for (int64_t i0 = r0; i0 < r1; i0 += 32) {
    const int64_t i = i0 + lane;
    int v = 0;
    int64_t e = 0;
    bool c = false;
    if (i < r1) {
      v = load_row(a, st, b, i, e);
      c = __ldg(a.cont + i) != 0;
    }
    const int64_t end = e + v;
    int pv = __shfl_up_sync(FULL, v, 1);
    int64_t pend = __shfl_up_sync(FULL, end, 1);
    if (lane == 0) {
      pv = vp;
      pend = endp;
    }
    const bool start = v > 0 && !(c && pv > 0 && pend == e);
    const unsigned ballot = __ballot_sync(FULL, start);
    if (WRITE && start) {
      const int64_t pos = at + n + __popc(ballot & ((1u << lane) - 1u));
      int64_t sum = v, ep = end;
      for (int64_t j = i + 1; j < a.R && __ldg(a.cont + j); ++j) {
        int64_t ej;
        const int vj = load_row(a, st, b, j, ej);
        if (vj <= 0 || ej != ep) break;
        sum += vj;
        ep = ej + vj;
      }
      out[pos] = __ldg(a.gid + i);
      out[T + pos] = e;
      out[2 * T + pos] = sum;
    }
    n += __popc(ballot);
    vp = __shfl_sync(FULL, v, 31);
    endp = __shfl_sync(FULL, end, 31);
  }
  return n;
}

// Exclusive int64 scan of counts [n] into woff by the whole block; returns
// the total (in every thread).
__device__ int64_t block_scan(const int32_t* counts, int64_t n, int64_t* woff) {
  __shared__ int64_t warp_sums[WARPS];
  __shared__ int64_t total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t per = (n + THREADS - 1) / THREADS;
  const int64_t j0 = min(threadIdx.x * per, n), j1 = min(j0 + per, n);
  int64_t mine = 0;
  for (int64_t j = j0; j < j1; ++j) mine += __ldcg(counts + j);
  int64_t incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t x = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += x;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int64_t s = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int64_t x = warp_sums[w];
      warp_sums[w] = s;
      s += x;
    }
    total = s;
  }
  __syncthreads();
  int64_t at = warp_sums[warp] + incl - mine;
  for (int64_t j = j0; j < j1; ++j) {
    woff[j] = at;
    at += __ldcg(counts + j);
  }
  return total;
}

// counts [B * U] and a ticket after them, 0 at the launch; woff [B * U]
// then offsets [B + 1].
__global__ void __launch_bounds__(THREADS)
    compact_count(Rows a, const int32_t* __restrict__ starts, int nb, int32_t* counts,
                  unsigned* ticket, int64_t* __restrict__ woff) {
  __shared__ int32_t st[MAX_BUCKETS + 1];
  __shared__ bool last;
  stage_starts(starts, nb, st);
  const int64_t units = (int64_t)a.B * a.U;
  const int64_t u = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (u < units) {  // warp-uniform
    const int n = unit_starts<false>(a, st, u, 0, 0, nullptr);
    if ((threadIdx.x & 31) == 0) counts[u] = n;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int64_t total = block_scan(counts, units, woff);
  __syncthreads();  // woff written by other threads of the block
  int64_t* offsets = woff + units;
  for (int b = threadIdx.x; b < a.B; b += THREADS) offsets[b] = woff[(int64_t)b * a.U];
  if (threadIdx.x == 0) offsets[a.B] = total;
}

__global__ void __launch_bounds__(THREADS)
    compact_write(Rows a, const int32_t* __restrict__ starts, int nb,
                  const int64_t* __restrict__ woff, int64_t T, int64_t* __restrict__ out) {
  __shared__ int32_t st[MAX_BUCKETS + 1];
  stage_starts(starts, nb, st);
  const int64_t u = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (u < (int64_t)a.B * a.U) unit_starts<true>(a, st, u, woff[u], T, out);
}

Rows rows_of(const void* stk, const void* perm, const void* cont, const void* gid,
             const void* base, long long R, int B, int span) {
  return Rows{(const int32_t*)stk, (const int32_t*)perm, (const uint8_t*)cont,
              (const int64_t*)gid, (const int64_t*)base, (int64_t)R, B,
              (int)((R + span - 1) / span), span};
}

unsigned blocks_for(const Rows& a) {
  return (unsigned)(((int64_t)a.B * a.U + WARPS - 1) / WARPS);
}

}  // namespace

extern "C" {

// The count pass and the scan, on `stream`: scratch is int32 [B * U + 1]
// (counts, then the ticket), woff int64 [B * U + B + 1] (the units'
// offsets, then offsets [B + 1]).  Takes R >= 1, B >= 1, nb <= 32.
int seed_compact_count(const void* stk, const void* perm, const void* cont, const void* gid,
                       const void* base, const void* starts, int nb, long long R, int B,
                       int span, void* scratch, void* woff, void* stream) {
  if (nb > MAX_BUCKETS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Rows a = rows_of(stk, perm, cont, gid, base, R, B, span);
  int32_t* counts = (int32_t*)scratch;
  unsigned* ticket = (unsigned*)(counts + (int64_t)B * a.U);
  cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  compact_count<<<blocks_for(a), THREADS, 0, s>>>(a, (const int32_t*)starts, nb, counts, ticket,
                                                   (int64_t*)woff);
  return (int)cudaGetLastError();
}

// The write pass, on `stream`, after seed_compact_count with the same
// arguments: out int64 [3, T], T = offsets[B].
int seed_compact_write(const void* stk, const void* perm, const void* cont, const void* gid,
                       const void* base, const void* starts, int nb, long long R, int B,
                       int span, const void* woff, long long T, void* out, void* stream) {
  if (nb > MAX_BUCKETS) return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  const Rows a = rows_of(stk, perm, cont, gid, base, R, B, span);
  compact_write<<<blocks_for(a), THREADS, 0, (cudaStream_t)stream>>>(
      a, (const int32_t*)starts, nb, (const int64_t*)woff, (int64_t)T, (int64_t*)out);
  return (int)cudaGetLastError();
}

const char* seed_compact_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
