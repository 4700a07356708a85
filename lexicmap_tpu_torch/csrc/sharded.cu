// The mask-sharded seed matcher's two kernels, for NVIDIA Hopper (sm_90a).
//
// match_shard replaces lexicmap_tpu/parallel/sharded.py::seed_match_shard
// (B11; the bisection kernels.py::searchsorted_rows and the LCP
// ::kmer_lcp_bases), fused with the per-query partial score of
// make_sharded_search_step.  For a shard's k-mer rows seeds [M, E] (uint32,
// k <= 16, each row sorted ascending over all E words, padding included)
// and queries [B, M], with suf = 2^(2(k-p)) - 1:
//
//     e0          = #{e < E : row[e] <  q & ~suf}   (left bisection)
//     e1          = #{e < E : row[e] <= q |  suf}   (right bisection)
//     n_hits[b,m] = q != 0 ? e1 - e0 : 0
//     lcp[b,m]    = n_hits > 0 ? (clz32(row[min(e0, E-1)] ^ q) >> 1) + k - 16 : 0
//     score[b]    = float32(sum over m of n_hits * lcp)
//
// The bisections run over the whole padded row, as the JAX version's do,
// so a query whose range reaches 0xFFFFFFFF counts the pad words.  The
// sum is exact in int64 (atomics on integers, so the same in every run),
// converted to float32 once per query and shard.
//
// compact_rows (shard_compact) replaces the body of
// lexicmap_tpu/parallel/sharded.py::ShardedSeedMatcher._bucket_fn's step
// after its seed-locate launch (B12): for each query, the rows with
// n_hits > 0 ordered by mask id, the first H of them as (gid, e0, n_hits),
// and n, the count of all of them.  A shard's gids rise with the row
// (ShardedSeedMatcher checks it when it packs the rows), so a stable
// compaction in row order is JAX's sort by gid.  Output row b of out
// [B, 3H + 1]: gid[H] | e0[H] | n_hits[H] | n; the slots from min(n, H) on
// hold (0xFFFFFFFF, 0, 0).
//
// What bounds them on this card.  match_shard: two chains of ~log2(E)
// dependent loads per (query, row), each a 32-byte sector, so the latency
// of device memory, and the sectors the bisections touch (the bound the
// smoke computes).  A warp serves one row and its lanes 32 queries: the
// first probes of every lane are the same word (one sector for the warp),
// and lanes part only where their keys do.  shard_compact: it reads two
// int32 per (query, row) and writes 12 bytes per kept hit, so bytes; a
// block per query scans its row in order (a ballot and a popcount per warp,
// the warps' totals through shared memory).
//
// Offsets are int64.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MATCH_WARPS = 8;       // warps a block of match_shard
constexpr int MATCH_MAX_BLOCKS = 4096;
constexpr int COMPACT_THREADS = 256;  // one block a query
constexpr int COMPACT_WARPS = COMPACT_THREADS / 32;
constexpr uint32_t FULL = 0xFFFFFFFFu;

// first e in [0, E) with row[e] >= x (strict) or row[e] > x (!strict), else E
__device__ __forceinline__ int bisect(const uint32_t* __restrict__ row, int E, uint32_t x,
                                      bool strict) {
  int lo = 0, hi = E;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const uint32_t v = __ldg(row + mid);
    if (strict ? v < x : v <= x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(MATCH_WARPS * 32)
    match_shard(const uint32_t* __restrict__ seeds, const uint32_t* __restrict__ queries,
                int32_t* __restrict__ n_hits, int32_t* __restrict__ lcp,
                unsigned long long* __restrict__ acc, int B, int M, int E, uint32_t suf, int k) {
  __shared__ long long part[MATCH_WARPS][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t nwarps = (int64_t)gridDim.x * MATCH_WARPS;
  for (int b0 = 0; b0 < B; b0 += 32) {  // the same trips in every thread
    const int b = b0 + lane;
    long long sum = 0;
    if (b < B) {
      for (int64_t m = (int64_t)blockIdx.x * MATCH_WARPS + warp; m < M; m += nwarps) {
        const uint32_t* row = seeds + m * E;
        const int64_t at = (int64_t)b * M + m;
        const uint32_t q = queries[at];
        const int e0 = bisect(row, E, q & ~suf, true);
        const int e1 = bisect(row, E, q | suf, false);
        const int nh = q != 0 ? e1 - e0 : 0;
        int l = 0;
        if (nh > 0) {
          const uint32_t x = __ldg(row + min(e0, E - 1)) ^ q;
          l = ((x == 0 ? 32 : __clz(x)) >> 1) + k - 16;
        }
        n_hits[at] = nh;
        lcp[at] = l;
        sum += (long long)nh * l;
      }
    }
    part[warp][lane] = sum;
    __syncthreads();
    if (warp == 0 && b < B) {
      long long s = 0;
#pragma unroll
      for (int w = 0; w < MATCH_WARPS; ++w) s += part[w][lane];
      if (s != 0) atomicAdd(acc + b, (unsigned long long)s);
    }
    __syncthreads();
  }
}

__global__ void score_f32(const unsigned long long* __restrict__ acc, float* __restrict__ score,
                          int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) score[b] = (float)(long long)acc[b];
}

__global__ void __launch_bounds__(COMPACT_THREADS)
    compact_rows(const int32_t* __restrict__ nh, const int32_t* __restrict__ e0,
                 const int32_t* __restrict__ gids, int32_t* __restrict__ out, int mb, int H) {
  __shared__ int totals[COMPACT_WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t b = blockIdx.x;
  const int32_t* nh_b = nh + b * mb;
  const int32_t* e0_b = e0 + b * mb;
  int32_t* o = out + b * (3 * (int64_t)H + 1);
  int base = 0;  // hits before this tile, the same in every thread
  for (int r0 = 0; r0 < mb; r0 += COMPACT_THREADS) {
    const int r = r0 + threadIdx.x;
    const int n = r < mb ? nh_b[r] : 0;
    const unsigned ballot = __ballot_sync(FULL, n > 0);
    if (lane == 0) totals[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, tile = 0;
#pragma unroll
    for (int w = 0; w < COMPACT_WARPS; ++w) {
      before += w < warp ? totals[w] : 0;
      tile += totals[w];
    }
    const int pos = base + before + __popc(ballot & ((1u << lane) - 1u));
    if (n > 0 && pos < H) {
      o[pos] = gids[r];
      o[H + pos] = e0_b[r];
      o[2 * H + pos] = n;
    }
    base += tile;
    __syncthreads();  // totals is written again by the next tile
  }
  for (int j = min(base, H) + threadIdx.x; j < H; j += COMPACT_THREADS) {
    o[j] = -1;
    o[H + j] = 0;
    o[2 * H + j] = 0;
  }
  if (threadIdx.x == 0) o[3 * H] = base;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the first CUDA error of the calls, else 0.
// acc is int64 scratch of B words.
int seed_match_shard(const void* seeds, const void* queries, void* n_hits, void* lcp, void* acc,
                     void* score, int B, int M, int E, unsigned int suf, int k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0) return (int)cudaSuccess;
  cudaError_t err = cudaMemsetAsync(acc, 0, (size_t)B * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  if (M > 0) {
    int64_t blocks = ((int64_t)M + MATCH_WARPS - 1) / MATCH_WARPS;
    if (blocks > MATCH_MAX_BLOCKS) blocks = MATCH_MAX_BLOCKS;
    match_shard<<<(unsigned)blocks, MATCH_WARPS * 32, 0, s>>>(
        (const uint32_t*)seeds, (const uint32_t*)queries, (int32_t*)n_hits, (int32_t*)lcp,
        (unsigned long long*)acc, B, M, E, (uint32_t)suf, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  score_f32<<<(B + 255) / 256, 256, 0, s>>>((const unsigned long long*)acc, (float*)score, B);
  return (int)cudaGetLastError();
}

int shard_compact(const void* nh, const void* e0, const void* gids, void* out, int B, int mb,
                  int H, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  compact_rows<<<(unsigned)B, COMPACT_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)nh, (const int32_t*)e0, (const int32_t*)gids, (int32_t*)out, mb, H);
  return (int)cudaGetLastError();
}

const char* sharded_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
