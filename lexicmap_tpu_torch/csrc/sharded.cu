// The mask-sharded seed matcher's two kernels, for NVIDIA Hopper (sm_90a).
//
// match_shard replaces lexicmap_tpu/parallel/sharded.py::seed_match_shard
// (B11; the bisection kernels.py::searchsorted_rows and the LCP
// ::kmer_lcp_bases), fused with the per-query score of
// make_sharded_search_step, for all L local shards of a rank in one
// launch.  For shard l's k-mer rows seeds[l] [M, E] (uint32, k <= 16, each
// row sorted ascending over all E words, padding included) and queries[l]
// [B, M], with suf = 2^(2(k-p)) - 1:
//
//     e0            = #{e < E : row[e] <  q & ~suf}   (left bisection)
//     e1            = #{e < E : row[e] <= q |  suf}   (right bisection)
//     n_hits[l,b,m] = q != 0 ? e1 - e0 : 0
//     lcp[l,b,m]    = n_hits > 0 ? (clz32(row[e0] ^ q) >> 1) + k - 16 : 0
//     score[b]      = float32(sum over l, m of n_hits * lcp)
//
// (e0 < E wherever n_hits > 0, so row[e0] is JAX's row[min(e0, E-1)].)  The
// bisections run over the whole padded row, as the JAX version's do, so a
// query whose range reaches 0xFFFFFFFF counts the pad words.  The sum is
// exact in int64 (atomics on integers, so the same in every run); the last
// block to finish converts it to float32 once per query.
//
// compact_rows (shard_compact) replaces the body of
// lexicmap_tpu/parallel/sharded.py::ShardedSeedMatcher._bucket_fn's step
// after its seed-locate launch (B12): for each query, the rows with
// n_hits > 0 ordered by mask id, the first H of them as (gid, e0, n_hits),
// and n, the count of all of them.  A shard's gids rise with the row
// (ShardedSeedMatcher checks it when it packs the rows), so a stable
// compaction in row order is JAX's sort by gid.  One launch covers a
// rank's L local shards; output row (l, b) of out [L, B, 3H + 1]: gid[H] |
// e0[H] | n_hits[H] | n; the slots from min(n, H) on hold (0xFFFFFFFF, 0,
// 0).
//
// What bounds them on this card.  match_shard is B1's search
// (seed_locate.cu's note): a few compares per word read, so the scattered
// 32-byte sectors the searches read, the chains of dependent loads hidden
// behind the other warps.  The design is B1's sampled one, over the whole
// padded row (cnt = E): a warp per row of any shard serves the row's B
// queries 32 at a time; it stages SAMPLE pivots of the row in shared memory
// in one round trip, each lane finds its query's pivot interval there and
// bisects only that interval in global memory, lb and rb sharing their
// probes while their intervals are one (seed_search.cuh).  The queries of a
// row share the top levels, and the two bounds most of the rest.  Each
// block sums its rows' products per query through shared memory, one
// atomic a query a block.  shard_compact: it reads two int32 per (query,
// row) and writes 12 bytes per kept hit, so bytes; one launch covers the L
// local shards, a block per (query, shard), each warp a contiguous span of
// the row: it counts its span's hits first (ballots, no barrier), then one
// barrier gives each warp its offset and it writes its span (the row read
// twice, the second time from L1).
//
// Offsets are int64.

#include <cstdint>

#include "seed_search.cuh"

namespace {

using namespace seed_search;

constexpr int MATCH_ROWS = 8;         // rows (a warp each) a block of match_shard
constexpr int SAMPLE = 32;            // pivots in a row's sample, B1's
constexpr int COMPACT_THREADS = 256;  // one block a (query, shard)
constexpr int COMPACT_WARPS = COMPACT_THREADS / 32;
constexpr uint32_t FULL = 0xFFFFFFFFu;

// seeds [rows, E] with rows = L * M (shard l's row m at l * M + m), queries
// and the outputs [L, B, M]; acc: B int64 sums, then the blocks' finish
// count, all 0 at the launch.
__global__ void __launch_bounds__(MATCH_ROWS * 32)
    match_shard(const uint32_t* __restrict__ seeds, const uint32_t* __restrict__ queries,
                int32_t* __restrict__ n_hits, int32_t* __restrict__ lcp,
                unsigned long long* __restrict__ acc, float* __restrict__ score, int64_t rows,
                int B, int M, int E, uint32_t suf, int k) {
  __shared__ uint32_t pivots[MATCH_ROWS][SAMPLE];
  __shared__ long long part[MATCH_ROWS][32];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t r = (int64_t)blockIdx.x * MATCH_ROWS + warp;
  const bool live = r < rows;  // warp-uniform; a dead warp still meets the barriers
  const int64_t l = live ? r / M : 0, m = live ? r - l * M : 0;
  const uint32_t* row = seeds + r * E;
  const Sample smp = stage_sample<SAMPLE>(row, live ? E : 0, lane, pivots[warp]);
  for (int b0 = 0; b0 < B; b0 += 32) {  // the same trips in every thread
    const int b = b0 + lane;
    long long c = 0;
    if (live && b < B) {
      const int64_t at = (l * B + b) * M + m;
      const uint32_t q = queries[at];
      int e0, end;
      sampled_bounds(row, pivots[warp], smp, E, q & ~suf, q | suf, q != 0, e0, end);
      const int nh = end - e0;
      int lc = 0;
      if (nh > 0) {
        const uint32_t x = __ldg(row + e0) ^ q;
        lc = ((x == 0 ? 32 : __clz(x)) >> 1) + k - 16;
      }
      n_hits[at] = nh;
      lcp[at] = lc;
      c = (long long)nh * lc;
    }
    part[warp][lane] = c;
    __syncthreads();
    if (warp == 0 && b < B) {
      long long s = 0;
#pragma unroll
      for (int w = 0; w < MATCH_ROWS; ++w) s += part[w][lane];
      if (s != 0) atomicAdd(acc + b, (unsigned long long)s);
    }
    __syncthreads();  // part is written again by the next chunk
  }
  // the last block to finish converts every sum, once
  __threadfence();
  if (threadIdx.x == 0) last = atomicAdd(acc + B, 1ull) == gridDim.x - 1;
  __syncthreads();
  if (last) {
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
      score[b] = (float)(long long)*(volatile unsigned long long*)(acc + b);
    }
  }
}

// Grid (B, L): block (b, l) compacts query b's row of shard l.  Its warps
// take contiguous spans of the row, a multiple of 32 rows each: each warp
// counts its span's hits (a ballot and a popcount per 32 rows, no barrier),
// one barrier shares the warps' counts, then each warp writes its span's
// hits in row order from its offset, stopping at H.  nh, e0 [L, B, mb],
// gids [L, mb], out [L, B, 3H + 1].
__global__ void __launch_bounds__(COMPACT_THREADS)
    compact_rows(const int32_t* __restrict__ nh, const int32_t* __restrict__ e0,
                 const int32_t* __restrict__ gids, int32_t* __restrict__ out, int B, int mb,
                 int H) {
  __shared__ int totals[COMPACT_WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = (int64_t)blockIdx.y * B + blockIdx.x;
  const int32_t* nh_b = nh + row * mb;
  const int32_t* e0_b = e0 + row * mb;
  const int32_t* g = gids + (int64_t)blockIdx.y * mb;
  int32_t* o = out + row * (3 * (int64_t)H + 1);
  const int span = (mb + COMPACT_THREADS - 1) / COMPACT_THREADS * 32;
  const int r0 = warp * span;
  const int r1 = min(r0 + span, mb);
  int mine = 0;  // this warp's hits, the same in every lane
#pragma unroll 4
  for (int r = r0 + lane; r < r0 + span; r += 32)
    mine += __popc(__ballot_sync(FULL, r < r1 && nh_b[r] > 0));
  if (lane == 0) totals[warp] = mine;
  __syncthreads();
  int at = 0, n = 0;  // hits before this warp's span, and in the row
#pragma unroll
  for (int w = 0; w < COMPACT_WARPS; ++w) {
    at += w < warp ? totals[w] : 0;
    n += totals[w];
  }
  for (int r = r0 + lane; r < r0 + span && at < H; r += 32) {
    const int v = r < r1 ? nh_b[r] : 0;
    const unsigned ballot = __ballot_sync(FULL, v > 0);
    const int pos = at + __popc(ballot & ((1u << lane) - 1u));
    if (v > 0 && pos < H) {
      o[pos] = g[r];
      o[H + pos] = e0_b[r];
      o[2 * H + pos] = v;
    }
    at += __popc(ballot);
  }
  for (int j = min(n, H) + threadIdx.x; j < H; j += COMPACT_THREADS) {
    o[j] = -1;
    o[H + j] = 0;
    o[2 * H + j] = 0;
  }
  if (threadIdx.x == 0) o[3 * H] = n;
}

}  // namespace

extern "C" {

// B11 over L shards in one launch, on `stream`; returns the first CUDA
// error of the calls, else 0.  acc is int64 scratch of B + 1 words.
int seed_match_shard(const void* seeds, const void* queries, void* n_hits, void* lcp, void* acc,
                     void* score, int L, int B, int M, int E, unsigned int suf, int k,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t rows = (int64_t)L * M;
  if (B == 0) return (int)cudaSuccess;
  if (rows == 0) return (int)cudaMemsetAsync(score, 0, (size_t)B * sizeof(float), s);
  cudaError_t err = cudaMemsetAsync(acc, 0, (size_t)(B + 1) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  match_shard<<<(unsigned)((rows + MATCH_ROWS - 1) / MATCH_ROWS), MATCH_ROWS * 32, 0, s>>>(
      (const uint32_t*)seeds, (const uint32_t*)queries, (int32_t*)n_hits, (int32_t*)lcp,
      (unsigned long long*)acc, (float*)score, rows, B, M, E, (uint32_t)suf, k);
  return (int)cudaGetLastError();
}

// B12's compaction of L shards in one launch, on `stream`.
int shard_compact(const void* nh, const void* e0, const void* gids, void* out, int L, int B,
                  int mb, int H, void* stream) {
  if (L == 0 || B == 0) return (int)cudaSuccess;
  compact_rows<<<dim3((unsigned)B, (unsigned)L), COMPACT_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)nh, (const int32_t*)e0, (const int32_t*)gids, (int32_t*)out, B, mb, H);
  return (int)cudaGetLastError();
}

const char* sharded_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
