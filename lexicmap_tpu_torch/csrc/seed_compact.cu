// The seed matcher's compaction for NVIDIA Hopper (sm_90a).
//
// compact_lookback replaces the tail of
// lexicmap_tpu/parallel/device_search.py::DeviceSeedMatcher._bucket_fn (B4:
// after B1's pallas_call, each query's row outputs sorted by mask id and
// counted), together with the host sort and chunk merge that the matcher's
// batch needs after it, for every bucket of a batch in one launch.
//
// Inputs.  stk (int32): bucket k's B1 outputs [2, B, Mb_k] (n_hits, then
// e0) at element 2 * B * s0_k, s0_k its first global row.  The matcher's
// static row order: perm[i], the global row of ordered row i, all device
// rows sorted by (mask, chunk base); src[i] (int32 pairs), the (s0, Mb) of
// the bucket that holds it, so that query b's n_hits of ordered row i lies
// at 2 * B * s0 + b * Mb + (perm[i] - s0) and its e0 Mb * B past it;
// cont[i] = 1 where row i is the chunk of row i-1's mask that follows it
// (base[i] = base[i-1] + cnt[i-1]); gid[i] and base[i] (int64), the mask
// id and the chunk's first entry in its mask.  With, for query b, v(i) =
// n_hits and e(i) = e0 + base[i]:
//
//     merged(i) = cont[i] && v(i) > 0 && v(i-1) > 0 && e(i-1) + v(i-1) == e(i)
//     start(i)  = v(i) > 0 && !merged(i)
//
// each start gives one triple (gid[i], e(i), v(i) + v of the merged rows
// after it), query by query in row order, which is (mask, e0) order since a
// hit's e(i) lies in [base[i], base[i] + cnt[i]).  Out: int64 records [T,
// 3] of (mask, e0, n_hits) in a buffer of B * R records (each (query, row)
// starts at most one), and offsets int64 [B + 1], query b's records at
// [offsets[b], offsets[b+1]).  No truncation: every hit is kept.
//
// What bounds it on this card.  No arithmetic to speak of: the function
// reads one int32 n_hits per (query, row), e0, gid and base only where a
// row hits, and writes 24 bytes a triple, so bytes.  But at the matcher's
// shapes those are a few MB that B1 has just written into the 50 MB L2, so
// what a block waits on is its chain of dependent loads (the row order is
// read again for each query: some 8 MB from L2 at the 10k shape) and,
// between tiles, the scan.  The launch bounds ask for five blocks an SM (at
// most 51 registers a thread; ptxas gives 48, no spill), so the 10k
// shape's 640 tiles are resident at once: an earlier version took 54
// unbounded, four blocks fit and it ran slower there.  Loading e0 and base
// for every row beside n_hits (one dependent load fewer), or a start's mask
// id before the scan, was slower too.
//
// Design: one launch, a single pass with a decoupled look-back (Merrill and
// Garland's single-pass prefix scan) over tiles in (query, rows) order.  A
// tile is one query and TILE consecutive ordered rows, a block of WARPS
// warps of SPAN rows each: at the 10k shape (B = 32, 20,000 rows) 640
// blocks, all resident at once.
//  - A block takes its tile's number from a counter, so it waits only on
//    tiles that have started before it: no deadlock on any grid, with other
//    work on the card or not.
//  - Each warp loads its SPAN rows' perm, src and cont (coalesced, all
//    rounds at once), then their n_hits (one multiply-add from src, no walk
//    over the buckets), then e0 and base where a row hits: three dependent
//    loads for the whole span.  A row's test takes the row before from the
//    lane before (a shuffle; lane 0 from the previous round's lane 31, the
//    span's first from its own load), and a ballot counts the starts.
//  - The warps' counts meet in shared memory; warp 0 publishes the tile's
//    (flag AGGREGATE), looks back over its predecessors' status words a
//    window of 32 at a time (a lane a word) until it meets one with an
//    inclusive prefix (flag PREFIX), and publishes its own.  With every
//    tile resident at once, all look back together, and tile u meets a
//    published prefix after about u / 64 steps of an L2 round trip each:
//    tiles of 1,024 rows, not a warp's 128, keep that chain short.  (A
//    window of 64 or 128 words, two or four a lane, was slower.)
//  - A start's count sums its run: the rows after it that merge.  A ballot
//    of the merged rows tells each start whether the next row merges; only
//    such a start walks on over the rows after it (past the span's end if
//    need be) while they merge.  A run of one row, every run at the 10k
//    shape, walks nothing.
//  - Each warp puts its starts' records in shared memory in row order, then
//    copies them out from the tile's offset plus the warps before it, a
//    contiguous 256 bytes a store instruction where a lane's own three
//    8-byte stores would touch 24 sectors each.
//  - A query's first tile writes offsets[b]; the last tile offsets[B].
// The status words and the counter are zeroed by one cudaMemsetAsync on
// the launch's stream; the host waits only for the offsets.

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SPAN = 128;  // ordered rows a warp; kernels/seed_compact.py::SPAN
constexpr int ROUNDS = SPAN / 32;
constexpr int TILE = WARPS * SPAN;  // ordered rows a block: a unit of the scan
constexpr unsigned FULL = 0xFFFFFFFFu;
// a tile's status word: the flag above bit 32, the count of starts below
constexpr unsigned long long AGGREGATE = 1ull << 32, PREFIX = 2ull << 32;

struct Rows {
  const int32_t* stk;
  const int32_t* perm;
  const int2* src;
  const uint8_t* cont;
  const int64_t* gid;
  const int64_t* base;
  int64_t R;  // ordered rows
  int B;
  int U;  // tiles a query: ceil(R / TILE)
};

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Query b's n_hits of the ordered row whose perm and src are g and s.
__device__ __forceinline__ const int32_t* n_hits_at(const Rows& a, int b, int32_t g, int2 s) {
  return a.stk + 2 * (int64_t)a.B * s.x + (int64_t)b * s.y + (g - s.x);
}

// n_hits of query b at ordered row i; e its mask-global e0 where it hits.
__device__ __forceinline__ int load_row(const Rows& a, int b, int64_t i, int64_t& e) {
  const int2 s = __ldg(a.src + i);
  const int32_t* at = n_hits_at(a, b, __ldg(a.perm + i), s);
  const int v = __ldg(at);
  e = v > 0 ? (int64_t)__ldg(at + (int64_t)a.B * s.y) + __ldg(a.base + i) : 0;
  return v;
}

__device__ __forceinline__ int64_t warp_sum(int64_t x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(FULL, x, d);
  return x;
}

// The sum of the counts of tiles [0, u), for warp 0: their status words, 32
// at a time from the nearest (a lane a word), each window once all its
// words are published, up to and including the nearest with an inclusive
// prefix.
__device__ int64_t look_back(const unsigned long long* status, int64_t u) {
  const int lane = threadIdx.x & 31;
  int64_t excl = 0;
  for (int64_t j = u - 1;; j -= 32) {
    const int64_t w = j - lane;
    unsigned long long s;
    do {
      s = w >= 0 ? load_status(status + w) : PREFIX;  // before tile 0: a prefix of 0
    } while (!__all_sync(FULL, s >= AGGREGATE));
    const unsigned pre = __ballot_sync(FULL, s >= PREFIX);
    const int stop = pre ? __ffs(pre) - 1 : 31;
    excl += warp_sum(lane <= stop ? (int64_t)(s & 0xFFFFFFFFull) : 0);
    if (pre) return excl;
  }
}

// status [B * U] and the counter after it zeroed at the launch, a block a
// tile; out [B * R, 3].
__global__ void __launch_bounds__(THREADS, 5)
    compact_lookback(Rows a, unsigned long long* status, unsigned long long* counter,
                     int64_t* __restrict__ offsets, int64_t* __restrict__ out) {
  __shared__ int64_t tile, tile_at;
  __shared__ int warp_n[WARPS];
  __shared__ int64_t recs[WARPS][3 * SPAN];  // a warp's records, then copied out
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile = (int64_t)atomicAdd(counter, 1ull);
  __syncthreads();
  const int64_t u = tile;  // < B * U: the grid has a block a tile
  const int b = (int)(u / a.U);
  const int64_t t0 = (u - (int64_t)b * a.U) * TILE;
  const int64_t r0 = t0 + warp * SPAN;
  const int64_t r1 = min(r0 + SPAN, a.R);  // r0 >= r1: a warp past the last row

  // the span's rows, a round of 32 a lane each: address, then n_hits, then
  // e0 and base where it hits; and the row before the span
  int32_t g[ROUNDS];
  int2 s[ROUNDS];
  bool c[ROUNDS];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int64_t i = r0 + r * 32 + lane;
    g[r] = 0;
    s[r] = make_int2(0, 0);
    c[r] = false;
    if (i < r1) {
      g[r] = __ldg(a.perm + i);
      s[r] = __ldg(a.src + i);
      c[r] = __ldg(a.cont + i) != 0;
    }
  }
  int vp = 0;  // the row before this round's lane 0: n_hits and e0 + n_hits
  int64_t endp = 0;
  if (r0 > 0 && r0 < r1) {
    int64_t e;
    vp = load_row(a, b, r0 - 1, e);
    endp = e + vp;
  }
  int v[ROUNDS];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r)
    v[r] = r0 + r * 32 + lane < r1 ? __ldg(n_hits_at(a, b, g[r], s[r])) : 0;
  int64_t e[ROUNDS];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int64_t i = r0 + r * 32 + lane;
    e[r] = v[r] > 0 ? (int64_t)__ldg(n_hits_at(a, b, g[r], s[r]) + (int64_t)a.B * s[r].y) +
                          __ldg(a.base + i)
                    : 0;
  }

  // the starts, and the rows that merge into the row before
  unsigned ballot[ROUNDS], mrg[ROUNDS];
  int n = 0;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int64_t end = e[r] + v[r];
    int pv = __shfl_up_sync(FULL, v[r], 1);
    int64_t pend = __shfl_up_sync(FULL, end, 1);
    if (lane == 0) {
      pv = vp;
      pend = endp;
    }
    const bool merged = v[r] > 0 && c[r] && pv > 0 && pend == e[r];
    ballot[r] = __ballot_sync(FULL, v[r] > 0 && !merged);
    mrg[r] = __ballot_sync(FULL, merged);
    n += __popc(ballot[r]);
    vp = __shfl_sync(FULL, v[r], 31);
    endp = __shfl_sync(FULL, end, 31);
  }
  if (lane == 0) warp_n[warp] = n;
  __syncthreads();

  // the scan, by warp 0: publish the tile's count, look back, publish the
  // inclusive prefix
  if (warp == 0) {
    const int64_t total = warp_sum(lane < WARPS ? warp_n[lane] : 0);
    int64_t at = 0;
    if (u == 0) {
      if (lane == 0) store_status(status, PREFIX | (unsigned long long)total);
    } else {
      if (lane == 0) store_status(status + u, AGGREGATE | (unsigned long long)total);
      at = look_back(status, u);
      if (lane == 0) store_status(status + u, PREFIX | (unsigned long long)(at + total));
    }
    if (lane == 0) {
      tile_at = at;
      if (t0 == 0) offsets[b] = at;
      if (u == (int64_t)a.B * a.U - 1) offsets[a.B] = at + total;
    }
  }
  __syncthreads();

  // the starts' records in shared memory in row order, then copied out
  // from the warp's offset, coalesced.  A start whose next row merges into
  // it (its merge bit; after the span's last row, the walk's own test)
  // walks on over the rows after it while they merge
  int64_t* mine = recs[warp];
  int k = 0;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    if (ballot[r] >> lane & 1u) {
      const int64_t i = r0 + r * 32 + lane;
      const bool next = lane < 31         ? mrg[r] >> (lane + 1) & 1u
                        : r < ROUNDS - 1 ? mrg[min(r + 1, ROUNDS - 1)] & 1u
                                         : true;
      int64_t sum = v[r];
      if (next) {
        int64_t ep = e[r] + v[r];  // the end of the run's last row so far
        for (int64_t j = i + 1; j < a.R && __ldg(a.cont + j); ++j) {
          int64_t ej;
          const int vj = load_row(a, b, j, ej);
          if (vj <= 0 || ej != ep) break;
          sum += vj;
          ep = ej + vj;
        }
      }
      const int pos = k + __popc(ballot[r] & ((1u << lane) - 1u));
      mine[3 * pos] = __ldg(a.gid + i);
      mine[3 * pos + 1] = e[r];
      mine[3 * pos + 2] = sum;
    }
    k += __popc(ballot[r]);
  }
  __syncwarp();
  int64_t at = tile_at;
  for (int w = 0; w < warp; ++w) at += warp_n[w];
  int64_t* dst = out + 3 * at;
  for (int q = lane; q < 3 * n; q += 32) dst[q] = mine[q];
}

}  // namespace

extern "C" {

// The whole compaction on `stream`: a memset of the scan's state, then one
// launch.  scratch is int64 [B * U + 1 + B + 1], U = ceil(R / tile): the
// tiles' status words, the tile counter, then offsets [B + 1]; out int64
// [B * R, 3].  Takes R >= 1, B >= 1, B * R < 2^32 (a status word's count
// is 32 bits) and tile == TILE.
int seed_compact(const void* stk, const void* perm, const void* src, const void* cont,
                 const void* gid, const void* base, long long R, int B, int tile,
                 void* scratch, void* out, void* stream) {
  if (tile != TILE || R < 1 || B < 1 || (long long)B * R >= (1ll << 32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Rows a{(const int32_t*)stk, (const int32_t*)perm, (const int2*)src,
               (const uint8_t*)cont, (const int64_t*)gid, (const int64_t*)base,
               (int64_t)R, B, (int)((R + TILE - 1) / TILE)};
  const int64_t tiles = (int64_t)B * a.U;
  unsigned long long* status = (unsigned long long*)scratch;
  cudaError_t err = cudaMemsetAsync(status, 0, (tiles + 1) * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  compact_lookback<<<(unsigned)tiles, THREADS, 0, st>>>(
      a, status, status + tiles, (int64_t*)scratch + tiles + 1, (int64_t*)out);
  return (int)cudaGetLastError();
}

const char* seed_compact_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
