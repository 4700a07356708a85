// Batched and single-query >=p-prefix seed locate for NVIDIA Hopper (sm_90a).
//
// Replaces lexicmap_tpu/parallel/pallas_kernels.py::seed_locate_batch_pallas
// (B1, body _seed_locate_kernel) with `seed_locate_batch`, and
// ::seed_locate_pallas (B2, the same body for one query) with `seed_locate`,
// a kernel of its own.  For every query b and packed table row m:
//
//     suf = 2^(32-2p) - 1,  lb = qhi & ~suf,  rb = qhi | suf
//     e0[b,m]     = #{e < cnt[m] : hi[m,e] <  lb}
//     n_hits[b,m] = #{e < cnt[m] : lb <= hi[m,e] <= rb}
//
// both 0 where query_valid[b,m] is 0.  Validity is out of band: a poly-T
// query k-mer has qhi == 0xFFFFFFFF and still counts.  No entry at or past
// cnt[m] takes part in a comparison (whatever it holds, PAD_HI or not), so a
// saturated rb cannot count padding.  Rows are sorted ascending over
// [0, cnt), so e0 = lower_bound(lb) and e0 + n_hits = upper_bound(rb).
//
// What bounds it on this card.  A few integer compares per table word read,
// so memory: a search reads scattered 32-byte sectors, which the card
// serves far below its 3.35 TB/s streaming rate (B1 below reads its
// sectors at ~0.9 TB/s on an NVIDIA H100 80GB HBM3 at 700 W: chip_smoke.py
// prints its device time and its sectors).  B1's time goes with the number
// of distinct sectors it reads, the chain of dependent loads hidden behind
// the other warps; B2's 20,000 threads are too few to hide theirs, so its
// time goes with both.  So the design reads as few sectors as it can: lb's
// and rb's searches share every probe while their intervals are one (at p
// >= 11 until the last few steps), and the queries of one row share the
// probes of the top levels.  Two bisections run one after the other (rb's
// from lb's answer) read about twice as many.
//
// B1 (`seed_locate_batch`): a warp per row serves all B queries of the row,
// 32 at a time (any B >= 1).  Two regimes, split at E = SMALL_MAX_E:
//  - small rows: the row's [0, cnt) is staged in shared memory with
//    coalesced 16-byte loads, which stream at the full rate, then each lane
//    searches there.  The queries come in and the outputs go out through a
//    tile in shared memory, a sector per query and 8 rows instead of a word
//    per lane.  At E = 512-640 (the main path at a few hundred genomes) B =
//    32 searches touch most of the row anyway.
//  - large rows: the warp loads a sample of the row into shared memory,
//    row[j*s] for j < ceil(cnt/s), s = ceil(cnt/SAMPLE), all loads issued
//    at once (one round trip for the top levels), bisects lb and rb in the
//    sample, then bisects each bound's interval of at most s - 1 entries in
//    global memory, the two bounds' probes issued together.  A sample reads
//    a sector per pivot whether or not a query passes there, so SAMPLE
//    stays near the number of nodes B queries visit anyway.
// Measured with each choice built (NVIDIA H100 80GB HBM3, 700 W; 20,000
// rows x 10,240, B = 32, p = 15): SAMPLE = 32 read 102 MB of sectors in
// 0.112 ms, 64, 128 and 256 took 0.120, 0.139 and 0.170 ms, and staging
// those rows 0.396 ms; staging was faster at E = 1,024 (0.035 against 0.045
// ms), sampling at 2,048 and above (1,536: 0.052 and 0.054).
//
// B2 (`seed_locate`): one query per row, so nothing is shared across
// queries and the row's own chain of dependent loads sets the time.  A
// thread per row bisects the heads row[j*RUN], j < ceil(cnt/RUN), lb and rb
// sharing each probe as in B1; the top head (head H/2 of H = ceil(E/RUN),
// the sector a full row's bisection reads first anyway) is loaded with the
// query, its validity and the count, in the first round trip.  It then
// reads the RUN entries after the last head below each bound whole
// (16-byte loads, one run when both bounds share it) and counts in
// registers, so the last log2(RUN) levels cost one round trip.  Measured
// on the same card and table against the other shapes built beside it:
// 0.0049 ms (runs of 8: 0.0049, 32: 0.0052, none: 0.0051; no top head
// 0.0051, the top 2 levels 0.0053), the earlier thread-per-(b, m) kernel
// at B = 1 0.0109; a 4-ary search 0.0058, the top 3 and 4 levels 0.0072
// and 0.0153, and groups of 2 to 16 lanes per row 0.008-0.025, which read
// more sectors a row.
//
// Row offsets are int64 (Mb * E passes 2^31 at ~131,000 rows of 16,384).

#include "seed_search.cuh"

namespace {

using namespace seed_search;

constexpr int ROWS = 8;            // rows (a warp each) per block, at most
constexpr int SMALL_MAX_E = 1024;  // B1: rows of E <= this are staged whole
constexpr int SAMPLE = 32;         // B1: pivots in a larger row's sample
constexpr int RUN = 16;            // B2: entries a head stands for, read whole at the end

// The block's rows m0 .. m0 + R - 1 (R <= ROWS, a warp each) and 32 queries
// b0 .. b0 + 31 at a time: the query words and validity come in, and the
// outputs go out, through this tile in shared memory, so that a global
// access covers R consecutive rows of one query (a whole sector at R = 8)
// instead of one word a lane.  Padded against bank conflicts.
struct Tile {
  uint32_t qhi[32][ROWS + 1];
  uint32_t a[32][ROWS + 1];  // validity in, n_hits out
  uint32_t b[32][ROWS + 1];  // e0 out
};

__device__ __forceinline__ void tile_load(Tile& t, const uint32_t* __restrict__ query_hi,
                                          const uint8_t* __restrict__ query_valid, int b0, int B,
                                          int Mb, int m0, int R) {
  for (int i = threadIdx.x; i < 32 * R; i += blockDim.x) {
    const int b = i / R, r = i - b * R;
    const int64_t q = (int64_t)(b0 + b) * Mb + m0 + r;
    const bool in = b0 + b < B;
    t.qhi[b][r] = in ? query_hi[q] : 0u;
    t.a[b][r] = in ? query_valid[q] : 0u;
  }
}

__device__ __forceinline__ void tile_store(const Tile& t, int32_t* __restrict__ n_hits,
                                           int32_t* __restrict__ e0_out, int b0, int B, int Mb,
                                           int m0, int R) {
  for (int i = threadIdx.x; i < 32 * R; i += blockDim.x) {
    const int b = i / R, r = i - b * R;
    const int64_t q = (int64_t)(b0 + b) * Mb + m0 + r;
    if (b0 + b < B) {
      n_hits[q] = (int32_t)t.a[b][r];
      e0_out[q] = (int32_t)t.b[b][r];
    }
  }
}

constexpr int STAGE_UNROLL = 8;  // 16-byte loads in flight per lane while staging

// Small rows: [0, cnt) staged in shared memory, every search there.
__global__ void __launch_bounds__(ROWS * 32)
locate_batch_staged(const uint32_t* __restrict__ seed_hi, const int32_t* __restrict__ seed_cnt,
                    const uint32_t* __restrict__ query_hi,
                    const uint8_t* __restrict__ query_valid, int32_t* __restrict__ n_hits,
                    int32_t* __restrict__ e0_out, int B, int Mb, int E, uint32_t suf, int rows,
                    bool vec) {
  extern __shared__ uint4 staged[];
  __shared__ Tile tile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * rows, m = m0 + warp, R = min(rows, Mb - m0);
  const bool live = m < Mb;
  tile_load(tile, query_hi, query_valid, 0, B, Mb, m0, R);
  uint32_t* srow = reinterpret_cast<uint32_t*>(staged) + (int64_t)warp * E;
  const int cnt = live ? min(max(seed_cnt[m], 0), E) : 0;
  const uint32_t* row = seed_hi + (int64_t)m * E;
  if (vec) {  // E % 4 == 0 and a 16-byte-aligned table: rows and srow aligned
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    uint4* s4 = reinterpret_cast<uint4*>(srow);
    const int n4 = (cnt + 3) >> 2;
    for (int i0 = 0; i0 < n4; i0 += 32 * STAGE_UNROLL) {
      uint4 v[STAGE_UNROLL];
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int i = i0 + u * 32 + lane;
        if (i < n4) v[u] = __ldg(r4 + i);
      }
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int i = i0 + u * 32 + lane;
        if (i < n4) s4[i] = v[u];
      }
    }
  } else {
    for (int i = lane; i < cnt; i += 32) srow[i] = __ldg(row + i);
  }
  for (int b0 = 0; b0 < B; b0 += 32) {
    if (b0) {
      __syncthreads();  // the last chunk's outputs are out
      tile_load(tile, query_hi, query_valid, b0, B, Mb, m0, R);
    }
    __syncthreads();
    if (live) {  // warp-uniform
      const uint32_t qhi = tile.qhi[lane][warp];
      const bool ok = tile.a[lane][warp] != 0u;
      const int n = ok ? cnt : 0;
      int e0 = 0, end = 0;
      search_pair<false>(srow, qhi & ~suf, qhi | suf, e0, n, end, n);
      tile.a[lane][warp] = end - e0;
      tile.b[lane][warp] = e0;
    }
    __syncthreads();
    tile_store(tile, n_hits, e0_out, b0, B, Mb, m0, R);
  }
}

// Large rows: a sample of SAMPLE pivots, then the intervals, see the note.
// The queries are read straight from global memory: the warps' searches
// run unevenly, so they do not wait on each other at a tile's barrier.
__global__ void __launch_bounds__(ROWS * 32)
locate_batch_sampled(const uint32_t* __restrict__ seed_hi, const int32_t* __restrict__ seed_cnt,
                     const uint32_t* __restrict__ query_hi,
                     const uint8_t* __restrict__ query_valid, int32_t* __restrict__ n_hits,
                     int32_t* __restrict__ e0_out, int B, int Mb, int E, uint32_t suf) {
  __shared__ uint32_t pivots[ROWS][SAMPLE];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * ROWS + warp;
  if (m >= Mb) return;  // warp-uniform
  uint32_t* piv = pivots[warp];
  const int cnt = min(max(seed_cnt[m], 0), E);
  const uint32_t* row = seed_hi + (int64_t)m * E;
  const int s = cnt > SAMPLE ? (cnt + SAMPLE - 1) / SAMPLE : 1;  // stride of the sample
  const int P = (cnt + s - 1) / s;  // pivots row[j*s], all j*s < cnt
  {
    uint32_t v[SAMPLE / 32];  // every pivot load issued before the first store
#pragma unroll
    for (int u = 0; u < SAMPLE / 32; ++u) {
      const int j = u * 32 + lane;
      if (j < P) v[u] = __ldg(row + (int64_t)j * s);
    }
#pragma unroll
    for (int u = 0; u < SAMPLE / 32; ++u) {
      const int j = u * 32 + lane;
      if (j < P) piv[j] = v[u];
    }
  }
  __syncwarp();
  for (int b0 = 0; b0 < B; b0 += 32) {
    const int64_t q = (int64_t)(b0 + lane) * Mb + m;
    const bool in = b0 + lane < B;
    const uint32_t qhi = in ? query_hi[q] : 0u;
    const bool ok = in && query_valid[q];
    const uint32_t lb = qhi & ~suf, rb = qhi | suf;
    // c0 pivots are < lb, c1 are <= rb.  c0 == 0: e0 is 0.  Else e0 lies in
    // [(c0-1)*s + 1, min(c0*s, cnt)]; the same for end with c1.
    int c0 = 0, c1 = 0;
    search_pair<false>(piv, lb, rb, c0, ok ? P : 0, c1, ok ? P : 0);
    int e0 = c0 > 0 ? (c0 - 1) * s + 1 : 0, end = c1 > 0 ? (c1 - 1) * s + 1 : 0;
    search_pair<true>(row, lb, rb, e0, c0 > 0 ? min(c0 * s, cnt) : 0, end,
                      c1 > 0 ? min(c1 * s, cnt) : 0);
    if (in) {
      n_hits[q] = end - e0;
      e0_out[q] = e0;
    }
  }
}

constexpr int SINGLE_THREADS = 64;  // small blocks: 20,000 rows reach every SM

// B2: a thread per row, see the note.
__global__ void __launch_bounds__(SINGLE_THREADS)
locate_single(const uint32_t* __restrict__ seed_hi, const int32_t* __restrict__ seed_cnt,
              const uint32_t* __restrict__ query_hi, const uint8_t* __restrict__ query_valid,
              int32_t* __restrict__ n_hits, int32_t* __restrict__ e0_out, int Mb, int E,
              uint32_t suf, bool vec) {
  const int64_t m = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= Mb) return;
  const uint32_t* row = seed_hi + m * E;
  // the top head, validity, hi word and count in one round trip
  const int half = ((E + RUN - 1) / RUN) >> 1;
  const uint32_t top = E > 0 ? __ldg(row + (int64_t)half * RUN) : 0u;
  const bool ok = query_valid[m];
  const uint32_t qhi = query_hi[m];
  const int cnt = ok ? min(max(seed_cnt[m], 0), E) : 0;
  RowRuns<RUN> r;
  locate_runs(row, top, half, cnt, qhi & ~suf, qhi | suf, vec, r);
  n_hits[m] = r.end - r.e0;
  e0_out[m] = r.e0;
}

constexpr int DEFAULT_SMEM = 48 * 1024;  // a block's shared memory without opting in
constexpr int MAX_STAGED_BYTES = 227 * 1024 - (int)sizeof(Tile);

}  // namespace

extern "C" {

// B1.  Rows of E <= SMALL_MAX_E are staged whole (rows per block so that a
// block holds at most 48 KB, at least one row); larger rows use a sample of
// SAMPLE pivots.  Launches on `stream`; returns cudaGetLastError() after
// the launch.
int seed_locate_batch(const void* seed_hi, const void* seed_cnt, const void* query_hi,
                      const void* query_valid, void* n_hits, void* e0, int B, int Mb, int E,
                      unsigned int suf, void* stream) {
  if ((int64_t)B * Mb == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* hi = (const uint32_t*)seed_hi;
  const int32_t* cnt = (const int32_t*)seed_cnt;
  const uint32_t* qh = (const uint32_t*)query_hi;
  const uint8_t* qv = (const uint8_t*)query_valid;
  if (E <= SMALL_MAX_E && (int64_t)E * 4 <= MAX_STAGED_BYTES) {
    const int row_bytes = E * 4, budget = DEFAULT_SMEM - (int)sizeof(Tile);
    const int rows = row_bytes > 0 ? max(1, min(ROWS, budget / row_bytes)) : ROWS;
    const int smem = rows * row_bytes;
    if (smem > budget) {
      cudaError_t err = cudaFuncSetAttribute(
          locate_batch_staged, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
    }
    const bool vec = (E & 3) == 0 && ((uintptr_t)seed_hi & 15) == 0;
    locate_batch_staged<<<(Mb + rows - 1) / rows, rows * 32, smem, st>>>(
        hi, cnt, qh, qv, (int32_t*)n_hits, (int32_t*)e0, B, Mb, E, (uint32_t)suf, rows, vec);
  } else {
    locate_batch_sampled<<<(Mb + ROWS - 1) / ROWS, ROWS * 32, 0, st>>>(
        hi, cnt, qh, qv, (int32_t*)n_hits, (int32_t*)e0, B, Mb, E, (uint32_t)suf);
  }
  return (int)cudaGetLastError();
}

// B2, on `stream`; returns cudaGetLastError() after the launch.
int seed_locate(const void* seed_hi, const void* seed_cnt, const void* query_hi,
                const void* query_valid, void* n_hits, void* e0, int Mb, int E,
                unsigned int suf, void* stream) {
  if (Mb == 0) return (int)cudaSuccess;
  // a run inside its row and 16-byte aligned: E a multiple of RUN and an
  // aligned table
  const bool vec = E % RUN == 0 && ((uintptr_t)seed_hi & 15) == 0;
  locate_single<<<(unsigned)(((int64_t)Mb + SINGLE_THREADS - 1) / SINGLE_THREADS),
                  SINGLE_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)seed_hi, (const int32_t*)seed_cnt, (const uint32_t*)query_hi,
      (const uint8_t*)query_valid, (int32_t*)n_hits, (int32_t*)e0, Mb, E, (uint32_t)suf, vec);
  return (int)cudaGetLastError();
}

const char* seed_locate_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
