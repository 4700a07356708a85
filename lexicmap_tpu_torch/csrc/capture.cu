// LexicHash capture of one genome for NVIDIA Hopper (sm_90a): kernels
// capture_init, capture_min, capture_count, capture_scatter and
// capture_finish.
//
// Replaces lexicmap_tpu/parallel/build_device.py::build_capture_fn (a jitted
// program over 4.19 Mb slabs: fwd/rc k-mers by shift-compose, a sort-join of
// the k-mers with the masks on the distinct-prefix bucket, a second sort by
// (bucket, kmer ^ mask), segmented fills, and a compaction to 65,536 lanes
// that sends a slab with more winners to the host).  It reproduces the port's
// native oracle native/core.cpp capture_native(check_shorter = 0) bit for
// bit: for every unexcluded position i < L - k + 1 and both strands (loc =
// i << 1 | strand), the k-mer whose first p bases (the mask set's distinct
// prefix) equal mask j's is a candidate of mask j; mask j keeps the least
// kmer ^ mask[j] and every location of that k-mer, ascending.
//
// One call covers the whole genome (no slabs, no cap): gather exists on
// this card, so the sort-joins go.
//   - capture_init: each mask's pair (mask, best = all ones) and count 0;
//     at p <= SMEM_MAX_P the bucket table narrowed to uint16.
//   - the three genome passes: each thread takes a run of consecutive
//     positions (8, 16 or RUN = 32: the shortest whose chunks fit one wave
//     of the card) of a block's chunk (NT runs, its tile of the genome
//     staged in shared memory as 16-byte vectors) and rolls both k-mers
//     one base at a time over it, the first k - 1 bases without tests:
//     f = f << 2 | c, R = R >> 2 | (3 - c) << 62, the forward k-mer in f's
//     low 2k bits and the reverse complement in R's top 2k bits, so that
//     both roll by constant shifts.  An excluded position rolls and skips
//     the test.  Each k-mer's mask comes from the bucket table, then the
//     mask's (mask, best) pair in one 16-byte load; four positions (eight
//     k-mers) issue their lookups together, then their pair loads.
//     The table: at the index default (p <= SMEM_MAX_P = 8, the uint16
//     table and the masks' keys fitting a block's shared memory) every
//     block stages the uint16 table [4^p] (0xFFFF: none; 128 KB at p = 8)
//     and, after capture_min, the masks' keys (the low 16 bits of each
//     mask's best k-mer), and a persistent grid of NT = 512 threads a block
//     strides over the chunks; else the int32 table is read from global
//     memory (dense [4^p], or the masks' sorted bucket ids [m] for a
//     bisection when 4^p is large), 256 threads a block, a block a chunk.
//   - capture_min: lowers the mask's best (kmer ^ mask) with an unsigned
//     64-bit atomicMin, skipped when the loaded best is no larger (the
//     minimum only falls, so a stale read only costs an extra atomic).
//   - capture_keys (staged table only): each mask's key.
//   - capture_count: a location whose kmer ^ mask equals its mask's best
//     adds one to the mask's count; with the staged table a k-mer whose low
//     16 bits differ from its mask's key cannot win, and loads no pair.
//   - (the wrapper: an exclusive prefix sum of the counts, and the total.)
//   - capture_scatter: the same test writes each winning location into its
//     mask's slice at an atomic cursor (in no fixed order).
//   In the three passes a strand's consecutive candidates (winners) of one
//   mask within a run are held in registers and flushed as one atomic: a
//   homopolymer's mask wins at every position of a run, so it takes one
//   atomic a run, not 32.
//   - capture_finish: a block per mask writes its k-mer (0 = no capture)
//     and count, and sorts its slice: one thread up to 16 locations, a
//     bitonic sort in shared memory up to SORT_CAP, and above that an LSD
//     radix sort on 4-bit digits through a scratch slice, so a mask with
//     millions of winners (a tandem repeat) sorts in a few passes over its
//     slice and exactly.  The sort alone fixes the order, so the output is
//     the same on every run.
//
// What bounds it: the bytes the function must move are the genome, its
// exclusion bytes, the table and masks, and the outputs: ~21 MB at 20 Mb
// without exclusions, ~6 us of HBM.  The passes are far from it.  With the
// table read from global memory every lookup, and every pair load, moves
// a 32-byte sector from L2 for 4 or 16 bytes: at 20 Mb and 20,000 masks a
// pass makes 40 M lookups and 12 M pair loads (~1.7 GB of sectors), and
// on an H100 SXM a pass took ~0.38 ms with its k-mers rolled as with them
// rebuilt from k bytes at every position (chip_smoke.py's capture phase).
// The staged table leaves capture_min its pair loads (~0.14 ms there) and
// the keys leave count and scatter no load but the tile's (~0.10-0.11 ms
// each): what is left there is the integer work of the roll and the
// lookups.  capture_finish's big slices are bound by one SM's scattered
// accesses, a sector each.
//
// Offsets are int64; locations uint32 (L < 2^31).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int RUN = 32;       // most positions a thread rolls over (the bits of a uint32)
constexpr int NT_GLOBAL = 256;  // threads a block, the table in global memory
constexpr int NT_SMEM = 512;    // threads a block, the table staged in shared memory
constexpr int KMAX = 32;
constexpr int SMEM_MAX_P = 8;          // the uint16 table is staged up to 4^8 entries
constexpr uint16_t NONE16 = 0xFFFFu;   // no mask in the uint16 table
constexpr int SORT_THREADS = 256;
constexpr int SORT_CAP = 8192;  // locations a block sorts in shared memory at once
constexpr int SMALL = 16;       // locations one thread sorts by insertion

enum Pass { MIN, COUNT, SCATTER };

typedef ulonglong2 Pair;  // x: the mask; y: the least kmer ^ mask so far (all ones: none)

// 16-byte vectors of the tile of a chunk of n positions (its bytes, the
// next k - 1 and a word the last run reads past them), and the most
// shared-memory slots of a block of NT threads (a pad word after every 8).
__host__ __device__ constexpr int tile_vecs(int n) { return (n + KMAX - 1 + 4 + 15) / 16; }
template <int NT>
struct Tile {
  static constexpr int WORDS = 4 * tile_vecs(NT * RUN);
  static constexpr int SLOTS = (WORDS + WORDS / 8 + 3) / 4 * 4;  // what follows: 16-aligned
};

struct Masks {
  const int32_t* table;  // dense [4^p] mask index or -1; else sorted bucket ids [m]
  int dense;
  int m;
  int shift;  // 2 * (k - p): a k-mer's bucket is kmer >> shift
  int nb;     // 4^p
  const uint16_t* table16;  // [4^p] in global memory, staged (or null)
  const uint16_t* keys;     // [m] in global memory, staged by count and scatter (or null)
};

struct Genome {
  const uint8_t* codes;  // [L], 0..3
  int64_t L;
  const uint8_t* excl;  // [L - k + 1], nonzero = excluded; or null
  int k;
  int run;  // positions a thread takes: 8, 16 or RUN (the plan's)
};

struct Out {
  Pair* pairs;                  // [m]
  unsigned long long* counts;   // [m]
  const int64_t* off;           // [m] (scatter)
  unsigned int* cursor;         // [m] (scatter)
  uint32_t* pos;                // [total] (scatter)
};

__device__ __forceinline__ int mask_of_global(unsigned long long kmer, const Masks& ms) {
  const uint32_t b = (uint32_t)(kmer >> ms.shift);
  if (ms.dense) return __ldg(ms.table + b);
  int lo = 0, hi = ms.m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((uint32_t)__ldg(ms.table + mid) < b) lo = mid + 1;
    else hi = mid;
  }
  return (lo < ms.m && (uint32_t)__ldg(ms.table + lo) == b) ? lo : -1;
}

// dst[0 .. n) = src[0 .. n) by the block's NT threads, as 16-byte vectors
// where both are aligned.
template <int NT>
__device__ __forceinline__ void stage(uint16_t* dst, const uint16_t* src, int n) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    done = n / 8 * 8;
    for (int v = threadIdx.x; v < n / 8; v += NT)
      reinterpret_cast<uint4*>(dst)[v] = __ldg(reinterpret_cast<const uint4*>(src) + v);
  }
  for (int i = done + threadIdx.x; i < n; i += NT) dst[i] = __ldg(src + i);
}

// Word w of the tile sits at slot w + w / 8.  Thread t's run of 32 starts at
// word 8t, so at slot 9t + ...: the 32 threads of a warp read 32 banks
// (runs of 8 and 16 meet two to a bank at most).
__device__ __forceinline__ int slot(int w) { return w + (w >> 3); }

// The block's tile: codes[base .. base + 16 vecs) as words, zeros past L
// (no k-mer of a valid position reads them).  Ends with a barrier.
template <int NT>
__device__ __forceinline__ void load_tile(uint32_t* tile, const uint8_t* codes, int64_t L,
                                          int64_t base, int vecs) {
  const uint8_t* src = codes + base;
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int v = threadIdx.x; v < vecs; v += NT) {
    const int64_t g = base + 16 * (int64_t)v;
    uint32_t w[4];
    if (vec && g + 16 <= L) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(src) + v);
      w[0] = x.x;
      w[1] = x.y;
      w[2] = x.z;
      w[3] = x.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int64_t at = g + 4 * q + b;
          if (at < L) word |= (uint32_t)codes[at] << (8 * b);
        }
        w[q] = word;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) tile[slot(4 * v + q)] = w[q];
  }
  __syncthreads();
}

// Bit j < run: position i0 + j (i0 < nk) is below nk and not excluded.
__device__ __forceinline__ uint32_t run_live(const uint8_t* excl, int64_t nk, int64_t i0,
                                             int run) {
  const int64_t n = nk - i0 < run ? nk - i0 : run;
  const uint32_t live = n == 32 ? 0xFFFFFFFFu : (1u << n) - 1u;
  if (excl == nullptr) return live;
  const uint8_t* e = excl + i0;
  uint32_t ex = 0;
  if (n % 16 == 0 && (reinterpret_cast<uintptr_t>(e) & 15) == 0) {
    for (int v = 0; v < n / 16; ++v) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(e) + v);
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          ex |= (uint32_t)(((w[q] >> (8 * b)) & 0xFFu) != 0) << (16 * v + 4 * q + b);
      }
    }
  } else {
    for (int j = 0; j < n; ++j) ex |= (uint32_t)(e[j] != 0) << j;
  }
  return live & ~ex;
}

// A run's held candidates (min) or winners (count, scatter) of one mask on
// one strand.
struct Held {
  int j;                  // the mask, -1 for none
  uint32_t bits;          // winners' positions in the run
  unsigned long long x;   // least kmer ^ mask
};

template <int PASS>
__device__ __forceinline__ void flush(Held& h, int s, int64_t i0, const Out& o) {
  if (h.j < 0) return;
  if (PASS == MIN) {
    atomicMin(&o.pairs[h.j].y, h.x);
  } else if (PASS == COUNT) {
    atomicAdd(o.counts + h.j, (unsigned long long)__popc(h.bits));
  } else {
    const unsigned int at = atomicAdd(o.cursor + h.j, (unsigned int)__popc(h.bits));
    uint32_t* dst = o.pos + o.off[h.j] + at;
    for (uint32_t b = h.bits; b != 0; b &= b - 1)
      *dst++ = (uint32_t)((i0 + __ffs(b) - 1) << 1 | s);
  }
  h.j = -1;
}

// The k-mer km of run position `at` on strand s, a candidate of mask j
// (-1: none) whose pair is pr.
template <int PASS>
__device__ __forceinline__ void take(Held& h, int s, int j, unsigned long long km, Pair pr,
                                     int at, int64_t i0, const Out& o) {
  if (j < 0) return;
  const unsigned long long x = km ^ pr.x;
  if (PASS == MIN) {
    if (x >= pr.y) return;
    if (j == h.j) {
      h.x = x < h.x ? x : h.x;
      return;
    }
    flush<PASS>(h, s, i0, o);
    h.j = j;
    h.x = x;
  } else {
    if (x != pr.y) return;
    if (j != h.j) {
      flush<PASS>(h, s, i0, o);
      h.j = j;
      h.bits = 0;
    }
    h.bits |= 1u << at;
  }
}

// One thread's run of positions i0 .. i0 + g.run of the block's tile (its
// words from w0); with SMEM, t16 and keys are the staged table and keys
// (keys null in capture_min).
template <int PASS, bool SMEM>
__device__ __forceinline__ void run_pass(const uint32_t* tile, int w0, int64_t i0, uint32_t live,
                                         const Genome& g, const Masks& ms, const uint16_t* t16,
                                         const uint16_t* keys, const Out& o) {
  // f holds the forward k-mer in its low 2k bits (older bases above, cut
  // when it is used); R the reverse complement in its top 2k bits (older
  // bases below): r = R >> (64 - 2k).  Both roll with constant shifts, and a
  // bucket or a key is one shift of one of them.
  const int lead = g.k - 1;  // bases rolled in before the run's first k-mer is whole
  const unsigned long long kmask = g.k == 32 ? ~0ull : (1ull << (2 * g.k)) - 1ull;
  const int rlow = 64 - 2 * g.k;  // R's bits below the k-mer
  const int rtop = 64 - 2 * (g.k - ms.shift / 2);  // 64 - 2p: R's bits below the bucket
  const uint32_t pmask = (1u << (2 * g.k - ms.shift)) - 1u;
  unsigned long long f = 0, R = 0;
  // the first k - 1 bases: rolled only
  for (int q = 0; 4 * q < lead; ++q) {
    const uint32_t w = tile[slot(w0 + q)];
    for (int b = 0; b < 4 && 4 * q + b < lead; ++b) {
      const uint32_t c = (w >> (8 * b)) & 0xFFu;
      f = (f << 2) | c;
      R = (R >> 2) | ((unsigned long long)(3u - c) << 62);
    }
  }
  // then the run's positions, four a step: bytes lead + a0 .. + 3 of the
  // run, funnel-shifted out of two tile words
  Held h[2] = {{-1, 0u, 0ull}, {-1, 0u, 0ull}};
  const int sh = 8 * (lead & 3);
  int wq = w0 + (lead >> 2);
  uint32_t lo = tile[slot(wq)];
  for (int a0 = 0; a0 < g.run; a0 += 4) {
    const uint32_t hi = tile[slot(++wq)];
    const uint32_t w = __funnelshift_r(lo, hi, sh);
    lo = hi;
    unsigned long long km[8];
    int jm[8];
    bool any = false;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t c = (w >> (8 * b)) & 0xFFu;
      f = (f << 2) | c;
      R = (R >> 2) | ((unsigned long long)(3u - c) << 62);
      km[2 * b] = f & kmask;
      km[2 * b + 1] = R >> rlow;
      const bool on = (live >> (a0 + b)) & 1u;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        int j = -1;
        if (on) {
          if (SMEM) {
            const uint32_t bucket =
                s == 0 ? (uint32_t)(f >> ms.shift) & pmask : (uint32_t)(R >> rtop);
            const uint16_t v = t16[bucket];
            j = v == NONE16 ? -1 : (int)v;
            // a k-mer whose low bits are not its mask's best k-mer's cannot win
            if (PASS != MIN && j >= 0 && keys[j] != (uint16_t)km[2 * b + s]) j = -1;
          } else {
            j = mask_of_global(km[2 * b + s], ms);
          }
        }
        jm[2 * b + s] = j;
        any |= j >= 0;
      }
    }
    if (!any) continue;
    Pair pr[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      // capture_min's atomics change the pairs: a plain load there
      pr[u] = jm[u] < 0 ? make_ulonglong2(0ull, 0ull)
                        : PASS == MIN ? o.pairs[jm[u]] : __ldg(o.pairs + jm[u]);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      take<PASS>(h[u & 1], u & 1, jm[u], km[u], pr[u], a0 + (u >> 1), i0, o);
  }
  flush<PASS>(h[0], 0, i0, o);
  flush<PASS>(h[1], 1, i0, o);
}

// A genome pass: the table in global memory, a block a chunk (SMEM false);
// or staged in shared memory, the blocks striding over the chunks.
// Dynamic shared memory: the tile, then (staged) the table and the keys.
template <int PASS, bool SMEM>
__device__ __forceinline__ void genome_pass(const Genome& g, const Masks& ms, const Out& o) {
  constexpr int NT = SMEM ? NT_SMEM : NT_GLOBAL;
  extern __shared__ uint32_t dyn[];
  uint32_t* tile = dyn;
  uint16_t* t16 = nullptr;
  uint16_t* keys = nullptr;
  if (SMEM) {
    t16 = reinterpret_cast<uint16_t*>(dyn + Tile<NT>::SLOTS);
    stage<NT>(t16, ms.table16, ms.nb);
    if (PASS != MIN) {
      keys = t16 + ms.nb;
      stage<NT>(keys, ms.keys, ms.m);
    }
    // load_tile's barrier makes them visible
  }
  const int64_t nk = g.L - g.k + 1;
  const int64_t chunk = (int64_t)NT * g.run;
  const int64_t chunks = (nk + chunk - 1) / chunk;
  for (int64_t c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int64_t base = c * chunk;
    load_tile<NT>(tile, g.codes, g.L, base, tile_vecs((int)chunk));
    const int64_t i0 = base + (int64_t)threadIdx.x * g.run;
    const uint32_t live = i0 < nk ? run_live(g.excl, nk, i0, g.run) : 0u;
    if (live != 0)
      run_pass<PASS, SMEM>(tile, threadIdx.x * (g.run / 4), i0, live, g, ms, t16, keys, o);
    if (!SMEM) break;
    __syncthreads();  // the tile is loaded again
  }
}

template <bool SMEM>
__global__ void __launch_bounds__(SMEM ? NT_SMEM : NT_GLOBAL)
    capture_min(const Genome g, const Masks ms, const Out o) {
  genome_pass<MIN, SMEM>(g, ms, o);
}

template <bool SMEM>
__global__ void __launch_bounds__(SMEM ? NT_SMEM : NT_GLOBAL)
    capture_count(const Genome g, const Masks ms, const Out o) {
  genome_pass<COUNT, SMEM>(g, ms, o);
}

template <bool SMEM>
__global__ void __launch_bounds__(SMEM ? NT_SMEM : NT_GLOBAL)
    capture_scatter(const Genome g, const Masks ms, const Out o) {
  genome_pass<SCATTER, SMEM>(g, ms, o);
}

// The pairs and counts; with t16, the table narrowed to uint16 (nb > 0).
__global__ void capture_init(const unsigned long long* __restrict__ masks, Pair* pairs,
                             unsigned long long* counts, int m, const int32_t* __restrict__ table,
                             uint16_t* t16, int nb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < m) {
    pairs[i] = make_ulonglong2(masks[i], ~0ull);
    counts[i] = 0;
  }
  if (i < nb) t16[i] = table[i] < 0 ? NONE16 : (uint16_t)table[i];
}

// Each mask's key: the low 16 bits of its best k-mer.
__global__ void capture_keys(const Pair* __restrict__ pairs, uint16_t* keys, int m) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < m) {
    const Pair pr = pairs[j];
    keys[j] = (uint16_t)(pr.y ^ pr.x);
  }
}

// Sorts a[0..n), n <= SORT_CAP, through shared memory (bitonic, padded to a
// power of two with 0xFFFFFFFF, which no location reaches).
__device__ void block_sort(uint32_t* a, int n, uint32_t* s) {
  int P = 1;
  while (P < n) P <<= 1;
  for (int t = threadIdx.x; t < P; t += blockDim.x) s[t] = t < n ? a[t] : 0xFFFFFFFFu;
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < P / 2; t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const uint32_t x = s[lo], y = s[hi];
        if ((x > y) == ((lo & size) == 0)) {
          s[lo] = y;
          s[hi] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < n; t += blockDim.x) a[t] = s[t];
  __syncthreads();
}

// Exclusive prefix sum of c[0 .. 16 SORT_THREADS) in place, by the block.
__device__ void block_scan16(uint32_t* c) {
  __shared__ uint32_t warp_sums[SORT_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* mine = c + 16 * threadIdx.x;
  uint32_t sum = 0;
  for (int d = 0; d < 16; ++d) sum += mine[d];
  uint32_t x = sum;  // the warp's inclusive scan of the threads' sums
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  uint32_t before = x - sum;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  for (int d = 0; d < 16; ++d) {
    const uint32_t v = mine[d];
    mine[d] = before;
    before += v;
  }
  __syncthreads();
}

// Sorts a[0..n) by the block: an LSD radix sort on 4-bit digits of the
// keys' low `bits` bits, ping-ponging with tmp[0..n) in global memory.
// Each thread takes a contiguous chunk, read BATCH words at a time (the
// loads in flight together); the counts in c (shared, 16 SORT_THREADS,
// digit-major) give every (digit, thread) its offset, so each pass is
// stable.
constexpr int BATCH = 8;

__device__ void block_radix(uint32_t* a, uint32_t* tmp, int64_t n, int bits, uint32_t* c) {
  const int64_t per = (n + SORT_THREADS - 1) / SORT_THREADS;
  const int64_t lo = per * threadIdx.x < n ? per * threadIdx.x : n;
  const int64_t hi = lo + per < n ? lo + per : n;
  uint32_t* src = a;
  uint32_t* dst = tmp;
  uint32_t* mine = c + threadIdx.x;
  for (int shift = 0; shift < bits; shift += 4) {
    for (int d = 0; d < 16; ++d) mine[d * SORT_THREADS] = 0;
    for (int64_t i = lo; i < hi; i += BATCH) {
      uint32_t v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) v[u] = i + u < hi ? src[i + u] : 0u;
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (i + u < hi) ++mine[((v[u] >> shift) & 15u) * SORT_THREADS];
    }
    __syncthreads();
    block_scan16(c);
    for (int64_t i = lo; i < hi; i += BATCH) {
      uint32_t v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) v[u] = i + u < hi ? src[i + u] : 0u;
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (i + u < hi) dst[mine[((v[u] >> shift) & 15u) * SORT_THREADS]++] = v[u];
    }
    __syncthreads();
    uint32_t* t = src;
    src = dst;
    dst = t;
  }
  if (src != a) {
    for (int64_t t = threadIdx.x; t < n; t += SORT_THREADS) a[t] = src[t];
  }
}

__global__ void __launch_bounds__(SORT_THREADS)
capture_finish(const Pair* __restrict__ pairs, const unsigned long long* __restrict__ counts,
               const int64_t* __restrict__ off, unsigned long long* kmers_out,
               int64_t* counts_out, uint32_t* pos, uint32_t* scratch, int bits) {
  __shared__ uint32_t s[SORT_CAP];
  const int j = blockIdx.x;
  const int64_t n = (int64_t)counts[j];
  if (threadIdx.x == 0) {
    const Pair pr = pairs[j];
    kmers_out[j] = n > 0 ? pr.y ^ pr.x : 0ull;
    counts_out[j] = n;
  }
  if (n <= 1) return;
  uint32_t* a = pos + off[j];
  if (n <= SMALL) {
    if (threadIdx.x == 0) {
      for (int t = 1; t < n; ++t) {
        const uint32_t v = a[t];
        int u = t - 1;
        while (u >= 0 && a[u] > v) {
          a[u + 1] = a[u];
          --u;
        }
        a[u + 1] = v;
      }
    }
    return;
  }
  if (n <= SORT_CAP) block_sort(a, (int)n, s);
  else block_radix(a, scratch + off[j], n, bits, s);
}

bool bad_args(int k, int p, int m, int64_t L) {
  return k < 1 || k > KMAX || p < 1 || p > k || 2 * p >= 32 || m < 1 || L < k;
}

// The launch plan of a call: the table staged or not, a thread's run, the
// grid and the dynamic shared memory of the genome passes.
struct Plan {
  bool smem;
  int run;
  unsigned grid;
  size_t bytes;
};

// The shortest run (8, 16, 32) whose chunks of nt threads' runs fit the
// `fit` blocks the card holds at once, else RUN: a genome of the
// end-to-end build's size (~0.5 Mb) is one wave of chunks, none of them
// idle for a second wave, and a large genome takes the longest runs (the
// k - 1 bases rolled before a run's first k-mer cost least).
int run_for(int64_t nk, int nt, int64_t fit) {
  for (int run = 8; run < RUN; run *= 2)
    if ((nk + (int64_t)nt * run - 1) / ((int64_t)nt * run) <= fit) return run;
  return RUN;
}

template <bool SMEM>
cudaError_t allow_smem(size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(capture_min<SMEM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(capture_count<SMEM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(capture_scatter<SMEM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  return err;
}

cudaError_t plan(int64_t L, int k, int p, int m, int dense, Plan& pl) {
  const int64_t nk = L - k + 1;
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const size_t staged = sizeof(uint32_t) * Tile<NT_SMEM>::SLOTS +
                        sizeof(uint16_t) * (((size_t)1 << (2 * p)) + (size_t)m);
  pl.smem = dense && p <= SMEM_MAX_P && m < (int)NONE16 && staged <= (size_t)optin;
  const int nt = pl.smem ? NT_SMEM : NT_GLOBAL;
  pl.bytes = pl.smem ? staged : sizeof(uint32_t) * Tile<NT_GLOBAL>::SLOTS;
  err = pl.smem ? allow_smem<true>(pl.bytes) : allow_smem<false>(pl.bytes);
  if (err == cudaSuccess)
    err = pl.smem ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, capture_min<true>,
                                                                  NT_SMEM, pl.bytes)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, capture_min<false>,
                                                                  NT_GLOBAL, pl.bytes);
  if (err != cudaSuccess) return err;
  const int64_t fit = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  pl.run = run_for(nk, nt, fit);
  const int64_t chunks = (nk + (int64_t)nt * pl.run - 1) / ((int64_t)nt * pl.run);
  // staged: a persistent grid, each block staging the table once
  pl.grid = (unsigned)(pl.smem && chunks > fit ? fit : chunks);
  return cudaSuccess;
}

Masks make_masks(const void* table, int dense, int m, int k, int p, const void* best,
                 bool smem) {
  const uint16_t* t16 = smem ? reinterpret_cast<const uint16_t*>((const Pair*)best + m) : nullptr;
  const int nb = 1 << (2 * p);
  return Masks{(const int32_t*)table, dense, m, 2 * (k - p), nb, t16,
               smem ? t16 + nb : nullptr};
}

}  // namespace

extern "C" {

// Bytes of the `best` scratch a call needs: [m] 16-byte (mask, best) pairs,
// then, at p <= SMEM_MAX_P, the uint16 table [4^p] and keys [m]; a multiple
// of 16, so that what the caller puts after it stays aligned.
int64_t capture_best_bytes(int m, int p) {
  const int64_t n = (int64_t)sizeof(Pair) * m +
      (p <= SMEM_MAX_P ? (int64_t)sizeof(uint16_t) * (((int64_t)1 << (2 * p)) + m) : 0);
  return (n + 15) / 16 * 16;
}

// First half of a capture: best (capture_best_bytes; its pairs' best: the
// least kmer ^ mask, all ones for none) and counts [m] u64 (winning
// locations) of the genome codes [L] u8 (0..3) with exclusion bytes excl
// [L - k + 1] (nonzero = excluded; may be null), masks [m] u64.  Both
// outputs are set here.  Launches on `stream` and returns the first CUDA
// error of the calls.
int capture_count_winners(const void* codes, int64_t L, const void* excl, int k, int p,
                          const void* table, int dense, int m, const void* masks, void* best,
                          void* counts, void* stream) {
  if (bad_args(k, p, m, L)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Plan pl;
  cudaError_t err = plan(L, k, p, m, dense, pl);
  if (err != cudaSuccess) return (int)err;
  const Genome g{(const uint8_t*)codes, L, (const uint8_t*)excl, k, pl.run};
  const Masks ms = make_masks(table, dense, m, k, p, best, pl.smem);
  const Out o{(Pair*)best, (unsigned long long*)counts, nullptr, nullptr, nullptr};
  const int nb = pl.smem ? ms.nb : 0;
  const int init = m > nb ? m : nb;
  capture_init<<<(init + 255) / 256, 256, 0, st>>>((const unsigned long long*)masks, o.pairs,
                                                   o.counts, m, ms.table,
                                                   const_cast<uint16_t*>(ms.table16), nb);
  if (pl.smem) {
    capture_min<true><<<pl.grid, NT_SMEM, pl.bytes, st>>>(g, ms, o);
    capture_keys<<<(m + 255) / 256, 256, 0, st>>>(o.pairs, const_cast<uint16_t*>(ms.keys), m);
    capture_count<true><<<pl.grid, NT_SMEM, pl.bytes, st>>>(g, ms, o);
  } else {
    capture_min<false><<<pl.grid, NT_GLOBAL, pl.bytes, st>>>(g, ms, o);
    capture_count<false><<<pl.grid, NT_GLOBAL, pl.bytes, st>>>(g, ms, o);
  }
  return (int)cudaGetLastError();
}

// Second half: best and counts from the first, off [m] i64 (the counts'
// exclusive prefix sum), cursor [m] u32 (scratch, zeroed here), pos [total]
// u32 (each mask's locations ascending at off[j]), kmers_out [m] u64 (0 = no
// capture), counts_out [m] i64; scratch [total] u32 when some count
// exceeds SORT_CAP, else may be null.  masks is not read (best holds them).
int capture_write_winners(const void* codes, int64_t L, const void* excl, int k, int p,
                          const void* table, int dense, int m, const void* masks,
                          const void* best, const void* counts, const void* off, void* cursor,
                          void* pos, void* kmers_out, void* counts_out, void* scratch,
                          void* stream) {
  (void)masks;
  if (bad_args(k, p, m, L)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Plan pl;
  cudaError_t err = plan(L, k, p, m, dense, pl);
  if (err == cudaSuccess) err = cudaMemsetAsync(cursor, 0, sizeof(unsigned int) * m, st);
  if (err != cudaSuccess) return (int)err;
  const Genome g{(const uint8_t*)codes, L, (const uint8_t*)excl, k, pl.run};
  const Masks ms = make_masks(table, dense, m, k, p, best, pl.smem);
  const Out o{(Pair*)best, (unsigned long long*)counts, (const int64_t*)off,
              (unsigned int*)cursor, (uint32_t*)pos};
  if (pl.smem) capture_scatter<true><<<pl.grid, NT_SMEM, pl.bytes, st>>>(g, ms, o);
  else capture_scatter<false><<<pl.grid, NT_GLOBAL, pl.bytes, st>>>(g, ms, o);
  int bits = 4;  // the locations' bits (loc < 2 nk), a whole number of radix digits
  while (bits < 32 && ((2 * (L - k + 1) - 1) >> bits) != 0) bits += 4;
  capture_finish<<<m, SORT_THREADS, 0, st>>>(
      (const Pair*)best, (const unsigned long long*)counts, (const int64_t*)off,
      (unsigned long long*)kmers_out, (int64_t*)counts_out, (uint32_t*)pos, (uint32_t*)scratch,
      bits);
  return (int)cudaGetLastError();
}

int capture_sort_cap() { return SORT_CAP; }

const char* capture_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
