// LexicHash capture of one genome for NVIDIA Hopper (sm_90a): kernels
// capture_min, capture_count, capture_scatter and capture_finish.
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
//   - capture_min: a thread per position builds both k-mers from a tile of
//     the genome in shared memory, finds each one's mask through the bucket
//     table (dense int32 [4^p] of mask indices, -1 for none, or the masks'
//     sorted bucket ids [m] for a bisection when 4^p is large) and lowers
//     the mask's minimum of kmer ^ mask with an unsigned 64-bit atomicMin,
//     skipped when a plain read already shows a value no larger (the
//     minimum only falls, so a stale read only costs an extra atomic).
//   - capture_count: the same k-mers again; a location whose kmer ^ mask
//     equals its mask's minimum adds one to the mask's count.
//   - (the wrapper: an exclusive prefix sum of the counts, and the total.)
//   - capture_scatter: the same test writes each winning location into its
//     mask's slice at an atomic cursor (in no fixed order).
//   - capture_finish: a block per mask writes its k-mer (0 = no capture)
//     and count, and sorts its slice: one thread up to 16 locations, a
//     bitonic sort in shared memory up to SORT_CAP, and above that
//     SORT_CAP-long runs sorted in shared memory then merged pairwise
//     through a scratch slice (merge path), so a mask with millions of
//     winners (a tandem repeat) sorts in O(n log n) and exactly.  The sort
//     alone fixes the order, so the output is the same on every run.
//
// What bounds it: the bytes the function must move are the genome, its
// exclusion bytes, the table and masks, and the outputs: ~21 MB at 20 Mb
// without exclusions, ~6 us of HBM.  The design is bound by instructions:
// each of the three genome passes rebuilds both k-mers from k bytes of the
// tile (~190 integer operations a position) rather than storing them (16
// bytes a position and strand, 640 MB at 20 Mb, read back twice); on an
// H100 SXM a pass takes ~0.4 ms at 20 Mb (chip_smoke.py's capture phase).
// A thread rolling its k-mers over a run of positions would cut that work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;   // positions per block of the genome passes
constexpr int KMAX = 32;
constexpr int SORT_THREADS = 256;
constexpr int SORT_CAP = 8192;  // locations a block sorts in shared memory at once
constexpr int SMALL = 16;       // locations one thread sorts by insertion

struct Masks {
  const int32_t* table;  // dense [4^p] mask index or -1; else sorted bucket ids [m]
  int dense;
  int m;
  int shift;  // 2 * (k - p): a k-mer's bucket is kmer >> shift
  const unsigned long long* masks;
};

__device__ __forceinline__ int mask_of(unsigned long long kmer, const Masks& ms) {
  const uint32_t b = (uint32_t)(kmer >> ms.shift);
  if (ms.dense) return ms.table[b];
  int lo = 0, hi = ms.m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((uint32_t)ms.table[mid] < b) lo = mid + 1;
    else hi = mid;
  }
  return (lo < ms.m && (uint32_t)ms.table[lo] == b) ? lo : -1;
}

// The block's genome tile: codes[base .. base + THREADS + k - 1), zeros past
// L (no k-mer of a valid position reads them).
__device__ __forceinline__ void load_tile(uint8_t* tile, const uint8_t* codes, int64_t L,
                                          int64_t base, int k) {
  for (int t = threadIdx.x; t < THREADS + k - 1; t += THREADS) {
    const int64_t g = base + t;
    tile[t] = g < L ? codes[g] : 0;
  }
  __syncthreads();
}

// Forward k-mer (MSB-first) and the reverse complement of the same bases.
__device__ __forceinline__ void kmers_at(const uint8_t* s, int k, unsigned long long& f,
                                         unsigned long long& r) {
  f = 0;
  r = 0;
  for (int j = 0; j < k; ++j) {
    const unsigned long long c = s[j];
    f = (f << 2) | c;
    r |= (3ull - c) << (2 * j);
  }
}

// The position this thread takes, or -1 (past the last k-mer, or excluded).
__device__ __forceinline__ int64_t position(int64_t base, int64_t nk, const uint8_t* excl) {
  const int64_t i = base + threadIdx.x;
  if (i >= nk || (excl != nullptr && excl[i])) return -1;
  return i;
}

__global__ void __launch_bounds__(THREADS)
capture_min(const uint8_t* __restrict__ codes, int64_t L, const uint8_t* __restrict__ excl,
            int k, Masks ms, unsigned long long* best) {
  __shared__ uint8_t tile[THREADS + KMAX];
  const int64_t base = (int64_t)blockIdx.x * THREADS;
  load_tile(tile, codes, L, base, k);
  const int64_t i = position(base, L - k + 1, excl);
  if (i < 0) return;
  unsigned long long km[2];
  kmers_at(tile + threadIdx.x, k, km[0], km[1]);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int j = mask_of(km[s], ms);
    if (j < 0) continue;
    const unsigned long long x = km[s] ^ ms.masks[j];
    if (x < best[j]) atomicMin(best + j, x);
  }
}

__global__ void __launch_bounds__(THREADS)
capture_count(const uint8_t* __restrict__ codes, int64_t L, const uint8_t* __restrict__ excl,
              int k, Masks ms, const unsigned long long* __restrict__ best,
              unsigned long long* counts) {
  __shared__ uint8_t tile[THREADS + KMAX];
  const int64_t base = (int64_t)blockIdx.x * THREADS;
  load_tile(tile, codes, L, base, k);
  const int64_t i = position(base, L - k + 1, excl);
  if (i < 0) return;
  unsigned long long km[2];
  kmers_at(tile + threadIdx.x, k, km[0], km[1]);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int j = mask_of(km[s], ms);
    if (j >= 0 && (km[s] ^ ms.masks[j]) == best[j]) atomicAdd(counts + j, 1ull);
  }
}

__global__ void __launch_bounds__(THREADS)
capture_scatter(const uint8_t* __restrict__ codes, int64_t L, const uint8_t* __restrict__ excl,
                int k, Masks ms, const unsigned long long* __restrict__ best,
                const int64_t* __restrict__ off, unsigned int* cursor, uint32_t* pos) {
  __shared__ uint8_t tile[THREADS + KMAX];
  const int64_t base = (int64_t)blockIdx.x * THREADS;
  load_tile(tile, codes, L, base, k);
  const int64_t i = position(base, L - k + 1, excl);
  if (i < 0) return;
  unsigned long long km[2];
  kmers_at(tile + threadIdx.x, k, km[0], km[1]);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int j = mask_of(km[s], ms);
    if (j >= 0 && (km[s] ^ ms.masks[j]) == best[j]) {
      const unsigned int slot = atomicAdd(cursor + j, 1u);
      pos[off[j] + slot] = (uint32_t)(i << 1 | s);
    }
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

// How many of A's elements the first d of merge(A, B) take.
__device__ __forceinline__ int64_t merge_split(const uint32_t* A, int64_t na, const uint32_t* B,
                                               int64_t nb, int64_t d) {
  int64_t lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  while (lo < hi) {
    const int64_t i = (lo + hi) >> 1;
    if (A[i] <= B[d - i - 1]) lo = i + 1;
    else hi = i;
  }
  return lo;
}

// merge(A, B) -> out by the block, each thread a contiguous run of outputs.
__device__ void block_merge(const uint32_t* A, int64_t na, const uint32_t* B, int64_t nb,
                            uint32_t* out) {
  const int64_t n = na + nb;
  const int64_t per = (n + blockDim.x - 1) / blockDim.x;
  const int64_t d0 = per * threadIdx.x;
  if (d0 >= n) return;
  const int64_t d1 = d0 + per < n ? d0 + per : n;
  int64_t i = merge_split(A, na, B, nb, d0), j = d0 - i;
  for (int64_t d = d0; d < d1; ++d) {
    if (j >= nb || (i < na && A[i] <= B[j])) out[d] = A[i++];
    else out[d] = B[j++];
  }
}

__global__ void __launch_bounds__(SORT_THREADS)
capture_finish(const unsigned long long* __restrict__ best,
               const unsigned long long* __restrict__ masks,
               const unsigned long long* __restrict__ counts, const int64_t* __restrict__ off,
               unsigned long long* kmers_out, int64_t* counts_out, uint32_t* pos,
               uint32_t* scratch) {
  __shared__ uint32_t s[SORT_CAP];
  const int j = blockIdx.x;
  const int64_t n = (int64_t)counts[j];
  if (threadIdx.x == 0) {
    kmers_out[j] = n > 0 ? best[j] ^ masks[j] : 0ull;
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
  for (int64_t c = 0; c < n; c += SORT_CAP)
    block_sort(a + c, (int)(n - c < SORT_CAP ? n - c : SORT_CAP), s);
  if (n <= SORT_CAP) return;
  uint32_t* src = a;
  uint32_t* dst = scratch + off[j];
  for (int64_t w = SORT_CAP; w < n; w <<= 1) {
    for (int64_t lo = 0; lo < n; lo += 2 * w) {
      const int64_t na = n - lo < w ? n - lo : w;
      const int64_t rest = n - lo - na;
      block_merge(src + lo, na, src + lo + na, rest < w ? rest : w, dst + lo);
    }
    __syncthreads();
    uint32_t* t = src;
    src = dst;
    dst = t;
  }
  if (src != a) {
    for (int64_t t = threadIdx.x; t < n; t += blockDim.x) a[t] = src[t];
  }
}

Masks make_masks(const void* table, int dense, int m, int k, int p, const void* masks) {
  return Masks{(const int32_t*)table, dense, m, 2 * (k - p),
               (const unsigned long long*)masks};
}

}  // namespace

extern "C" {

// First half of a capture: best [m] u64 (the least kmer ^ mask, all ones for
// none) and counts [m] u64 (winning locations) of the genome codes [L] u8
// (0..3) with exclusion bytes excl [L - k + 1] (nonzero = excluded; may be
// null).  Both outputs are set here.  Launches on `stream` and returns
// cudaGetLastError() after the launches.
int capture_count_winners(const void* codes, int64_t L, const void* excl, int k, int p,
                          const void* table, int dense, int m, const void* masks, void* best,
                          void* counts, void* stream) {
  if (k < 1 || k > KMAX || p < 1 || p > k || 2 * p >= 32 || m < 1 || L < k)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(best, 0xFF, sizeof(unsigned long long) * m, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(counts, 0, sizeof(unsigned long long) * m, st);
  if (err != cudaSuccess) return (int)err;
  const Masks ms = make_masks(table, dense, m, k, p, masks);
  const int64_t nk = L - k + 1;
  const unsigned blocks = (unsigned)((nk + THREADS - 1) / THREADS);
  capture_min<<<blocks, THREADS, 0, st>>>((const uint8_t*)codes, L, (const uint8_t*)excl, k, ms,
                                          (unsigned long long*)best);
  capture_count<<<blocks, THREADS, 0, st>>>((const uint8_t*)codes, L, (const uint8_t*)excl, k,
                                            ms, (const unsigned long long*)best,
                                            (unsigned long long*)counts);
  return (int)cudaGetLastError();
}

// Second half: off [m] i64 (the counts' exclusive prefix sum), cursor [m]
// u32 (scratch, zeroed here), pos [total] u32 (each mask's locations
// ascending at off[j]), kmers_out [m] u64 (0 = no capture), counts_out [m]
// i64; scratch [total] u32 when some count exceeds SORT_CAP, else may be
// null.
int capture_write_winners(const void* codes, int64_t L, const void* excl, int k, int p,
                          const void* table, int dense, int m, const void* masks,
                          const void* best, const void* counts, const void* off, void* cursor,
                          void* pos, void* kmers_out, void* counts_out, void* scratch,
                          void* stream) {
  if (k < 1 || k > KMAX || p < 1 || p > k || 2 * p >= 32 || m < 1 || L < k)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(cursor, 0, sizeof(unsigned int) * m, st);
  if (err != cudaSuccess) return (int)err;
  const Masks ms = make_masks(table, dense, m, k, p, masks);
  const int64_t nk = L - k + 1;
  const unsigned blocks = (unsigned)((nk + THREADS - 1) / THREADS);
  capture_scatter<<<blocks, THREADS, 0, st>>>(
      (const uint8_t*)codes, L, (const uint8_t*)excl, k, ms, (const unsigned long long*)best,
      (const int64_t*)off, (unsigned int*)cursor, (uint32_t*)pos);
  capture_finish<<<m, SORT_THREADS, 0, st>>>(
      (const unsigned long long*)best, (const unsigned long long*)masks,
      (const unsigned long long*)counts, (const int64_t*)off, (unsigned long long*)kmers_out,
      (int64_t*)counts_out, (uint32_t*)pos, (uint32_t*)scratch);
  return (int)cudaGetLastError();
}

int capture_sort_cap() { return SORT_CAP; }

const char* capture_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
