// Phase 2b's reversed-k-mer dispatch for NVIDIA Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package runs this step on the host
// (lexicmap_tpu/index/search.py::_reversed_query_kmers, a query at a time),
// and so did the port until this kernel.  It was added because that host
// step, run serially for each of a request's 32 queries, was the largest
// single part of a query's wall time while the card idled.  It computes, for
// every query b of a batch and every mask j whose captured k-mer x = K[b, j]
// is not 0, the reversed k-mer r = reverse(x) (its 2k bits, base order
// reversed) and the nearest mask of r (the index of the sorted mask that
// minimises mask XOR r, the lowest index among equal masks), and returns
// each query's distinct (nearest mask, r) pairs sorted by (nearest mask, r),
// each with the lowest j that gave it: the host's (new_mask, rev_kmer,
// orig_mask), bit for bit.
//
// Since r is a function of x and the nearest mask a function of r, the
// pairs are distinct exactly where the k-mers are: the kernel keeps each
// distinct k-mer once (with its lowest j) before anything else, so that the
// descent runs once a distinct k-mer (a 1 kb query: ~1,900 of the 20,000
// captures) and a query that piles many captures onto one k-mer costs no
// more than one that does not.
//
// Inputs.  kmers uint64 [B, m] (0 = no capture); tree: the sorted masks'
// crit-bit tree (kernels/reverse_dispatch.py::mask_tree), a uint64 word a
// node: the node's critical bit in bits 58-63, its right child in bits
// 29-57 and its left child in bits 0-28, a child either a node (< LEAF) or
// LEAF | the first index of a run of equal masks.  The descent from the
// root follows r's bit at each node's critical bit; where the masks below a
// node agree on a bit, XOR's argmin takes the one branch there is, so the
// tree's walk is the host's bit-by-bit descent with the bits on which the
// masks do not split left out.
//
// Out: records of 16 bytes (r, nearest mask int32, lowest j int32), query
// b's at [offsets[b], offsets[b + 1]) of one contiguous buffer, and
// declined[b] = 1 where the query's largest bucket (distinct reversed
// k-mers of one nearest mask) holds more than run_cap: such a query writes
// nothing and the host dispatches it.
//
// What bounds it on this card.  Bytes, if anything: it reads the batch's
// k-mers once (5.1 MB at B = 32, m = 20,000) and the tree (160 KB, L2 and
// L1 resident), and writes 16 bytes a distinct k-mer; some 2 us of HBM at
// the main path's shape.  What it waits on is latency: a descent is a chain
// of ~16 dependent loads of tree nodes, and the phases of a query meet at
// block barriers.  A block of 1,024 threads a query keeps 32 warps of
// loads in flight on its SM; the batch's 32 blocks run at once.
//
// Design: one launch after a memset of the scan's state, a block a query,
// every phase in shared memory but the per-query lists (global scratch, in
// L2):
//  1. each non-zero k-mer into a hash table of TABLE int32 slots in shared
//     memory (128 KB), keyed by the k-mer (compared through its j's k-mer),
//     holding the lowest j: a CAS claims an empty slot, an atomicMin keeps
//     the lowest j of a key, linear probing past other keys.  m <= MAX_M
//     (3/4 of TABLE) keeps probing short and ending;
//  2. the occupied slots compacted into the query's list of distinct j (a
//     warp a run of slots, ballots, the warps' counts scanned);
//  3. the table's memory reused for m + 1 bucket counters: each distinct
//     k-mer reversed, its nearest mask found by the tree's descent, and
//     counted in its bucket (a shared atomic);
//  4. the counters scanned in place to the buckets' ends, and the largest
//     bucket compared with run_cap (decline);
//  5. the query's count published and its offset taken by a decoupled
//     look-back over the queries that started before it (the block's
//     query is its place in a counter, so it waits on no block that has not
//     started: no deadlock on any grid);
//  6. each record scattered into its bucket (an atomic decrement of the
//     bucket's end, so the counters end at the buckets' starts);
//  7. each record's rank among its bucket's (distinct) reversed k-mers,
//     and the record written at the query's offset plus its bucket's start
//     plus its rank: (mask, r) order with no sort.

#include <cstdint>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int TABLE = 1 << 15;        // hash slots a query: 128 KB of shared memory
constexpr int MAX_M = TABLE / 4 * 3;  // kernels/reverse_dispatch.py::MAX_M
constexpr int32_t EMPTY = 0x7FFFFFFF;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint32_t LEAF = 1u << 28;
constexpr uint32_t CHILD = (1u << 29) - 1;
// a query's status word: the flag above bit 32, its count of records below
constexpr unsigned long long AGGREGATE = 1ull << 32, PREFIX = 2ull << 32;

struct Rec {
  unsigned long long rev;
  int32_t mask, orig;
};

struct Args {
  const unsigned long long* kmers;  // [B, m]
  const unsigned long long* tree;
  uint32_t root;
  int m, B, k, run_cap;
  int32_t* reps;  // [B, m] scratch: a query's distinct k-mers' lowest j
  int32_t* near;  // [B, m] scratch: their nearest masks
  Rec* staged;    // [B, m] scratch: the records in bucket order
};

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ int64_t warp_sum(int64_t x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(FULL, x, d);
  return x;
}

__device__ __forceinline__ int warp_inclusive(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// The base order of a packed k of 2k bits reversed (utils/kmers.py::reverse_kmers).
__device__ __forceinline__ unsigned long long reverse_kmer(unsigned long long x, int k) {
  x = __brevll(x);  // the bases in reverse order, each base's two bits swapped
  x = ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
  return x >> (64 - 2 * k);
}

__device__ __forceinline__ uint32_t slot_of(unsigned long long x) {
  return (uint32_t)((x * 0x9E3779B97F4A7C15ull) >> (64 - 15));
}

// The nearest mask of r: the tree's walk from its root to a leaf.
__device__ __forceinline__ int32_t nearest_mask(const unsigned long long* tree, uint32_t node,
                                                unsigned long long r) {
  while (!(node & LEAF)) {
    const unsigned long long w = __ldg(tree + node);
    node = (r >> (w >> 58)) & 1 ? (uint32_t)(w >> 29) & CHILD : (uint32_t)w & CHILD;
  }
  return (int32_t)(node & ~LEAF);
}

// The sum of the counts of queries [0, u), for warp 0 (as in seed_compact.cu).
__device__ int64_t look_back(const unsigned long long* status, int64_t u) {
  const int lane = threadIdx.x & 31;
  int64_t excl = 0;
  for (int64_t j = u - 1;; j -= 32) {
    const int64_t w = j - lane;
    unsigned long long s;
    do {
      s = w >= 0 ? load_status(status + w) : PREFIX;  // before query 0: a prefix of 0
    } while (!__all_sync(FULL, s >= AGGREGATE));
    const unsigned pre = __ballot_sync(FULL, s >= PREFIX);
    const int stop = pre ? __ffs(pre) - 1 : 31;
    excl += warp_sum(lane <= stop ? (int64_t)(s & 0xFFFFFFFFull) : 0);
    if (pre) return excl;
  }
}

// The exclusive scan of the warps' values over the block, from warp 0;
// every thread gets its warp's start and the total.
__device__ __forceinline__ int scan_warps(int mine, int* warp_at, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_at[warp] = mine;
  __syncthreads();
  if (warp == 0) {
    const int v = warp_at[lane];
    const int inc = warp_inclusive(v);
    warp_at[lane] = inc - v;
    if (lane == 31) warp_at[WARPS] = inc;
  }
  __syncthreads();
  total = warp_at[WARPS];
  return warp_at[warp];
}

__global__ void __launch_bounds__(THREADS, 1)
    reverse_dispatch_kernel(Args a, unsigned long long* status, unsigned long long* counter,
                            int64_t* __restrict__ offsets, int64_t* __restrict__ declined,
                            Rec* __restrict__ out) {
  extern __shared__ int32_t table[];  // TABLE slots; then m + 1 bucket counters
  __shared__ int warp_at[WARPS + 1];
  __shared__ int64_t query_at;
  __shared__ int the_query;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) the_query = (int)atomicAdd(counter, 1ull);
  for (int s = threadIdx.x; s < TABLE; s += THREADS) table[s] = EMPTY;
  __syncthreads();
  const int b = the_query;  // < B: the grid has a block a query
  const int m = a.m;
  const unsigned long long* K = a.kmers + (int64_t)b * m;
  int32_t* reps = a.reps + (int64_t)b * m;
  int32_t* near = a.near + (int64_t)b * m;
  Rec* staged = a.staged + (int64_t)b * m;

  // 1. the distinct non-zero k-mers, each with its lowest j
  for (int j = threadIdx.x; j < m; j += THREADS) {
    const unsigned long long x = __ldg(K + j);
    if (!x) continue;
    for (uint32_t h = slot_of(x);; h = (h + 1) & (TABLE - 1)) {
      const int32_t cur = atomicCAS(&table[h], EMPTY, j);
      if (cur == EMPTY) break;
      if (__ldg(K + cur) == x) {
        atomicMin(&table[h], j);
        break;
      }
    }
  }
  __syncthreads();

  // 2. the occupied slots compacted, a warp a run of TABLE / WARPS slots
  constexpr int RUN = TABLE / WARPS;
  const int s0 = warp * RUN;
  int n = 0;
  for (int s = s0 + lane; s < s0 + RUN; s += 32) n += __popc(__ballot_sync(FULL, table[s] != EMPTY));
  int D;
  int at = scan_warps(n, warp_at, D);
  for (int s = s0 + lane; s < s0 + RUN; s += 32) {
    const int32_t v = table[s];
    const unsigned occ = __ballot_sync(FULL, v != EMPTY);
    if (v != EMPTY) reps[at + __popc(occ & ((1u << lane) - 1u))] = v;
    at += __popc(occ);
  }
  __syncthreads();  // the table read: its memory becomes the bucket counters

  // 3. nearest masks, counted by bucket
  int32_t* bound = table;
  for (int i = threadIdx.x; i <= m; i += THREADS) bound[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < D; i += THREADS) {
    const int32_t nm = nearest_mask(a.tree, a.root, reverse_kmer(__ldg(K + reps[i]), a.k));
    near[i] = nm;
    atomicAdd(&bound[nm], 1);
  }
  __syncthreads();

  // 4. the counters to the buckets' ends, in place: a warp a segment, 32 at
  // a time with a carry, then the warps' sums; and the largest bucket
  const int seg = (m + WARPS - 1) / WARPS;
  const int g0 = min(warp * seg, m), g1 = min(g0 + seg, m);
  int carry = 0, largest = 0;
  for (int base = g0; base < g1; base += 32) {
    const int i = base + lane;
    const int v = i < g1 ? bound[i] : 0;
    largest = max(largest, v);
    const int inc = warp_inclusive(v) + carry;
    if (i < g1) bound[i] = inc;
    carry = __shfl_sync(FULL, inc, 31);
  }
  int ignored;
  const int add = scan_warps(carry, warp_at, ignored);
  for (int i = g0 + lane; i < g1; i += 32) bound[i] += add;
  if (threadIdx.x == 0) bound[m] = D;
  const bool over = __syncthreads_or(largest > a.run_cap);
  const int64_t count = over ? 0 : D;

  // 5. the query's offset: publish its count, look back, publish the prefix
  if (warp == 0) {
    int64_t excl = 0;
    if (b == 0) {
      if (lane == 0) store_status(status, PREFIX | (unsigned long long)count);
    } else {
      if (lane == 0) store_status(status + b, AGGREGATE | (unsigned long long)count);
      excl = look_back(status, b);
      if (lane == 0) store_status(status + b, PREFIX | (unsigned long long)(excl + count));
    }
    if (lane == 0) {
      query_at = excl;
      offsets[b] = excl;
      declined[b] = over;
      if (b == a.B - 1) offsets[a.B] = excl + count;
    }
  }
  if (over) return;  // the whole block: `over` is the block's

  // 6. the records into their buckets; the counters end at the starts
  for (int i = threadIdx.x; i < D; i += THREADS) {
    const int32_t nm = near[i], j = reps[i];
    const int pos = atomicSub(&bound[nm], 1) - 1;
    staged[pos] = Rec{reverse_kmer(__ldg(K + j), a.k), nm, j};
  }
  __syncthreads();

  // 7. each record at its bucket's start plus its rank in the bucket
  Rec* dst = out + query_at;
  for (int p = threadIdx.x; p < D; p += THREADS) {
    const Rec r = staged[p];
    const int q0 = bound[r.mask], q1 = bound[r.mask + 1];
    int rank = 0;
    for (int q = q0; q < q1; ++q) rank += staged[q].rev < r.rev;
    dst[q0 + rank] = r;
  }
}

}  // namespace

extern "C" {

// The whole dispatch on `stream`: a memset of the scan's state, then one
// launch of B blocks.  kmers uint64 [B, m]; tree uint64 (root: a node, or
// LEAF | 0 where every mask is equal); scratch int32 [2, B, m]; staged and
// out 16-byte records [B * m]; state int64 [3 * B + 2]: the queries'
// status words, the counter, offsets [B + 1], declined [B].  Takes B >= 1,
// 1 <= m <= MAX_M, 1 <= k <= 32, B * m < 2^31.
int reverse_dispatch(const void* kmers, const void* tree, unsigned root, int m, int B, int k,
                     int run_cap, void* scratch, void* staged, void* state, void* out,
                     void* stream) {
  if (B < 1 || m < 1 || m > MAX_M || k < 1 || k > 32 || (long long)B * m >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = TABLE * (int)sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(reverse_dispatch_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  unsigned long long* status = (unsigned long long*)state;
  err = cudaMemsetAsync(status, 0, (B + 1) * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  const Args a{(const unsigned long long*)kmers, (const unsigned long long*)tree, root, m, B, k,
               run_cap, (int32_t*)scratch, (int32_t*)scratch + (int64_t)B * m, (Rec*)staged};
  int64_t* st64 = (int64_t*)state;
  reverse_dispatch_kernel<<<B, THREADS, smem, st>>>(a, status, status + B, st64 + B + 1,
                                                    st64 + 2 * B + 2, (Rec*)out);
  return (int)cudaGetLastError();
}

const char* reverse_dispatch_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
