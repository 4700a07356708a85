// Phase-3 chain1 forward DP of a batch of genomes for NVIDIA Hopper
// (sm_90a): kernel chain1_kernel.
//
// Replaces lexicmap_tpu/parallel/chain_device.py::build_chain1_fn (a jitted
// lax.scan over a 512-anchor predecessor window, vmapped over genomes padded
// to buckets of 128-8192 anchors).  It reproduces the port's native oracle
// native/core.cpp chain1_forward bit for bit: per anchor i, the best
// predecessor j < i by score (base + w) - gap, ties to the largest j, the
// scan ending at the first j (descending) with qb[i] - qb[j] > max_dist.
//
// Layout: the genomes are one ragged (CSR) batch: qb, tb, ln int32 and the
// outputs ms f32, prev i32 (the index within the genome), dirs i8, all at
// off[g] .. off[g+1]; no padding.  flags int32 [G]: nonzero sends the
// genome to the host (a gap g <= max_gap past the gap-score table).
// order [G] lists the genomes longest first; its first n_block genomes
// (those of at least the wrapper's BLOCK_MIN anchors) take a block each,
// the others a warp each, four to a block.
//
// Step i is serial; the lanes take the predecessors j = i-1-lane,
// i-33-lane, ... in chunks of 32.  Each chunk ballots the break rule
// (qd > max_dist) and keeps only the lanes before the first breaking one,
// which is exactly where the native scan stops, for any order of qb: no
// predecessor window, so nothing is cut.
//   - The predecessors come from a ring in shared memory holding the last
//     RING anchors' qb, tb, ln, seed weight (computed once, when the anchor
//     is written), max score and direction: a step reads back what the
//     last one wrote from shared memory.  Older ones (a window wider than
//     the ring) are read from global memory, max scores and directions
//     from the outputs written there.
//   - The gap-score table sits in shared memory when it has at most
//     GTAB_SMEM entries (51 at the default max_gap of 50).
//   - The warp path takes two chunks an iteration: both chunks' loads and
//     break ballots come before either's compares, which are written
//     without branches so that they interleave.
//   - The step's maximum over (score, j) is two single-instruction warp
//     reductions (__reduce_max_sync) of the score's bits (scores that pass
//     `sc > m0 >= 0` are positive floats, whose bits order as the floats
//     do) and then of j among the lanes holding that score; the direction
//     rides in j's low bit.  A lane meets its j in descending order and
//     keeps a tie out, so the largest j wins, as the native scan's strict
//     improvement.
//
// Block path (a genome of >= BLOCK_MIN anchors, its ring 4 x 512 anchors):
// the four warps take chunks w, w+4, ... in rounds.  After each round a
// barrier shares each warp's break; chunks past the first break are not
// scanned, and the scan ends in that round.  The warps' maxima meet in
// shared memory as 64-bit (score bits, j) keys under one more barrier
// (two buffers, by the step's parity).  Thread 0 writes anchor i to the
// ring and the outputs; it is also the lane that reads anchor i at step
// i+1, and the other warps first read it two barriers later.  Tried on an
// H100 and slower there: every warp balloting all four chunks' breaks
// itself with no round barrier (a second shared-memory round trip a
// round), the last round's breaks sent with the maxima under one barrier
// a step, and an int32 copy of the DP beside the int64 one.  With every
// genome on warps, chip_smoke.py's phase 7 runs 2.2x slower (its
// BLOCK_MIN sweep).
//
// Float exactness: the host library is built with -ffp-contract=off, so
// every float operation of the score is written as a rounded intrinsic
// (nvcc would otherwise contract a*b + c into an FMA).  The gap g is an
// integer computed exactly in int64; its score 0.1f*g + 0.5f*log2(g) (a
// float64 log2 on the host) comes from the host-built table gtab.
//
// Bound: the bytes of the anchors and outputs are small (13 bytes an
// anchor in, 9 out); the work is the predecessor visits the native scan
// makes, a handful of integer and float operations each, but the kernel is
// bound by the serial chain of steps (a step waits on the previous
// anchor's score): a genome costs its steps times a step's latency, a
// chunk's shared-memory reads and compares plus the reductions.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;         // warps per block: genomes of the warp path, or one genome
constexpr int RING = 512;        // a warp's ring of anchors (the block path's: WARPS x RING)
constexpr int GTAB_SMEM = 1024;  // the largest gap-score table staged in shared memory
constexpr unsigned FULL = 0xffffffffu;
constexpr int F_GAP_TABLE = 1;   // a gap within max_gap past the table

__device__ __forceinline__ float seed_weight(float l) {
  return __fmul_rn(__fmul_rn(0.1f, l), l);
}

// the block's shared memory: one ring of WARPS x RING anchors (a warp's
// own ring is its quarter) and the staged gap-score table
struct Shared {
  int32_t q[WARPS * RING], t[WARPS * RING], l[WARPS * RING];
  float sw[WARPS * RING], ms[WARPS * RING];
  int8_t dir[WARPS * RING];
  float gtab[GTAB_SMEM];
  uint64_t red[2][WARPS];
  int brk[2][WARPS];
};

// one genome's view: its columns and outputs in global memory, its ring
struct Genome {
  const int32_t *q, *t, *l;
  float* m_out;
  int32_t* p_out;
  int8_t* d_out;
  int32_t *rq, *rt, *rl;
  float *rsw, *rms;
  int8_t* rdir;
  int ring;  // the ring's size (a power of two)
};

struct Params {
  const float* gtab;
  int gtab_len;
  float max_gap, min_score;
  int max_dist;
};

struct Anchor {
  int64_t q, t, l;
  float sw;
};

// a predecessor's columns, seed weight, max score and direction
struct Pred {
  int64_t q, t, l;
  float sw, ms;
  int dir;
};

// predecessor j of anchor i (j >= 0): from the ring, or past it from the
// columns and this genome's outputs so far
__device__ __forceinline__ Pred load_pred(const Genome& gn, int i, int j) {
  Pred p;
  if (j >= i - gn.ring) {
    const int r = j & (gn.ring - 1);
    p.q = gn.rq[r];
    p.t = gn.rt[r];
    p.l = gn.rl[r];
    p.sw = gn.rsw[r];
    p.ms = gn.rms[r];
    p.dir = gn.rdir[r];
  } else {
    p.q = gn.q[j];
    p.t = gn.t[j];
    p.l = gn.l[j];
    p.sw = seed_weight((float)p.l);
    p.ms = gn.m_out[j];
    p.dir = gn.d_out[j];
  }
  return p;
}

// an int64 to float32, rounded to nearest (the int32 conversion where the
// value fits: the same float, at a quarter of the cost)
__device__ __forceinline__ float to_float(int64_t v) {
  return v == (int64_t)(int32_t)v ? __int2float_rn((int32_t)v) : __ll2float_rn(v);
}

// predecessor p (index j) of anchor a as a candidate where `live` (j >= 0
// and before the chunk's first break): the lane's best by strict
// improvement, score bits and key (j << 1 | forward).  Written without
// branches, so that two calls can interleave
__device__ __forceinline__ void consider(const Params& pr, const Anchor& a, const Pred& p, int j,
                                         bool live, float& best, int& key, int& flag) {
  const int64_t qd = a.q - p.q, td = a.t - p.t;
  const int64_t aqd = qd < 0 ? -qd : qd, atd = td < 0 ? -td : td;
  const bool fwd = a.t >= p.t;
  int64_t alt = (a.t + a.l) - (p.t + p.l);
  alt = alt < 0 ? -alt : alt;
  // gap (direction dependent), exact in int64
  int64_t gi = aqd - (fwd ? atd : alt);
  gi = gi < 0 ? -gi : gi;
  bool ok = live && qd != 0 && atd <= pr.max_dist && td != 0 && to_float(gi) <= pr.max_gap;
  const bool over = ok && gi >= pr.gtab_len;
  flag |= over ? F_GAP_TABLE : 0;
  ok = ok && !over;
  const int64_t bqe = p.q + p.l;
  const bool apart = a.q > bqe;
  // the weight: a's own when it starts past p's end (seed_weight(a.l) is
  // a.sw), else the overlap-trimmed length's, less p's for a gap of 0
  const float wl = seed_weight(to_float(apart ? a.l : (gi == 0 ? a.q + a.l - p.q
                                                                : a.q + a.l - bqe)));
  const float wt = !apart && gi == 0 ? __fadd_rn(-p.sw, wl) : wl;
  const int dir = fwd ? 1 : -1;
  const float bs = (p.dir == 0 || p.dir == dir) ? p.ms : p.sw;
  const float sc = __fsub_rn(__fadd_rn(bs, wt), pr.gtab[ok ? gi : 0]);
  if (ok && sc >= pr.min_score && sc > a.sw && sc > best) {
    best = sc;
    key = (j << 1) | fwd;
  }
}

__device__ __forceinline__ int first_lane(unsigned brk) { return brk ? __ffs(brk) - 1 : 32; }

// the warp's (score bits, key) maximum: bits 0 when no lane found one
__device__ __forceinline__ void warp_best(float best, int key, unsigned& bits, int& wkey) {
  const unsigned mine = key >= 0 ? __float_as_uint(best) : 0u;
  bits = __reduce_max_sync(FULL, mine);
  wkey = __reduce_max_sync(FULL, key >= 0 && mine == bits ? key : -1);
}

__device__ __forceinline__ Anchor load_anchor(const Genome& gn, int i) {
  Anchor a;
  a.q = gn.q[i];
  a.t = gn.t[i];
  a.l = gn.l[i];
  a.sw = seed_weight((float)a.l);
  return a;
}

// anchor i's result to the outputs and the ring
__device__ __forceinline__ void put(const Genome& gn, int i, const Anchor& a, unsigned bits,
                                    int key) {
  const bool found = key >= 0;
  const float m = found ? __uint_as_float(bits) : a.sw;
  const int8_t d = (int8_t)(found ? ((key & 1) ? 1 : -1) : 0);
  gn.m_out[i] = m;
  gn.p_out[i] = found ? key >> 1 : i;
  gn.d_out[i] = d;
  const int r = i & (gn.ring - 1);
  gn.rq[r] = (int32_t)a.q;
  gn.rt[r] = (int32_t)a.t;
  gn.rl[r] = (int32_t)a.l;
  gn.rsw[r] = a.sw;
  gn.rms[r] = m;
  gn.rdir[r] = d;
}

__global__ void __launch_bounds__(WARPS * 32)
chain1_kernel(const int32_t* __restrict__ qb, const int32_t* __restrict__ tb,
              const int32_t* __restrict__ ln, const int64_t* __restrict__ off,
              const int32_t* __restrict__ order, int G, int n_block,
              const float* __restrict__ gtab, int gtab_len, float max_gap, float min_score,
              int max_dist, float* ms, int32_t* prev, int8_t* dirs, int32_t* flags) {
  __shared__ Shared sh;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  Params pr{gtab, gtab_len, max_gap, min_score, max_dist};
  if (gtab_len <= GTAB_SMEM) {
    for (int z = threadIdx.x; z < gtab_len; z += WARPS * 32) sh.gtab[z] = gtab[z];
    pr.gtab = sh.gtab;
  }
  __syncthreads();
  const bool block = (int)blockIdx.x < n_block;
  int g;
  if (block) {
    g = order[blockIdx.x];
  } else {
    const int w = n_block + ((int)blockIdx.x - n_block) * WARPS + wid;
    if (w >= G) return;  // the warp path has no block barrier
    g = order[w];
  }
  const int64_t base = off[g];
  const int n = (int)(off[g + 1] - base);
  const int ro = block ? 0 : wid * RING;
  Genome gn{qb + base, tb + base, ln + base, ms + base, prev + base, dirs + base,
            sh.q + ro, sh.t + ro, sh.l + ro, sh.sw + ro, sh.ms + ro, sh.dir + ro,
            block ? WARPS * RING : RING};
  int flag = 0;
  Anchor a{};
  if (n > 0) {
    a = load_anchor(gn, 0);
    if (threadIdx.x == 0 || (!block && lane == 0)) put(gn, 0, a, 0u, -1);
  }
  if (block) {
    __syncthreads();
  } else {
    __syncwarp();
  }
  Anchor nx{};
  if (n > 1) nx = load_anchor(gn, 1);
  for (int i = 1; i < n; ++i) {
    a = nx;
    if (i + 1 < n) nx = load_anchor(gn, i + 1);  // in flight during the step
    float best = -INFINITY;
    int key = -1;
    unsigned bits;
    int wkey;
    const int nchunks = (i + 31) >> 5;
    if (!block) {
      // two chunks an iteration: both chunks' loads, then both ballots,
      // then the compares
      for (int c = 0; c < nchunks; c += 2) {
        const int j0 = i - 1 - 32 * c - lane, j1 = j0 - 32;
        Pred p0{}, p1{};
        if (j0 >= 0) p0 = load_pred(gn, i, j0);
        if (j1 >= 0) p1 = load_pred(gn, i, j1);
        const unsigned b0 = __ballot_sync(FULL, j0 >= 0 && a.q - p0.q > pr.max_dist);
        const unsigned b1 = __ballot_sync(FULL, j1 >= 0 && a.q - p1.q > pr.max_dist);
        consider(pr, a, p0, j0, j0 >= 0 && lane < first_lane(b0), best, key, flag);
        consider(pr, a, p1, j1, !b0 && j1 >= 0 && lane < first_lane(b1), best, key, flag);
        if (b0 | b1) break;
      }
      warp_best(best, key, bits, wkey);
      if (lane == 0) put(gn, i, a, bits, wkey);
      __syncwarp();
      continue;
    }
    // the block path: rounds of WARPS chunks, warp w taking chunk w of a
    // round; a barrier shares the round's breaks (two flag buffers, by the
    // round's parity)
    for (int r = 0; r * WARPS < nchunks; ++r) {
      const int c = r * WARPS + wid, j = i - 1 - 32 * c - lane;
      Pred p{};
      if (c < nchunks && j >= 0) p = load_pred(gn, i, j);
      const unsigned bw = __ballot_sync(FULL, c < nchunks && j >= 0 && a.q - p.q > pr.max_dist);
      if (lane == 0) sh.brk[r & 1][wid] = bw != 0;
      __syncthreads();
      int cb = WARPS;
      for (int z = WARPS - 1; z >= 0; --z)
        if (sh.brk[r & 1][z]) cb = z;
      consider(pr, a, p, j, wid <= cb && c < nchunks && j >= 0 && lane < first_lane(bw), best,
               key, flag);
      if (cb < WARPS) break;
    }
    warp_best(best, key, bits, wkey);
    uint64_t* red = sh.red[i & 1];  // a step's maxima; the next step's go to the other half
    if (lane == 0) red[wid] = ((uint64_t)bits << 32) | (uint32_t)(wkey + 1);
    __syncthreads();
    uint64_t top = red[0];
    for (int z = 1; z < WARPS; ++z) top = red[z] > top ? red[z] : top;
    if (threadIdx.x == 0) put(gn, i, a, (unsigned)(top >> 32), (int)(uint32_t)top - 1);
  }
  if (block) {
    flag = __syncthreads_or(flag);
    if (threadIdx.x == 0) flags[g] = flag;
  } else {
    flag = __reduce_or_sync(FULL, flag);
    if (lane == 0) flags[g] = flag;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() after the launch.
// order [G]: the genomes longest first, the first n_block on the block path.
int chain1_forward(const void* qb, const void* tb, const void* ln, const void* off,
                   const void* order, int G, int n_block, const void* gtab, int gtab_len,
                   float max_gap, float min_score, int max_dist, void* ms, void* prev,
                   void* dirs, void* flags, void* stream) {
  if (G <= 0) return 0;
  if (gtab_len <= 0 || max_dist < 0 || n_block < 0 || n_block > G)
    return (int)cudaErrorInvalidValue;
  const int blocks = n_block + (G - n_block + WARPS - 1) / WARPS;
  chain1_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)qb, (const int32_t*)tb, (const int32_t*)ln, (const int64_t*)off,
      (const int32_t*)order, G, n_block, (const float*)gtab, gtab_len, max_gap, min_score,
      max_dist, (float*)ms, (int32_t*)prev, (int8_t*)dirs, (int32_t*)flags);
  return (int)cudaGetLastError();
}

const char* chain1_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
