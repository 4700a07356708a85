// Phase-3 chain1 forward DP of a batch of genomes for NVIDIA Hopper
// (sm_90a): kernel chain1_forward.
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
//
// Design: one warp per genome (order[] lists the genomes longest first, so
// the long serial ones start first).  Step i is serial; its 32 lanes take
// the predecessors j = i-1-lane, i-33-lane, ... .  Each chunk ballots the
// break rule (qd > max_dist) and keeps only the lanes before the first
// breaking one, which is exactly where the native scan stops, for any
// order of qb: no predecessor window, so nothing is cut.  The warp max
// over (score, j) takes the largest j among equal scores: the native
// scan's descending order with strict improvement.  ms[j] and dirs[j] of
// earlier steps were written by lane 0 of the same warp; __syncwarp()
// orders them before the next step's loads.
//
// Float exactness: the host library is built with -ffp-contract=off, so
// every float operation of the score is written as a rounded intrinsic
// (nvcc would otherwise contract a*b + c into an FMA).  The gap g is an
// integer computed exactly in int64; its score 0.1f*g + 0.5f*log2(g) (a
// float64 log2 on the host) comes from the host-built table gtab.
//
// Bound: the bytes of the anchors and outputs are small (13 bytes an
// anchor in, 9 out); the work is the predecessor visits the native scan
// makes, each a handful of integer and float operations, so the kernel is
// bound by the serial chain of steps (a step waits on the previous
// anchor's score): a genome costs its count of 32-predecessor chunks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;  // genomes per block, a warp each
constexpr unsigned FULL = 0xffffffffu;
constexpr int F_GAP_TABLE = 1;  // a gap within max_gap past the table

__device__ __forceinline__ float seed_weight(float l) {
  return __fmul_rn(__fmul_rn(0.1f, l), l);
}

__global__ void __launch_bounds__(WARPS * 32)
chain1_kernel(const int32_t* __restrict__ qb, const int32_t* __restrict__ tb,
              const int32_t* __restrict__ ln, const int64_t* __restrict__ off,
              const int32_t* __restrict__ order, int G, const float* __restrict__ gtab,
              int gtab_len, float max_gap, float min_score, int max_dist,
              float* ms, int32_t* prev, int8_t* dirs, int32_t* flags) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= G) return;
  const int g = order[w];
  const int64_t base = off[g];
  const int n = (int)(off[g + 1] - base);
  const int32_t* q = qb + base;
  const int32_t* t = tb + base;
  const int32_t* l = ln + base;
  float* m_out = ms + base;
  int32_t* p_out = prev + base;
  int8_t* d_out = dirs + base;
  int flag = 0;
  if (n > 0 && lane == 0) {
    m_out[0] = seed_weight((float)l[0]);
    p_out[0] = 0;
    d_out[0] = 0;
  }
  __syncwarp();
  for (int i = 1; i < n; ++i) {
    const int64_t aq = q[i], at = t[i], al = l[i];
    const float m0 = seed_weight((float)al);
    float best = -INFINITY;
    int best_j = -1;
    int best_dir = 0;
    for (int c = i - 1; c >= 0; c -= 32) {
      const int j = c - lane;
      const bool in = j >= 0;
      int64_t bq = 0, bt = 0, bl = 0;
      if (in) {
        bq = q[j];
        bt = t[j];
        bl = l[j];
      }
      const int64_t qd = aq - bq;
      const unsigned brk = __ballot_sync(FULL, in && qd > max_dist);
      const int first = brk ? __ffs(brk) - 1 : 32;
      const int64_t td = at - bt;
      const int64_t atd = td < 0 ? -td : td;
      if (in && lane < first && qd != 0 && atd <= max_dist && td != 0) {
        // gap (direction dependent), exact in int64
        const int64_t aqd = qd < 0 ? -qd : qd;
        int64_t gi;
        if (at >= bt) {
          gi = aqd - atd;
        } else {
          int64_t alt = (at + al) - (bt + bl);
          alt = alt < 0 ? -alt : alt;
          gi = aqd - alt;
        }
        gi = gi < 0 ? -gi : gi;
        if (__ll2float_rn(gi) <= max_gap) {
          if (gi >= gtab_len) {
            flag |= F_GAP_TABLE;
          } else {
            const int64_t bqe = bq + bl;
            float wt;
            if (aq > bqe) {
              wt = seed_weight((float)al);
            } else if (gi == 0) {
              wt = __fadd_rn(-seed_weight((float)bl), seed_weight((float)(aq + al - bq)));
            } else {
              wt = seed_weight((float)(aq + al - bqe));
            }
            const int dir = at >= bt ? 1 : -1;
            const int bdir = d_out[j];
            const float bs = (bdir == 0 || bdir == dir) ? m_out[j] : seed_weight((float)bl);
            const float sc = __fsub_rn(__fadd_rn(bs, wt), gtab[gi]);
            // a lane meets its j in descending order: a tie keeps the
            // larger j it already holds
            if (sc >= min_score && sc > m0 && sc > best) {
              best = sc;
              best_j = j;
              best_dir = dir;
            }
          }
        }
      }
      if (brk) break;  // the whole warp: the scan ends in this chunk
    }
    // warp max over (score, j), ties to the larger j
    for (int d = 16; d > 0; d >>= 1) {
      const float os = __shfl_xor_sync(FULL, best, d);
      const int oj = __shfl_xor_sync(FULL, best_j, d);
      const int od = __shfl_xor_sync(FULL, best_dir, d);
      if (os > best || (os == best && oj > best_j)) {
        best = os;
        best_j = oj;
        best_dir = od;
      }
    }
    if (lane == 0) {
      const bool found = best_j >= 0;
      m_out[i] = found ? best : m0;
      p_out[i] = found ? best_j : i;
      d_out[i] = (int8_t)(found ? best_dir : 0);
    }
    __syncwarp();
  }
  flag = __reduce_or_sync(FULL, flag);
  if (lane == 0) flags[g] = flag;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() after the launch.
int chain1_forward(const void* qb, const void* tb, const void* ln, const void* off,
                   const void* order, int G, const void* gtab, int gtab_len, float max_gap,
                   float min_score, int max_dist, void* ms, void* prev, void* dirs,
                   void* flags, void* stream) {
  if (G <= 0) return 0;
  if (gtab_len <= 0 || max_dist < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (G + WARPS - 1) / WARPS;
  chain1_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)qb, (const int32_t*)tb, (const int32_t*)ln, (const int64_t*)off,
      (const int32_t*)order, G, (const float*)gtab, gtab_len, max_gap, min_score, max_dist,
      (float*)ms, (int32_t*)prev, (int8_t*)dirs, (int32_t*)flags);
  return (int)cudaGetLastError();
}

const char* chain1_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
