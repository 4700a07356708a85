// Gap-affine wavefront alignment (WFA) of a batch of sequence pairs for
// NVIDIA Hopper (sm_90a): kernels wfa_forward and wfa_traceback.
//
// Replaces lexicmap_tpu/parallel/wfa_device.py::build_wfa_step (a jitted
// lax.while_loop over scores, vmapped over pairs) and ::build_wfa_traceback.
// Both reproduce the port's native oracle native/core.cpp wfa_align (and
// ops/wfa.py::wfa_align) exactly: penalties x, o, e (4, 6, 2), adaptive
// reduction (min_wf_len 10, max_dist_diff 50), the traceback's "XDI"
// preference with gap-open before gap-extension.
//
// Layout: every sequence is packed 2 bits a base, MSB first, 32 bases to a
// 64-bit word, with one word of padding after its last; a pair is its two
// word offsets and lengths n (query) and m (target).  The wavefront history
// is int16 [B, S, 3, W] (M, I, D offsets f = target progress; NEG = dead) with
// the window's first diagonal lo [B, S] (BIG for a score with no source):
// row s holds diagonals lo .. lo+W-1.  done_s [B] is the final score, or -1
// when the pair overflowed (a live span wider than W, or no end within S
// scores): such a pair goes to the host.  The traceback writes (op, count)
// runs newest first, op 0 = M, 1 = X, 2 = I, 3 = D, equal neighbours merged,
// into ops int8 / cnts int32 [B, CAP] and their count into nops [B] (-1 on
// overflow or failure).
//
// wfa_forward, one CTA of W threads per pair, a thread per diagonal of the
// window; per score s:
//   1. the window [lo, lo+W) from the live spans of the source rows s-x,
//      s-o-e, s-e (the native's trimmed spans), kept in shared memory;
//   2. each thread computes its cell's D, I and M from a ring of the last
//      max(x, o+e)+1 rows in shared memory, then extends M greedily, 32
//      bases a step (XOR of two packed words, count of leading zeros);
//   3. a block reduction of the live M count and the least distance to the
//      end drives the adaptive reduction; the row goes to the ring and to
//      the history in global memory;
//   4. a second reduction gives the row's live span and whether diagonal
//      m-n reached the end.
// wfa_traceback, one thread per pair, walks the history back from done_s.
//
// Bound: the work is the wavefront cells computed and the bases the
// extension compares, the bytes the history rows written and read back by
// the traceback (chip_smoke.py counts both from the run's data).  The
// forward kernel is bound by latency: each score is three barriers and the
// slowest thread's extension, and a pair's scores are serial, so the card
// is filled by many pairs, not by wide rows.  int16 offsets keep the
// history at 6 bytes a cell; sequences are at most 30,000 bases.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -20000;  // a dead cell; survives +1 in int16
constexpr int BIG = 1 << 20;
constexpr int MAX_W = 256;
constexpr int MAX_WARPS = MAX_W / 32;
constexpr int MAX_R = 64;
constexpr unsigned FULL = 0xffffffffu;

// 32 bases starting at base i, MSB first
__device__ __forceinline__ uint64_t bases_at(const uint64_t* s, int i) {
  const int w = i >> 5, sh = (i & 31) * 2;
  const uint64_t a = s[w];
  return sh ? (a << sh) | (s[w + 1] >> (64 - sh)) : a;
}

// greedy match extension of offset f on diagonal k (ref: the native's
// extend_match): stops at the first mismatch or the end of either sequence
__device__ int extend(const uint64_t* q, const uint64_t* t, int n, int m, int f, int k) {
  int i = f - k;
  while (f < m && i < n) {
    const uint64_t x = bases_at(q, i) ^ bases_at(t, f);
    const int lead = x ? (__clzll(x) >> 1) : 32;
    const int rem = min(n - i, m - f);
    if (lead >= rem) return f + rem;
    f += lead;
    i += lead;
    if (lead < 32) break;
  }
  return f;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int d = 16; d > 0; d >>= 1) v = min(v, __shfl_xor_sync(FULL, v, d));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int d = 16; d > 0; d >>= 1) v = max(v, __shfl_xor_sync(FULL, v, d));
  return v;
}

__global__ void wfa_forward(const uint64_t* __restrict__ seq, const int64_t* __restrict__ q_off,
                            const int64_t* __restrict__ t_off, const int32_t* __restrict__ ns,
                            const int32_t* __restrict__ ms, int S, int W, int R, int x, int o,
                            int e, int min_wf_len, int max_dist_diff, int16_t* hist,
                            int32_t* los, int32_t* done_s) {
  extern __shared__ int32_t ring[];  // [R][3][W]
  __shared__ int meta_lo[MAX_R], meta_tlo[MAX_R], meta_thi[MAX_R];
  __shared__ int red_a[MAX_WARPS][2], red_b[MAX_WARPS][3];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = W >> 5;
  const uint64_t* q = seq + q_off[b];
  const uint64_t* t = seq + t_off[b];
  const int n = ns[b], m = ms[b], k_end = m - n;
  int16_t* hb = hist + (int64_t)b * S * 3 * W;
  int32_t* lb = los + (int64_t)b * S;

  // s = 0: diagonal 0 only (lo = 0)
  const int m0 = tid == 0 ? extend(q, t, n, m, 0, 0) : NEG;
  ring[tid] = m0;
  ring[W + tid] = NEG;
  ring[2 * W + tid] = NEG;
  hb[tid] = (int16_t)m0;
  hb[W + tid] = (int16_t)NEG;
  hb[2 * W + tid] = (int16_t)NEG;
  if (tid == 0) {
    lb[0] = 0;
    meta_lo[0] = 0;
    meta_tlo[0] = 0;
    meta_thi[0] = 0;
  }
  __syncthreads();
  int s_final = (k_end == 0 && ring[0] >= m) ? 0 : -1;

  const int srcs[3] = {x, o + e, e};
  const int dks[3] = {0, 1, 1};
  for (int s = 1; s_final < 0 && s < S; ++s) {
    const int slot = s % R;
    int kmin = BIG, kmax = -BIG;
    for (int z = 0; z < 3; ++z) {
      const int src = s - srcs[z];
      if (src < 0) continue;
      const int r = src % R;
      if (meta_tlo[r] <= meta_thi[r]) {
        kmin = min(kmin, meta_tlo[r] - dks[z]);
        kmax = max(kmax, meta_thi[r] + dks[z]);
      }
    }
    if (kmin > kmax) {  // no live source: a dead row
      if (tid == 0) {
        lb[s] = BIG;
        meta_lo[slot] = BIG;
        meta_tlo[slot] = 1;
        meta_thi[slot] = 0;
      }
      __syncthreads();
      continue;
    }
    if (kmax - kmin + 1 > W) break;  // the live span outgrew the window
    const int lo = kmin, k = lo + tid;
    auto get = [&](int src, int which, int kk) -> int {
      if (src < 0) return NEG;
      const int r = src % R;
      const int idx = kk - meta_lo[r];
      return (idx >= 0 && idx < W) ? ring[(r * 3 + which) * W + idx] : NEG;
    };
    const int s_x = s - x, s_oe = s - o - e, s_e = s - e;
    int D = max(get(s_oe, 0, k - 1), get(s_e, 2, k - 1));
    if (D > NEG) D += 1;
    int I = max(get(s_oe, 0, k + 1), get(s_e, 1, k + 1));
    int mis = get(s_x, 0, k);
    if (mis > NEG) mis += 1;
    int M = max(max(mis, I), D);
    if (!(M > NEG && M <= m && M - k >= 0 && M - k <= n)) M = NEG;
    if (!(I > NEG && I <= m && I - k >= 0 && I - k <= n)) I = NEG;
    if (!(D > NEG && D <= m && D - k >= 0 && D - k <= n)) D = NEG;
    if (M > NEG) M = extend(q, t, n, m, M, k);

    // adaptive reduction (the native's wfa DefaultAdaptiveOption)
    const bool has = M > NEG;
    const int dist = has ? (m - M) + (n - (M - k)) : BIG;
    const int cnt_w = __popc(__ballot_sync(FULL, has));
    const int dmin_w = warp_min(dist);
    if (lane == 0) {
      red_a[warp][0] = cnt_w;
      red_a[warp][1] = dmin_w;
    }
    __syncthreads();
    int cnt = 0, dmin = BIG;
    for (int z = 0; z < nw; ++z) {
      cnt += red_a[z][0];
      dmin = min(dmin, red_a[z][1]);
    }
    if (cnt >= min_wf_len && has && dist - dmin > max_dist_diff) M = I = D = NEG;

    ring[(slot * 3) * W + tid] = M;
    ring[(slot * 3 + 1) * W + tid] = I;
    ring[(slot * 3 + 2) * W + tid] = D;
    int16_t* row = hb + (int64_t)s * 3 * W;
    row[tid] = (int16_t)M;
    row[W + tid] = (int16_t)I;
    row[2 * W + tid] = (int16_t)D;

    const bool live = M > NEG || I > NEG || D > NEG;
    const int tlo_w = warp_min(live ? k : BIG);
    const int thi_w = warp_max(live ? k : -BIG);
    const int hit_w = __any_sync(FULL, k == k_end && M >= m);
    if (lane == 0) {
      red_b[warp][0] = tlo_w;
      red_b[warp][1] = thi_w;
      red_b[warp][2] = hit_w;
    }
    __syncthreads();
    int tlo = BIG, thi = -BIG, hit = 0;
    for (int z = 0; z < nw; ++z) {
      tlo = min(tlo, red_b[z][0]);
      thi = max(thi, red_b[z][1]);
      hit |= red_b[z][2];
    }
    if (tid == 0) {
      lb[s] = lo;
      meta_lo[slot] = lo;
      meta_tlo[slot] = tlo;
      meta_thi[slot] = thi;
    }
    if (hit) s_final = s;
    __syncthreads();
  }
  if (tid == 0) done_s[b] = s_final;
}

__global__ void wfa_traceback(const int16_t* __restrict__ hist, const int32_t* __restrict__ los,
                              const int32_t* __restrict__ done_s, const int32_t* __restrict__ ns,
                              const int32_t* __restrict__ ms, int B, int S, int W, int CAP,
                              int x, int o, int e, int8_t* ops, int32_t* cnts, int32_t* nops) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int s = done_s[b];
  if (s < 0) {
    nops[b] = -1;
    return;
  }
  const int16_t* hb = hist + (int64_t)b * S * 3 * W;
  const int32_t* lb = los + (int64_t)b * S;
  int8_t* op = ops + (int64_t)b * CAP;
  int32_t* cn = cnts + (int64_t)b * CAP;
  auto get = [&](int ss, int which, int kk) -> int {
    if (ss < 0) return NEG;
    const int idx = kk - lb[ss];
    return (idx >= 0 && idx < W) ? (int)hb[((int64_t)ss * 3 + which) * W + idx] : NEG;
  };
  int w = 0;
  auto emit = [&](int code, int c) -> bool {
    if (c <= 0) return true;
    if (w > 0 && op[w - 1] == code) {
      cn[w - 1] += c;
      return true;
    }
    if (w >= CAP) return false;
    op[w] = (int8_t)code;
    cn[w] = c;
    ++w;
    return true;
  };
  int k = ms[b] - ns[b], f = ms[b], state = 0;  // 0 M, 1 I, 2 D
  bool ok = true;
  while (ok) {
    if (state == 0) {
      if (s == 0) {
        ok = emit(0, f);
        break;
      }
      int mis = get(s - x, 0, k);
      if (mis > NEG) mis += 1;
      const int ins = get(s, 1, k), del = get(s, 2, k);
      const int fp = max(max(mis, ins), del);
      if (fp <= NEG + 2) {
        ok = false;
        break;
      }
      ok = emit(0, f - fp);
      f = fp;
      if (mis == fp) {  // preference X, D, I
        ok = ok && emit(1, 1);
        s -= x;
        f -= 1;
      } else if (del == fp) {
        state = 2;
      } else {
        state = 1;
      }
    } else if (state == 1) {  // I: consume query, from k+1, f unchanged
      const int ov = get(s - o - e, 0, k + 1), ev = get(s - e, 1, k + 1);
      ok = emit(2, 1);
      if (ov == f) {
        s -= o + e;
        state = 0;
      } else if (ev == f) {
        s -= e;
      } else {
        ok = false;
      }
      k += 1;
    } else {  // D: consume target, from k-1, f -> f-1
      const int ov = get(s - o - e, 0, k - 1), ev = get(s - e, 2, k - 1);
      ok = emit(3, 1);
      if (ov == f - 1) {
        s -= o + e;
        state = 0;
      } else if (ev == f - 1) {
        s -= e;
      } else {
        ok = false;
      }
      k -= 1;
      f -= 1;
    }
  }
  nops[b] = ok ? w : -1;
}

}  // namespace

extern "C" {

// Launches both kernels on `stream` and returns cudaGetLastError() after
// them (cudaErrorInvalidValue for a shape this build does not take).
// hist, los and done_s are the caller's scratch.
int wfa_align_batch(const void* seq, const void* q_off, const void* t_off, const void* ns,
                    const void* ms, int B, int S, int W, int CAP, int x, int o, int e,
                    int min_wf_len, int max_dist_diff, void* hist, void* los, void* done_s,
                    void* ops, void* cnts, void* nops, void* stream) {
  if (B <= 0) return 0;
  const int R = (x > o + e ? x : o + e) + 1;
  if (W < 32 || W > MAX_W || W % 32 || S < 1 || CAP < 1 || x < 1 || e < 1 || o < 0 ||
      R > MAX_R)
    return (int)cudaErrorInvalidValue;
  const int smem = R * 3 * W * (int)sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(wfa_forward,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  wfa_forward<<<B, W, smem, st>>>((const uint64_t*)seq, (const int64_t*)q_off,
                                  (const int64_t*)t_off, (const int32_t*)ns, (const int32_t*)ms,
                                  S, W, R, x, o, e, min_wf_len, max_dist_diff, (int16_t*)hist,
                                  (int32_t*)los, (int32_t*)done_s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wfa_traceback<<<(B + 127) / 128, 128, 0, st>>>(
      (const int16_t*)hist, (const int32_t*)los, (const int32_t*)done_s, (const int32_t*)ns,
      (const int32_t*)ms, B, S, W, CAP, x, o, e, (int8_t*)ops, (int32_t*)cnts,
      (int32_t*)nops);
  return (int)cudaGetLastError();
}

const char* wfa_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
