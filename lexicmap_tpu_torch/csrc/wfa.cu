// Gap-affine wavefront alignment (WFA) of a batch of sequence pairs for
// NVIDIA Hopper (sm_90a): kernels wfa_size, wfa_offsets, wfa_forward and
// wfa_traceback.
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
// word offsets and lengths n (query) and m (target).  done_s [B] is the
// final score, or -1 when the pair overflowed (a live span wider than W, or
// no end within S scores): such a pair goes to the host.  The traceback
// writes (op, count) runs newest first, op 0 = M, 1 = X, 2 = I, 3 = D,
// equal neighbours merged, into ops int8 / cnts int32 [B, CAP] and their
// count into nops [B] (-1 on overflow or failure).
//
// wfa_size and wfa_forward, one warp per pair, WARPS pairs to a block,
// over the scores that are multiples of G = gcd(x, o+e, e) (any other has
// no live source: every odd score under the even defaults); per score s:
//   1. the span [kmin, kmax] from the live spans of the source rows s-x,
//      s-o-e, s-e (the native's trimmed spans, from a per-warp ring of the
//      last max(x, o+e)/G + 1 rows in shared memory, each row's metadata
//      one 16-byte read).  A score with no live source (a dead row) costs
//      that check and one store;
//   2. the span's cells, 32 diagonals a pass (one pass for the ~15-cell
//      spans of gene queries), each cell's D, I and M from the ring, M
//      extended greedily 32 bases a step (XOR of two packed words, count of
//      leading zeros) from the pair's words, copied into shared memory when
//      they fit (pairs up to ~2.5 kb);
//   3. the adaptive reduction's live count (ballot + popc) and least
//      distance (__reduce_min_sync), then the pruned row to the ring and
//      to the history, and its live span and end hit from ballots.
// No block barrier: a warp's lanes order their ring traffic with
// __syncwarp, and each pair's score chain runs at its own pace.
//
// History: a row is written only over its span, as three int16 runs of
// `width` cells (M, I, D) appended to the pair's region of hist; meta int2
// [B, S] holds each row's first diagonal and (cells before it in the
// region << 9 | width), width 0 for a dead row (a score that is not a
// multiple of G has no entry: no path reads it).  A read outside a row's
// span is NEG, as the dead cells of a W-wide row were.
//
// Size, then write: hist is one packed arena holding just the cells the
// launch's pairs write.  wfa_size runs the forward DP with no history and
// leaves each pair's cell count (3 x its rows' widths and score 0's one
// diagonal; 0 for a pair it flags) in off[b]; wfa_offsets turns the counts
// into offsets, each region rounded up to ALIGN cells (16 bytes, for the
// traceback's copies), and the arena's size in off[B], which the caller
// reads back to allocate the arena.  wfa_forward then runs the same DP
// (one template body) writing pair b's rows from hist + off[b], and skips
// a pair the sizing pass flagged.  A 1.5 kb 16S pair's arena and row
// table take ~37 KiB, where room for every score at the full window took
// 776 KiB.
//
// wfa_traceback, one warp per pair: the warp copies the pair's row table
// and its cells (~20 KB for a 1.5 kb gene pair; the newest 48 or 112 KB of
// a larger history) into shared memory with cp.async, then one lane walks them back from
// done_s (the path is serial: a step's reads depend on the last step's
// choice), so a step waits on shared memory, not on L2, and the runs stay
// in registers until they close.
//
// Bound: the work is the wavefront cells computed and the bases the
// extension compares (chip_smoke.py counts both from the run's data).  The
// forward kernel is bound by latency: a pair's scores are serial, each a
// chain of shared-memory reads, the extension and two warp reductions, so
// the card is filled by many pairs, not by wide rows.  int16 offsets keep
// the history at 6 bytes a cell; sequences are at most 30,000 bases.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -20000;  // a dead cell; survives +1 in int16
constexpr int BIG = 1 << 20;
constexpr int MAX_W = 256;
constexpr int MAX_R = 64;
constexpr int WARPS = 4;        // pairs per block of wfa_forward
constexpr int SEQ_WORDS = 160;  // per-warp cache of a pair's packed words
// wfa_traceback's shared memory for a pair's history: a large batch takes
// four pairs to a block, 48 KB each; a batch that one wave of two pairs
// an SM holds (at most 264 pairs, as on the main path) 112 KB a pair, so
// that divergent pairs fit whole (112 KB for every batch was slower on
// 4,096 pairs on an H100: half the pairs in flight)
constexpr int TB_SMEM_MANY = 48 << 10, TB_SMEM_FEW = 112 << 10, TB_FEW = 264;
constexpr unsigned FULL = 0xffffffffu;
constexpr int ALIGN = 8;  // cells: each pair's region of the arena starts 16-byte aligned
constexpr int SCAN = 1024;  // threads of wfa_offsets

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

// one source row of the ring: its slot's cells, first diagonal and width
struct Src {
  const int16_t* cells;  // [3][W] of the slot
  int lo, w;
  __device__ Src(const int16_t* c, int4 meta) : cells(c), lo(meta.x), w(meta.y) {}
  __device__ __forceinline__ int get(int which, int k, int W) const {
    const int idx = k - lo;
    return (unsigned)idx < (unsigned)w ? (int)cells[which * W + idx] : NEG;
  }
};

__device__ __forceinline__ bool valid(int v, int k, int n, int m) {
  return v > NEG && v <= m && v - k >= 0 && v - k <= n;
}

// bytes of one warp's shared memory: word cache, ring meta, ring cells
__host__ __device__ constexpr int warp_smem(int R, int W) {
  return ((SEQ_WORDS * 8 + R * 16 + R * 3 * W * 2) + 15) / 16 * 16;
}

__host__ __device__ constexpr int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }

// The forward DP of pair b, one warp; WRITE: its rows to hist + off[b] and
// meta, else only its cell count to off[b].  done_s[b] is the final score.
template <bool WRITE>
__device__ __forceinline__ void forward_pair(
    unsigned char* smem, int b, const uint64_t* __restrict__ seq,
    const int64_t* __restrict__ q_off, const int64_t* __restrict__ t_off,
    const int32_t* __restrict__ ns, const int32_t* __restrict__ ms, int S, int W, int R, int G,
    int x, int o, int e, int min_wf_len, int max_dist_diff, int64_t* off, int16_t* hist,
    int2* meta, int32_t* done_s) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  unsigned char* mine = smem + wid * warp_smem(R, W);
  uint64_t* cache = reinterpret_cast<uint64_t*>(mine);
  int4* r_meta = reinterpret_cast<int4*>(mine + SEQ_WORDS * 8);  // per slot: lo, width, tlo, thi
  int16_t* ring = reinterpret_cast<int16_t*>(r_meta + R);        // [R][3][W]

  const int n = ns[b], m = ms[b], k_end = m - n;
  const uint64_t* q = seq + q_off[b];
  const uint64_t* t = seq + t_off[b];
  const int nq = n / 32 + 2, nt = m / 32 + 2;
  if (nq + nt <= SEQ_WORDS) {
    for (int i = lane; i < nq; i += 32) cache[i] = q[i];
    for (int i = lane; i < nt; i += 32) cache[nq + i] = t[i];
    q = cache;
    t = cache + nq;
    __syncwarp();
  }
  int16_t* hb = WRITE ? hist + off[b] : nullptr;
  int2* mb = WRITE ? meta + (int64_t)b * S : nullptr;

  // s = 0: diagonal 0 only
  const int m0 = extend(q, t, n, m, 0, 0);
  if (lane == 0) {
    ring[0] = (int16_t)m0;
    ring[W] = (int16_t)NEG;
    ring[2 * W] = (int16_t)NEG;
    r_meta[0] = make_int4(0, 1, 0, 0);
    if (WRITE) {
      hb[0] = (int16_t)m0;
      hb[1] = (int16_t)NEG;
      hb[2] = (int16_t)NEG;
      mb[0] = make_int2(0, 1);
    }
  }
  __syncwarp();
  int s_final = (k_end == 0 && m0 >= m) ? 0 : -1;
  int cum = 1;  // history cells (per kind) written so far

  // a score that is not a multiple of G = gcd(x, o+e, e) has no live
  // source: rows are kept only for multiples of G, slot (s / G) % R
  const int ds[3] = {x / G, (o + e) / G, e / G};
  int slot = 0;
  for (int s = G; s_final < 0 && s < S; s += G) {
    slot = slot + 1 == R ? 0 : slot + 1;
    int4 src[3];  // the source rows' metas (dead where src < 0)
    int kmin = BIG, kmax = -BIG;
#pragma unroll
    for (int z = 0; z < 3; ++z) {
      src[z] = make_int4(BIG, 0, 1, 0);
      if (s - ds[z] * G < 0) continue;
      src[z] = r_meta[slot - ds[z] < 0 ? slot - ds[z] + R : slot - ds[z]];
      if (src[z].z <= src[z].w) {
        const int dk = z == 0 ? 0 : 1;
        kmin = min(kmin, src[z].z - dk);
        kmax = max(kmax, src[z].w + dk);
      }
    }
    if (kmin > kmax) {  // no live source: a dead row
      if (lane == 0) {
        r_meta[slot] = make_int4(BIG, 0, 1, 0);
        if (WRITE) mb[s] = make_int2(BIG, cum << 9);
      }
      __syncwarp();
      continue;
    }
    const int width = kmax - kmin + 1;
    if (width > W) break;  // the live span outgrew the window
    const int lo = kmin;
    auto cells = [&](int z) {
      const int r = slot - ds[z] < 0 ? slot - ds[z] + R : slot - ds[z];
      return ring + r * 3 * W;
    };
    const Src sx(cells(0), src[0]), soe(cells(1), src[1]), se(cells(2), src[2]);
    int16_t* row = ring + slot * 3 * W;

    // pass 1: cells before the adaptive reduction
    int M = NEG, I = NEG, D = NEG, cnt = 0, dmin = BIG;
    for (int base = 0; base < width; base += 32) {
      const int idx = base + lane, k = lo + idx;
      M = I = D = NEG;
      if (idx < width) {
        D = max(soe.get(0, k - 1, W), se.get(2, k - 1, W));
        if (D > NEG) D += 1;
        I = max(soe.get(0, k + 1, W), se.get(1, k + 1, W));
        int mis = sx.get(0, k, W);
        if (mis > NEG) mis += 1;
        M = max(max(mis, I), D);
        if (!valid(M, k, n, m)) M = NEG;
        if (!valid(I, k, n, m)) I = NEG;
        if (!valid(D, k, n, m)) D = NEG;
        if (M > NEG) M = extend(q, t, n, m, M, k);
        if (width > 32) {  // kept for pass 2 (one pass keeps them in registers)
          row[idx] = (int16_t)M;
          row[W + idx] = (int16_t)I;
          row[2 * W + idx] = (int16_t)D;
        }
      }
      const bool has = M > NEG;
      cnt += __popc(__ballot_sync(FULL, has));
      if (has) dmin = min(dmin, (m - M) + (n - (M - k)));
    }
    dmin = __reduce_min_sync(FULL, dmin);
    const bool prune = cnt >= min_wf_len;

    // pass 2: the reduction, the row to the ring and the history, its span
    int16_t* hrow = WRITE ? hb + cum * 3 : nullptr;
    int tlo = BIG, thi = -BIG;
    bool hit = false;
    for (int base = 0; base < width; base += 32) {
      const int idx = base + lane, k = lo + idx;
      bool live = false;
      if (idx < width) {
        if (width > 32) {
          M = row[idx];
          I = row[W + idx];
          D = row[2 * W + idx];
        }
        if (prune && M > NEG && (m - M) + (n - (M - k)) - dmin > max_dist_diff) M = I = D = NEG;
        row[idx] = (int16_t)M;
        row[W + idx] = (int16_t)I;
        row[2 * W + idx] = (int16_t)D;
        if (WRITE) {
          hrow[idx] = (int16_t)M;
          hrow[width + idx] = (int16_t)I;
          hrow[2 * width + idx] = (int16_t)D;
        }
        live = M > NEG || I > NEG || D > NEG;
        hit = hit || (k == k_end && M >= m);
      }
      const unsigned lv = __ballot_sync(FULL, live);
      if (lv) {
        if (tlo == BIG) tlo = lo + base + __ffs(lv) - 1;
        thi = lo + base + 31 - __clz(lv);
      }
    }
    if (lane == 0) {
      r_meta[slot] = make_int4(lo, width, tlo, thi);
      if (WRITE) mb[s] = make_int2(lo, (cum << 9) | width);
    }
    cum += width;
    if (__any_sync(FULL, hit)) s_final = s;
    __syncwarp();
  }
  if (lane == 0) {
    done_s[b] = s_final;
    if (!WRITE) off[b] = s_final >= 0 ? 3 * (int64_t)cum : 0;
  }
}

// the sizing pass: each pair's history cells to off[b] (0 where flagged)
__global__ void __launch_bounds__(WARPS * 32)
wfa_size(const uint64_t* __restrict__ seq, const int64_t* __restrict__ q_off,
         const int64_t* __restrict__ t_off, const int32_t* __restrict__ ns,
         const int32_t* __restrict__ ms, int B, int S, int W, int R, int G, int x, int o, int e,
         int min_wf_len, int max_dist_diff, int64_t* off, int32_t* done_s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warps only: nothing below waits on the block
  forward_pair<false>(smem, b, seq, q_off, t_off, ns, ms, S, W, R, G, x, o, e, min_wf_len,
                      max_dist_diff, off, nullptr, nullptr, done_s);
}

// off [B + 1]: the counts of off[0, B) -> their exclusive prefix sums, each
// rounded up to ALIGN cells, and the arena's cells in off[B]; one block
__global__ void __launch_bounds__(SCAN) wfa_offsets(int64_t* off, int B) {
  __shared__ int64_t warp_sum[SCAN / 32];
  __shared__ int64_t carry;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < B; base += SCAN) {
    const int i = base + threadIdx.x;
    const int64_t v = i < B ? (off[i] + ALIGN - 1) / ALIGN * ALIGN : 0;
    int64_t inc = v;  // inclusive sum over the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t y = __shfl_up_sync(FULL, inc, d);
      if (lane >= d) inc += y;
    }
    if (lane == 31) warp_sum[wid] = inc;
    __syncthreads();
    if (wid == 0) {  // inclusive sum over the warps' sums
      int64_t w = warp_sum[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int64_t y = __shfl_up_sync(FULL, w, d);
        if (lane >= d) w += y;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    inc += (wid ? warp_sum[wid - 1] : 0) + carry;
    if (i < B) off[i] = inc - v;
    __syncthreads();  // every thread has read carry
    if (threadIdx.x == SCAN - 1) carry = inc;
    __syncthreads();
  }
  if (threadIdx.x == 0) off[B] = carry;
}

// the write pass: the sized pairs' rows into the arena
__global__ void __launch_bounds__(WARPS * 32)
wfa_forward(const uint64_t* __restrict__ seq, const int64_t* __restrict__ q_off,
            const int64_t* __restrict__ t_off, const int32_t* __restrict__ ns,
            const int32_t* __restrict__ ms, int B, int S, int W, int R, int G, int x, int o,
            int e, int min_wf_len, int max_dist_diff, int64_t* off, int16_t* hist, int2* meta,
            int32_t* done_s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B || done_s[b] < 0) return;  // flagged by the sizing pass: no room
  forward_pair<true>(smem, b, seq, q_off, t_off, ns, ms, S, W, R, G, x, o, e, min_wf_len,
                     max_dist_diff, off, hist, meta, done_s);
}

__global__ void __launch_bounds__(128)
wfa_traceback(const int64_t* __restrict__ off, const int16_t* __restrict__ hist,
              const int2* __restrict__ meta, const int32_t* __restrict__ done_s,
              const int32_t* __restrict__ ns, const int32_t* __restrict__ ms, int B, int S,
              int CAP, int x, int o, int e, int stage_bytes, int8_t* ops, int32_t* cnts,
              int32_t* nops) {
  extern __shared__ __align__(16) unsigned char tb_smem[];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + wid;
  if (b >= B) return;
  int s = done_s[b];
  if (s < 0) {
    if (lane == 0) nops[b] = -1;
    return;
  }
  const int16_t* hb = hist + off[b];
  const int2* mb = meta + (int64_t)b * S;
  // the pair's history into the warp's shared memory: its row table up to
  // done_s where that takes at most half of stage_bytes (8 bytes a lane a
  // step), then as many of its last cells as fit (16 bytes a lane a step;
  // a pair's cells start 16-byte aligned): the walk starts at done_s, so
  // an older row's cells, if any, are the ones read from global memory
  const int2 last = mb[s];
  const int n_cells = ((last.y >> 9) + (last.y & 511)) * 3;
  int4* stage = reinterpret_cast<int4*>(tb_smem + wid * stage_bytes);
  const int rows16 = (s + 2) / 2 <= stage_bytes / 32 ? (s + 2) / 2 : 0;
  if (rows16) {
    for (int z = lane; z <= s; z += 32)
      __pipeline_memcpy_async(reinterpret_cast<int2*>(stage) + z, mb + z, 8);
    mb = reinterpret_cast<const int2*>(stage);
  }
  const int cap16 = stage_bytes / 16 - rows16, n16 = (n_cells + 7) / 8;
  const int first16 = n16 > cap16 ? n16 - cap16 : 0;
  // cells copied asynchronously (cp.async): every lane's copies in flight
  // at once, not one global round trip after another
  const int4* csrc = reinterpret_cast<const int4*>(hb);
  for (int z = first16 + lane; z < n16; z += 32)
    __pipeline_memcpy_async(stage + rows16 + z - first16, csrc + z, 16);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  const int16_t* staged = reinterpret_cast<const int16_t*>(stage + rows16);
  const int staged_from = first16 * 8;  // cells from here on are in shared memory
  __syncwarp();
  if (lane != 0) return;  // one lane walks: the path is serial
  int8_t* op = ops + (int64_t)b * CAP;
  int32_t* cn = cnts + (int64_t)b * CAP;
  const int2 dead = make_int2(BIG, 0);
  auto row = [&](int ss) -> int2 { return ss < 0 ? dead : mb[ss]; };
  auto get = [&](int2 r, int which, int kk) -> int {
    const int idx = kk - r.x, w = r.y & 511;
    if ((unsigned)idx >= (unsigned)w) return NEG;
    const int at = (r.y >> 9) * 3 + which * w + idx;
    return at >= staged_from ? (int)staged[at - staged_from] : (int)hb[at];
  };
  // runs so far (w, the last of them open in cur / cur_n, stored when the
  // next one starts: the walk never reads back what it wrote)
  int w = 0, cur = -1, cur_n = 0;
  auto emit = [&](int code, int c) -> bool {
    if (c <= 0) return true;
    if (w > 0 && cur == code) {
      cur_n += c;
      return true;
    }
    if (w >= CAP) return false;
    if (w > 0) {
      op[w - 1] = (int8_t)cur;
      cn[w - 1] = cur_n;
    }
    cur = code;
    cur_n = c;
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
      const int2 rx = row(s - x), rs = row(s);
      int mis = get(rx, 0, k);
      if (mis > NEG) mis += 1;
      const int ins = get(rs, 1, k), del = get(rs, 2, k);
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
    } else {
      const int2 roe = row(s - o - e), re = row(s - e);
      if (state == 1) {  // I: consume query, from k+1, f unchanged
        const int ov = get(roe, 0, k + 1), ev = get(re, 1, k + 1);
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
        const int ov = get(roe, 0, k - 1), ev = get(re, 2, k - 1);
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
  }
  if (ok && w > 0) {
    op[w - 1] = (int8_t)cur;
    cn[w - 1] = cur_n;
  }
  nops[b] = ok ? w : -1;
}

// a shape's ring rows R, score step G and a forward block's shared memory,
// or an error for a shape this build does not take
int forward_shape(int S, int W, int x, int o, int e, int* R, int* G, int* smem) {
  if (W < 32 || W > MAX_W || W % 32 || S < 1 || x < 1 || e < 1 || o < 0 ||
      (int64_t)S * W >= (1 << 22))
    return (int)cudaErrorInvalidValue;
  *G = gcd(gcd(x, o + e), e);
  *R = (x > o + e ? x : o + e) / *G + 1;
  if (*R > MAX_R) return (int)cudaErrorInvalidValue;
  *smem = WARPS * warp_smem(*R, W);
  return 0;
}

}  // namespace

extern "C" {

// The sizing pass on `stream`: wfa_size, then wfa_offsets.  off int64
// [B + 1] gets each pair's offset in the arena (in int16 cells) and the
// arena's cells in off[B]; done_s int32 [B] each pair's final score (-1:
// flagged).  Returns cudaGetLastError() after them (cudaErrorInvalidValue
// for a shape this build does not take).
int wfa_size_batch(const void* seq, const void* q_off, const void* t_off, const void* ns,
                   const void* ms, int B, int S, int W, int x, int o, int e, int min_wf_len,
                   int max_dist_diff, void* off, void* done_s, void* stream) {
  if (B <= 0) return 0;
  int R, G, smem;
  int err = forward_shape(S, W, x, o, e, &R, &G, &smem);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(wfa_size, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  wfa_size<<<(B + WARPS - 1) / WARPS, WARPS * 32, smem, st>>>(
      (const uint64_t*)seq, (const int64_t*)q_off, (const int64_t*)t_off, (const int32_t*)ns,
      (const int32_t*)ms, B, S, W, R, G, x, o, e, min_wf_len, max_dist_diff, (int64_t*)off,
      (int32_t*)done_s);
  err = (int)cudaGetLastError();
  if (err) return err;
  wfa_offsets<<<1, SCAN, 0, st>>>((int64_t*)off, B);
  return (int)cudaGetLastError();
}

// The write pass and the traceback on `stream`, after wfa_size_batch with
// the same pairs, off and done_s: hist int16 [off[B]] (the arena) and meta
// int2 [B, S] are the caller's scratch.  Returns as wfa_size_batch.
int wfa_align_batch(const void* seq, const void* q_off, const void* t_off, const void* ns,
                    const void* ms, int B, int S, int W, int CAP, int x, int o, int e,
                    int min_wf_len, int max_dist_diff, void* off, void* hist, void* meta,
                    void* done_s, void* ops, void* cnts, void* nops, void* stream) {
  if (B <= 0) return 0;
  int R, G, smem;
  int err = CAP < 1 ? (int)cudaErrorInvalidValue : forward_shape(S, W, x, o, e, &R, &G, &smem);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(wfa_forward, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
  if (err) return err;
  const bool few = B <= TB_FEW;
  const int tb_warps = few ? 1 : 4, tb_smem = few ? TB_SMEM_FEW : TB_SMEM_MANY;
  err = (int)cudaFuncSetAttribute(wfa_traceback, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  tb_warps * tb_smem);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  wfa_forward<<<(B + WARPS - 1) / WARPS, WARPS * 32, smem, st>>>(
      (const uint64_t*)seq, (const int64_t*)q_off, (const int64_t*)t_off, (const int32_t*)ns,
      (const int32_t*)ms, B, S, W, R, G, x, o, e, min_wf_len, max_dist_diff, (int64_t*)off,
      (int16_t*)hist, (int2*)meta, (int32_t*)done_s);
  err = (int)cudaGetLastError();
  if (err) return err;
  wfa_traceback<<<(B + tb_warps - 1) / tb_warps, tb_warps * 32, tb_warps * tb_smem, st>>>(
      (const int64_t*)off, (const int16_t*)hist, (const int2*)meta, (const int32_t*)done_s,
      (const int32_t*)ns, (const int32_t*)ms, B, S, CAP, x, o, e, tb_smem, (int8_t*)ops,
      (int32_t*)cnts, (int32_t*)nops);
  return (int)cudaGetLastError();
}

const char* wfa_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
