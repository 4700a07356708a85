// Native runtime kernels for lexicmap_tpu (host-side hot loops).
//
// These mirror the NumPy reference implementations exactly (the Python test
// suite cross-checks them):
//   - wfa_align:    ops/wfa.py       (gap-affine wavefront alignment)
//   - chain2_forward / chain3_chain: ops/chaining2.py
//   - chain1_forward:                ops/chaining.py (float32 semantics)
//   - clear_substr_pairs_mark:       ops/chaining.py (nested-anchor removal)
//
// Build: g++ -O3 -march=native -shared -fPIC core.cpp -o libcore.so
// Loaded via ctypes (lexicmap_tpu/native/__init__.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <set>
#include <ctime>
#include <algorithm>
#include <atomic>
#include <thread>
#include <numeric>

extern "C" {

// ---------------------------------------------------------------------------
// WFA (gap-affine, global) — see ops/wfa.py for the formulation.
// Returns the number of op chars written to ops_out ('M','X','I','D'),
// or -1 on failure / capacity overflow.

// cell values are furthest-reaching offsets (<= sequence length), so int32
// halves the wavefront-row memory traffic vs int64
typedef int32_t wfv_t;
static const wfv_t NEG = INT32_MIN / 4;

static inline int64_t extend_match(const uint8_t* q, const uint8_t* t,
                                   int64_t n, int64_t m, int64_t f, int64_t k) {
    int64_t i = f - k;
    // 8 bases per step via unaligned 64-bit loads; first differing byte via ctz
    while (f + 8 <= m && i + 8 <= n) {
        uint64_t a, b;
        std::memcpy(&a, q + i, 8);
        std::memcpy(&b, t + f, 8);
        uint64_t x = a ^ b;
        if (x) return f + (__builtin_ctzll(x) >> 3);
        f += 8; i += 8;
    }
    while (f < m && i < n && q[i] == t[f]) { ++f; ++i; }
    return f;
}

int64_t wfa_align(const uint8_t* q, int64_t n, const uint8_t* t, int64_t m,
                  int32_t x, int32_t o, int32_t e,
                  int32_t adaptive, int32_t min_wf_len, int32_t max_dist_diff,
                  uint8_t* ops_out, int64_t ops_cap) {
    if (n == 0 || m == 0) {
        int64_t w = 0;
        for (int64_t i = 0; i < n && w < ops_cap; ++i) ops_out[w++] = 'I';
        for (int64_t j = 0; j < m && w < ops_cap; ++j) ops_out[w++] = 'D';
        return w;
    }

    const int32_t k_end = (int32_t)(m - n);
    int64_t max_score =
        (int64_t)x * std::max(n, m) + 2 * ((int64_t)o + (int64_t)e * std::max(n, m)) + 10;

    // flat arena: per score (lo, width, offset); M/I/D rows contiguous.
    // tlo..thi (inclusive) are the EFFECTIVE bounds after adaptive pruning /
    // edge trimming: successor spans are computed from these so the wavefront
    // width tracks the surviving diagonals (O(s*width) instead of O(s^2));
    // storage keeps the full [lo, lo+width) row, with NEG outside tlo..thi.
    struct Meta { int32_t lo; int32_t width; int64_t off; int32_t tlo; int32_t thi; };
    std::vector<Meta> meta;
    meta.reserve(1024);
    // growable UNINITIALIZED arena: every M/I/D cell of a row is written by
    // the cell loop before it is ever read, so value-initialization
    // (vector::resize's NEG fill) would only double the memory traffic.
    // Row 0 is the one exception and is initialized explicitly below.
    struct Arena {
        wfv_t* p = nullptr;
        size_t sz = 0, cap = 0;
        ~Arena() { std::free(p); }
        int64_t grow(size_t cells) {
            if (sz + cells > cap) {
                cap = std::max(cap * 2, sz + cells + 1024);
                p = (wfv_t*)std::realloc(p, cap * sizeof(wfv_t));
            }
            int64_t off = (int64_t)sz;
            sz += cells;
            return off;
        }
        wfv_t* data() { return p; }
    } arena;

    auto alloc_wf = [&](int32_t lo, int32_t width) -> int64_t {
        (void)lo;
        return arena.grow((size_t)(3 * width));
    };
    auto getv = [&](int64_t s, int which, int32_t k) -> wfv_t {
        if (s < 0 || (size_t)s >= meta.size()) return NEG;
        const Meta& mt = meta[(size_t)s];
        if (mt.width <= 0) return NEG;
        int32_t idx = k - mt.lo;
        if (idx < 0 || idx >= mt.width) return NEG;
        return arena.data()[(size_t)(mt.off + which * mt.width + idx)];
    };

    {
        meta.push_back({0, 1, 0, 0, 0});
        int64_t off = alloc_wf(0, 1);
        arena.data()[(size_t)off] = (wfv_t)extend_match(q, t, n, m, 0, 0);  // M
        arena.data()[(size_t)off + 1] = NEG;  // I
        arena.data()[(size_t)off + 2] = NEG;  // D
    }

    int64_t s_final = -1;
    if (k_end == 0 && getv(0, 0, 0) >= m) s_final = 0;

    int64_t s = 0;
    while (s_final < 0 && s < max_score) {
        ++s;
        auto live = [&](int64_t ss) {
            return ss >= 0 && (size_t)ss < meta.size() && meta[(size_t)ss].width > 0 &&
                   meta[(size_t)ss].thi >= meta[(size_t)ss].tlo;
        };
        bool has_x = live(s - x);
        bool has_oe = live(s - o - e);
        bool has_e = live(s - e);
        if (!has_x && !has_oe && !has_e) { meta.push_back({0, 0, 0, 0, -1}); continue; }

        int32_t lo = INT32_MAX, hi = INT32_MIN;
        auto upd = [&](int64_t ss, int32_t dk) {
            const Meta& mt = meta[(size_t)ss];
            lo = std::min(lo, mt.tlo - dk);
            hi = std::max(hi, mt.thi + dk);
        };
        if (has_x) upd(s - x, 0);
        if (has_oe) upd(s - o - e, 1);
        if (has_e) upd(s - e, 1);
        int32_t width = hi - lo + 1;
        int64_t off = alloc_wf(lo, width);
        meta.push_back({lo, width, off, lo, hi});
        wfv_t* Mrow = arena.data() + off;
        wfv_t* Irow = Mrow + width;
        wfv_t* Drow = Irow + width;

        // hoist source-row views out of the cell loop
        struct View { const wfv_t* p; int32_t lo; int32_t w; };
        auto view = [&](int64_t ss, int which) -> View {
            const Meta& mt = meta[(size_t)ss];
            return {arena.data() + mt.off + (int64_t)which * mt.width, mt.lo, mt.width};
        };
        View vX{nullptr, 0, 0}, vOM{nullptr, 0, 0}, vEI{nullptr, 0, 0}, vED{nullptr, 0, 0};
        if (has_x) vX = view(s - x, 0);
        if (has_oe) vOM = view(s - o - e, 0);
        if (has_e) { vEI = view(s - e, 1); vED = view(s - e, 2); }
        auto rd = [](const View& v, int32_t k) -> wfv_t {
            // single unsigned compare; views with w==0 always miss
            uint32_t i = (uint32_t)(k - v.lo);
            return (i < (uint32_t)v.w) ? v.p[i] : NEG;
        };

        for (int32_t idx = 0; idx < width; ++idx) {
            int32_t k = lo + idx;
            wfv_t d_open = rd(vOM, k - 1);
            wfv_t d_ext = rd(vED, k - 1);
            wfv_t D = std::max(d_open, d_ext);
            if (D > NEG) D += 1;
            wfv_t i_open = rd(vOM, k + 1);
            wfv_t i_ext = rd(vEI, k + 1);
            wfv_t I = std::max(i_open, i_ext);
            wfv_t mis = rd(vX, k);
            if (mis > NEG) mis += 1;

            wfv_t M = std::max(std::max(mis, I), D);
            int64_t iv = (int64_t)M - k;
            if (!(M > NEG && M <= m && iv >= 0 && iv <= n)) M = NEG;
            if (!(I > NEG && I <= m && (I - k) >= 0 && (I - k) <= n)) I = NEG;
            if (!(D > NEG && D <= m && (D - k) >= 0 && (D - k) <= n)) D = NEG;
            if (M > NEG) M = (wfv_t)extend_match(q, t, n, m, M, k);
            Mrow[idx] = M;
            Irow[idx] = I;
            Drow[idx] = D;
        }

        if (adaptive) {
            int32_t cnt = 0;
            int64_t dmin = INT64_MAX;
            for (int32_t idx = 0; idx < width; ++idx) {
                if (Mrow[idx] > NEG) {
                    ++cnt;
                    int64_t f = Mrow[idx];
                    int64_t dist = (m - f) + (n - (f - (lo + idx)));
                    dmin = std::min(dmin, dist);
                }
            }
            if (cnt >= min_wf_len) {
                for (int32_t idx = 0; idx < width; ++idx) {
                    if (Mrow[idx] > NEG) {
                        int64_t f = Mrow[idx];
                        int64_t dist = (m - f) + (n - (f - (lo + idx)));
                        if (dist - dmin > max_dist_diff) {
                            Mrow[idx] = NEG; Irow[idx] = NEG; Drow[idx] = NEG;
                        }
                    }
                }
            }
        }

        // trim NEG edges so successor spans follow the surviving diagonals
        {
            int32_t t0 = 0, t1 = width - 1;
            while (t0 < width && Mrow[t0] == NEG && Irow[t0] == NEG && Drow[t0] == NEG) ++t0;
            while (t1 >= t0 && Mrow[t1] == NEG && Irow[t1] == NEG && Drow[t1] == NEG) --t1;
            meta.back().tlo = lo + t0;
            meta.back().thi = lo + t1;  // thi < tlo => dead wavefront
        }

        if (k_end >= lo && k_end <= hi && Mrow[k_end - lo] >= m) s_final = s;
    }
    if (s_final < 0) return -1;

    // ---- traceback (pref X > D > I on M-ties; gap-open before extend) ----
    std::vector<uint8_t> rev;
    rev.reserve((size_t)(n + m));
    int64_t f = m;
    int32_t k = k_end;
    int64_t sc = s_final;
    char state = 'M';
    while (true) {
        if (state == 'M') {
            if (sc == 0) {
                for (int64_t z = 0; z < f; ++z) rev.push_back('M');
                break;
            }
            int64_t mis = getv(sc - x, 0, k);
            if (mis > NEG) mis += 1;
            int64_t ins = getv(sc, 1, k);
            int64_t del = getv(sc, 2, k);
            int64_t f_pred = std::max(std::max(mis, ins), del);
            if (f_pred <= NEG + 2) return -1;
            for (int64_t z = 0; z < f - f_pred; ++z) rev.push_back('M');
            f = f_pred;
            if (mis == f_pred) {
                rev.push_back('X');
                sc -= x;
                f -= 1;
            } else if (del == f_pred) {
                state = 'D';
            } else {
                state = 'I';
            }
        } else if (state == 'I') {
            int64_t op_val = getv(sc - o - e, 0, k + 1);
            int64_t ext_val = getv(sc - e, 1, k + 1);
            rev.push_back('I');
            char kind;
            if (op_val == f) kind = 'o';
            else if (ext_val == f) kind = 'e';
            else return -1;
            k += 1;
            if (kind == 'e') { sc -= e; }
            else { sc -= o + e; state = 'M'; }
        } else {
            int64_t op_val = getv(sc - o - e, 0, k - 1);
            int64_t ext_val = getv(sc - e, 2, k - 1);
            rev.push_back('D');
            char kind;
            if (op_val == f - 1) kind = 'o';
            else if (ext_val == f - 1) kind = 'e';
            else return -1;
            k -= 1;
            f -= 1;
            if (kind == 'e') { sc -= e; }
            else { sc -= o + e; state = 'M'; }
        }
    }
    int64_t w = (int64_t)rev.size();
    if (w > ops_cap) return -1;
    for (int64_t i2 = 0; i2 < w; ++i2) ops_out[i2] = rev[w - 1 - i2];
    return w;
}

// WFA + alignment statistics in one call: after aligning, a single pass over
// the raw op bytes computes everything ops/align.py's trim_ops + _finalize +
// score_and_evalue derive from the RLE tuples (ref: trimOps
// lib-index-search-util.go:238-257, scoreAndEvalue :259-303 with BLAST
// match 2 / mismatch -3 / gapOpen 5 / gapExt 2).
// stats[10]: [n_ops, align_len, matches, mismatches, gaps,
//             qbegin(1-based), qend, tbegin(1-based), tend, raw_score];
// align_len == 0 means no match run (empty trimmed region).
// trimmed-alignment stats from a per-base op stream (M/X/I/D); shared by the
// host WFA and the injected device-WFA path of align_paths
void ops_to_stats(const uint8_t* ops_out, int64_t w, int64_t* stats) {
    for (int i = 0; i < 10; ++i) stats[i] = 0;
    stats[0] = w;
    int64_t first_m = -1, last_m = -1;
    for (int64_t i = 0; i < w; ++i)
        if (ops_out[i] == 'M') { if (first_m < 0) first_m = i; last_m = i; }
    if (first_m < 0) return;
    int64_t qpos = 0, tpos = 0, qpre = 0, tpre = 0, qend = 0, tend = 0;
    int64_t matches = 0, mism = 0, gaps = 0, score = 0;
    uint8_t prev = 0;
    for (int64_t i = 0; i < w; ++i) {
        uint8_t op = ops_out[i];
        if (i == first_m) { qpre = qpos; tpre = tpos; }
        if (i >= first_m && i <= last_m) {
            if (op == 'M') { ++matches; score += 2; }
            else if (op == 'X') { ++mism; score -= 3; }
            else { ++gaps; score -= 2; if (op != prev) score -= 5; }
        }
        if (op == 'M' || op == 'X' || op == 'I') ++qpos;
        if (op == 'M' || op == 'X' || op == 'D') ++tpos;
        if (i == last_m) { qend = qpos; tend = tpos; }
        prev = op;
    }
    stats[1] = last_m - first_m + 1;
    stats[2] = matches; stats[3] = mism; stats[4] = gaps;
    stats[5] = qpre + 1; stats[6] = qend;
    stats[7] = tpre + 1; stats[8] = tend;
    stats[9] = score;
}

int64_t wfa_align_stats(const uint8_t* q, int64_t n, const uint8_t* t, int64_t m,
                        int32_t x, int32_t o, int32_t e,
                        int32_t adaptive, int32_t min_wf_len, int32_t max_dist_diff,
                        uint8_t* ops_out, int64_t ops_cap, int64_t* stats) {
    int64_t w = wfa_align(q, n, t, m, x, o, e, adaptive, min_wf_len,
                          max_dist_diff, ops_out, ops_cap);
    if (w < 0) {
        for (int i = 0; i < 10; ++i) stats[i] = 0;
        return w;
    }
    ops_to_stats(ops_out, w, stats);
    return w;
}

// ---------------------------------------------------------------------------
// Chainer2 forward pass (ref: lib-chaining2.go:222-307; ops/chaining2.py)

// scan-length statistics (diagnostic; fetched/reset by get_chain2_scan_stats).
// chain2_forward runs concurrently from multiple threads, so the counters
// are atomics (relaxed: they are diagnostics, not synchronization).
static std::atomic<int64_t> g_c2_scan_total{0}, g_c2_scan_max{0}, g_c2_scan_n{0};
extern "C" void get_chain2_scan_stats(int64_t* out);
void get_chain2_scan_stats(int64_t* out) {
    out[0] = g_c2_scan_total.exchange(0, std::memory_order_relaxed);
    out[1] = g_c2_scan_max.exchange(0, std::memory_order_relaxed);
    out[2] = g_c2_scan_n.exchange(0, std::memory_order_relaxed);
}

void chain2_forward(const int64_t* qb, const int64_t* tb, const int64_t* ln,
                    int64_t n, int32_t band_base, int32_t band_count,
                    double max_gap, double* max_scores, int64_t* prev_idx) {
    // all quantities are integers (score = sum of lengths minus gaps), so the
    // DP runs in int64 — values and comparisons are identical to the double
    // formulation for any realistic magnitudes
    static thread_local std::vector<int32_t> cq, ct, cl;
    static thread_local std::vector<int64_t> msi, msl;
    cq.resize((size_t)n); ct.resize((size_t)n); cl.resize((size_t)n);
    msi.resize((size_t)n); msl.resize((size_t)n);
    for (int64_t j = 0; j < n; ++j) {
        cq[(size_t)j] = (int32_t)qb[j];
        ct[(size_t)j] = (int32_t)tb[j];
        cl[(size_t)j] = (int32_t)ln[j];
    }
    // CLI max_gap is integral; the int compare g > mg matches (double)g > max_gap
    const int64_t mg = (int64_t)max_gap;
    msi[0] = ln[0];
    msl[0] = 2 * ln[0];
    max_scores[0] = (double)ln[0];
    prev_idx[0] = 0;
    int32_t max_ln = 0;
    for (int64_t j = 0; j < n; ++j) max_ln = std::max(max_ln, cl[(size_t)j]);
    for (int64_t i = 1; i < n; ++i) {
        const int32_t aq = cq[(size_t)i], at = ct[(size_t)i];
        // pre-break threshold: aq - qb[j] - max_ln > band_base  <=>  qb[j] < thr
        const int32_t thr = aq - max_ln - band_base;
        int64_t m = cl[(size_t)i];
        int64_t mj = i;
        int64_t bcount = 0;
        int64_t j;
        for (j = i - 1; j >= 0; --j) {
            const int32_t bq2 = cq[(size_t)j];
            // monotone early exit: qb ascending, so once the band test must
            // fail for every remaining non-skipped anchor the scan is decided
            if (bcount >= band_count && bq2 < thr) break;
            const int32_t bt2 = ct[(size_t)j];
            if (bq2 == aq || bt2 > at) continue;
            ++bcount;
            const int32_t blj = cl[(size_t)j];
            if (aq - bq2 - blj > band_base && bcount > band_count) break;
            const int64_t qd = aq - bq2;  // > 0: sorted, equal skipped
            const int64_t td = at - bt2;  // >= 0: bt2 <= at
            const int64_t g = qd > td ? qd - td : td - qd;
            if (g > mg) continue;
            const int64_t sc = msl[(size_t)j] - g;
            if (sc >= m) { m = sc; mj = j; }
        }
        msi[(size_t)i] = m;
        msl[(size_t)i] = m + cl[(size_t)i];
        max_scores[i] = (double)m;
        prev_idx[i] = mj;
        int64_t scanned = i - 1 - j;  // entries examined before the break
        g_c2_scan_total.fetch_add(scanned, std::memory_order_relaxed);
        int64_t prev_max = g_c2_scan_max.load(std::memory_order_relaxed);
        while (scanned > prev_max &&
               !g_c2_scan_max.compare_exchange_weak(prev_max, scanned,
                                                    std::memory_order_relaxed)) {}
        g_c2_scan_n.fetch_add(1, std::memory_order_relaxed);
    }
}

// ---------------------------------------------------------------------------
// Phase-1 Chainer forward pass with float32 semantics
// (ref: lib-chaining.go:339-474; ops/chaining.py)

static inline float seed_weight_f(float l) { return 0.1f * l * l; }

static inline float gap_score_f(float g) {
    if (g == 0.0f) return 0.0f;
    return 0.1f * g + 0.5f * (float)std::log2((double)g);
}

void chain1_forward(const int32_t* qb, const int32_t* tb, const int32_t* ln,
                    int64_t n, float max_gap, float min_score, int32_t max_dist,
                    float* max_scores, int64_t* prev_idx, int8_t* directions) {
    max_scores[0] = seed_weight_f((float)ln[0]);
    prev_idx[0] = 0;
    directions[0] = 0;
    for (int64_t i = 1; i < n; ++i) {
        int32_t aq = qb[i], at = tb[i], al = ln[i];
        float m = seed_weight_f((float)al);
        int64_t mj = i;
        int8_t mdir = 0;
        for (int64_t j = i - 1; j >= 0; --j) {
            int32_t bq2 = qb[j], bt2 = tb[j], bl2 = ln[j];
            int64_t qd = aq - bq2;
            if (qd > max_dist) break;  // sorted by QBegin: done
            if (qd == 0) continue;
            int64_t td = (int64_t)at - bt2;
            int64_t atd = td < 0 ? -td : td;
            if (atd > max_dist || td == 0) continue;
            // gap (direction dependent)
            double g64;
            if (at >= bt2) {
                g64 = std::fabs(std::fabs((double)qd) - std::fabs((double)td));
            } else {
                double alt = std::fabs((double)(at + al) - (double)(bt2 + bl2));
                g64 = std::fabs(std::fabs((double)qd) - alt);
            }
            float g = (float)g64;
            if (g > max_gap) continue;
            int64_t bqe = bq2 + bl2;
            float w;
            if (aq > bqe) {
                w = seed_weight_f((float)al);
            } else if (g == 0.0f) {
                int64_t length = (int64_t)aq + al - bq2;
                w = -seed_weight_f((float)bl2) + seed_weight_f((float)length);
            } else {
                int64_t length = (int64_t)aq + al - bqe;
                w = seed_weight_f((float)length);
            }
            int8_t dir = at >= bt2 ? 1 : -1;
            float base;
            if (directions[j] == 0 || directions[j] == dir) base = max_scores[j];
            else base = seed_weight_f((float)bl2);
            float sc = (base + w) - gap_score_f(g);
            if (sc >= min_score && sc > m) { m = sc; mj = j; mdir = dir; }
        }
        max_scores[i] = m;
        prev_idx[i] = mj;
        directions[i] = mdir;
    }
}

// ---------------------------------------------------------------------------
// ClearSubstrPairs nested-anchor marking (input sorted by QBegin asc,
// QEnd desc, TBegin asc; ref: lib-index-search.go:890-935)

void clear_substr_pairs_mark(const int32_t* qb, const int32_t* tb,
                             const int32_t* ln, int64_t n, int32_t k,
                             uint8_t* drop) {
    std::memset(drop, 0, (size_t)n);
    for (int64_t i = 1; i < n; ++i) {
        int32_t vqe = qb[i] + ln[i];
        int32_t upbound = vqe - k;
        if (upbound < 0) upbound = 0;
        int32_t vtb = tb[i];
        int32_t vte = tb[i] + ln[i];
        // binary search first j with qb[j] >= upbound
        int64_t lo = 0, hi = i + 1;
        while (lo < hi) {
            int64_t mid = (lo + hi) >> 1;
            if (qb[mid] < upbound) lo = mid + 1; else hi = mid;
        }
        for (int64_t j = lo; j < i; ++j) {
            if (vqe <= qb[j] + ln[j] && vtb >= tb[j] && vte <= tb[j] + ln[j]) {
                drop[i] = 1;
                break;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Chainer3 (2-mer chains for extendMatch; ref: lib-chaining3.go:111-299)
// Returns 1 and sets (*qe, *te) on success, else 0.

int32_t chain3_chain(const int32_t* qb, const int32_t* tb, const int32_t* ln,
                     int64_t n, int32_t max_gap, int32_t min_score,
                     int32_t min_align_len, int32_t max_distance,
                     int32_t band_count, int32_t band_base,
                     int32_t* out_qe, int32_t* out_te) {
    if (n == 0) return 0;
    std::vector<double> ms((size_t)n);
    std::vector<int64_t> pv((size_t)n);
    double M = 0.0;
    int64_t Mi = 0;
    {
        double d = std::max(std::abs((double)qb[0]), std::abs((double)tb[0]));
        double g = std::fabs(std::fabs((double)qb[0]) - std::fabs((double)tb[0]));
        ms[0] = (double)ln[0] - d - g;
        pv[0] = 0;
        if (ms[0] > M) { M = ms[0]; Mi = 0; }
    }
    for (int64_t i = 1; i < n; ++i) {
        int32_t aq = qb[i], at = tb[i], al = ln[i];
        double d0 = std::max(std::abs((double)aq), std::abs((double)at));
        double g0 = std::fabs(std::fabs((double)aq) - std::fabs((double)at));
        double m = (double)al - d0 - g0;
        int64_t mj = i;
        int64_t bcount = 0;
        for (int64_t j = i - 1; j >= 0; --j) {
            int32_t bq2 = qb[j], bt2 = tb[j], bl2 = ln[j];
            if (bq2 == aq || bt2 > at) continue;
            ++bcount;
            int64_t bbase = (int64_t)aq - bq2 - bl2;
            if (!(bbase <= band_base || bcount <= band_count)) break;
            int64_t qd = std::abs((int64_t)aq - bq2);
            int64_t td = std::abs((int64_t)at - bt2);
            int64_t dd = std::max(qd, td);
            if (dd > max_distance) continue;
            int64_t gg = std::abs(qd - td);
            if (gg > max_gap) continue;
            double sc = ms[j] + (double)bl2 - (double)dd - (double)gg;
            if (sc >= m) { m = sc; mj = j; }
        }
        ms[i] = m;
        pv[i] = mj;
        if (m > M) { M = m; Mi = i; }
    }
    if (M < (double)min_score) return 0;

    int64_t i = Mi;
    int64_t qb_b = INT64_MAX, tb_b = INT64_MAX;
    int64_t qe = -1, te = -1;
    bool first = true;
    int64_t n_matched = 0;
    int64_t begin_next = 0;
    while (true) {
        int64_t j = pv[i];
        if (j < 0) break;
        if (first) {
            first = false;
            qe = (int64_t)qb[i] + ln[i] - 1;
            te = (int64_t)tb[i] + ln[i] - 1;
            qb_b = qb[i]; tb_b = tb[i];
            n_matched += ln[i];
        } else {
            qb_b = qb[i]; tb_b = tb[i];
            if ((int64_t)qb[i] + ln[i] - 1 >= begin_next) n_matched += begin_next - qb[i];
            else n_matched += ln[i];
        }
        begin_next = qb[i];
        if (i == j) {
            if (first) break;
            int64_t naq = qe - qb_b + 1;
            if (naq < min_align_len) return 0;
            int64_t nat = te - tb_b + 1;
            double pident = (double)n_matched / (double)std::max(naq, nat) * 100.0;
            if (pident < 15.0) return 0;
            *out_qe = (int32_t)qe;
            *out_te = (int32_t)te;
            return 1;
        }
        i = j;
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Genome seeding: LexicHash capture + desert filling (build-side hot path;
// mirrors ops/masking.py capture() and index/build.py fill_deserts()).

extern "C" {

static inline bool dust_scalar(uint64_t x, int k) {
    uint8_t counts[64] = {0};
    int score = 0;
    for (int i = 0; i <= k - 2; ++i) {
        uint8_t t = (x >> (2 * i)) & 63;
        score += counts[t];
        if (score > 50) return true;
        counts[t]++;
    }
    return false;
}

// XOR-argmin range over a sorted array: returns [lo, hi) of winner k-mers.
static inline void xor_argmin_range(const uint64_t* sk, int64_t n, uint64_t mask,
                                    int bits, int64_t* out_lo, int64_t* out_hi) {
    int64_t lo = 0, hi = n;
    uint64_t prefix = 0;
    for (int bit = bits - 1; bit >= 0; --bit) {
        uint64_t b = 1ULL << bit;
        uint64_t mid_val = prefix | b;
        // binary search for mid_val in sk[lo:hi]
        int64_t l = lo, h = hi;
        while (l < h) {
            int64_t m = (l + h) >> 1;
            if (sk[m] < mid_val) l = m + 1; else h = m;
        }
        int64_t split = l;
        bool desired = (mask & b) != 0;
        bool has0 = split > lo;
        bool has1 = hi > split;
        bool go1 = desired ? has1 : !has0;
        if (go1) { lo = split; prefix |= b; }
        else { hi = split; }
    }
    *out_lo = lo;
    *out_hi = hi;
}

// All-masks XOR-argmin by simultaneous trie co-descent.  masks and sk are
// both sorted; ranges passed down a level always share their prefix above
// `bit`, so a range splits at the partition point of that bit.  Shared mask
// prefixes descend the candidate trie once instead of once per mask:
// O((m + nc) * bits) total instead of m independent descents.  Semantics are
// identical to per-mask xor_argmin_range (equal-value winner ranges).
static void xor_argmin_all(const uint64_t* masks, int64_t mlo, int64_t mhi,
                           const uint64_t* sk, int64_t clo, int64_t chi,
                           int bit, int64_t* out_lo, int64_t* out_hi) {
    while (true) {
        if (mlo >= mhi) return;
        // all remaining candidates equal -> outcome fixed for every mask
        if (bit < 0 || sk[clo] == sk[chi - 1]) {
            for (int64_t j = mlo; j < mhi; ++j) { out_lo[j] = clo; out_hi[j] = chi; }
            return;
        }
        uint64_t b = 1ULL << bit;
        // partition point: first element with `bit` set (ranges share upper bits)
        auto split_at = [b](const uint64_t* a, int64_t lo, int64_t hi) {
            while (lo < hi) {
                int64_t mid = (lo + hi) >> 1;
                if (a[mid] & b) hi = mid; else lo = mid + 1;
            }
            return lo;
        };
        int64_t ms = split_at(masks, mlo, mhi);
        int64_t cs = split_at(sk, clo, chi);
        --bit;
        if (ms == mhi) {         // all masks in 0-branch: tail-iterate
            if (cs > clo) { chi = cs; } else { clo = cs; }
            continue;
        }
        if (ms == mlo) {         // all masks in 1-branch
            if (chi > cs) { clo = cs; } else { chi = cs; }
            continue;
        }
        xor_argmin_all(masks, mlo, ms, sk,
                       (cs > clo) ? clo : cs, (cs > clo) ? cs : chi,
                       bit, out_lo, out_hi);
        if (chi > cs) { mlo = ms; clo = cs; }
        else { mlo = ms; chi = cs; }
    }
}

// capture_native sorts candidate (kmer, loc) pairs and captures per mask.
// Inputs: fwd/rc [n] packed k-mers; exclude [n] (0/1, may be NULL);
// masks [m] sorted.  Outputs: out_kmers [m] (0 = none), out_counts [m],
// out_pos flat positions (loc<<1|strand sorted per mask), cap limits it.
// check_shorter: 1 -> global argmin; 0 -> require lcp >= prefix_len.
// Returns total positions written, or -1 if cap exceeded, -2 if no candidates.
int64_t capture_native(const uint64_t* fwd, const uint64_t* rc, int64_t n,
                       const uint8_t* exclude, const uint64_t* masks, int64_t m,
                       int32_t k, int32_t prefix_len, int32_t check_shorter,
                       uint64_t* out_kmers, int64_t* out_counts,
                       uint32_t* out_pos, int64_t cap) {
    // gather candidate (k-mer, pos<<1|strand) pairs as parallel arrays
    std::vector<uint64_t> ka;
    std::vector<uint32_t> va;
    ka.reserve((size_t)(2 * n));
    va.reserve((size_t)(2 * n));
    for (int64_t i = 0; i < n; ++i) {
        if (exclude && exclude[i]) continue;
        ka.push_back(fwd[i]); va.push_back((uint32_t)(i << 1));
        ka.push_back(rc[i]); va.push_back((uint32_t)(i << 1 | 1));
    }
    if (ka.empty()) return -2;
    int64_t nc = (int64_t)ka.size();
    // stable LSD radix sort by k-mer, 16-bit digits (per-mask positions are
    // re-sorted below, so only the key order matters; ~3x over std::sort on
    // ~10M pairs)
    {
        std::vector<uint64_t> kb((size_t)nc);
        std::vector<uint32_t> vb((size_t)nc);
        const int passes = (2 * k + 15) / 16;
        std::vector<int64_t> cnt(65536);
        for (int p = 0; p < passes; ++p) {
            int shift = 16 * p;
            std::fill(cnt.begin(), cnt.end(), 0);
            for (int64_t i = 0; i < nc; ++i) ++cnt[(ka[(size_t)i] >> shift) & 0xffff];
            int64_t acc = 0;
            for (int d = 0; d < 65536; ++d) { int64_t c = cnt[d]; cnt[d] = acc; acc += c; }
            for (int64_t i = 0; i < nc; ++i) {
                int64_t dst = cnt[(ka[(size_t)i] >> shift) & 0xffff]++;
                kb[(size_t)dst] = ka[(size_t)i];
                vb[(size_t)dst] = va[(size_t)i];
            }
            ka.swap(kb);
            va.swap(vb);
        }
    }
    const std::vector<uint64_t>& sk = ka;

    int bits = 2 * k;
    std::vector<int64_t> win_lo((size_t)m), win_hi((size_t)m);
    xor_argmin_all(masks, 0, m, sk.data(), 0, nc, bits - 1,
                   win_lo.data(), win_hi.data());
    int64_t w = 0;
    for (int64_t j = 0; j < m; ++j) {
        int64_t lo = win_lo[(size_t)j], hi = win_hi[(size_t)j];
        uint64_t winner = sk[lo];
        if (!check_shorter) {
            // require shared prefix >= prefix_len
            uint64_t x = winner ^ masks[j];
            int lcp;
            if (x == 0) lcp = k;
            else {
                int bl = 64 - __builtin_clzll(x);
                lcp = (64 - bl) / 2 + (k - 32);
            }
            if (lcp < prefix_len) {
                out_kmers[j] = 0;
                out_counts[j] = 0;
                continue;
            }
        }
        int64_t cnt = hi - lo;
        if (w + cnt > cap) return -1;
        out_kmers[j] = winner;
        out_counts[j] = cnt;
        for (int64_t t = lo; t < hi; ++t) out_pos[w++] = va[(size_t)t];
        std::sort(out_pos + (w - cnt), out_pos + w);
    }
    return w;
}

// fill_deserts_native mirrors index/build.py fill_deserts():
// scans sorted seed locations; for every gap >= max_desert, re-masks the
// +-1000 bp window (prefix-restricted capture semantics) and picks a
// capturable k-mer roughly every seed_dist bases.
// Outputs triplets (mask_idx, kmer, loc) in out_*; returns count or -1.
int64_t fill_deserts_native(
    const uint64_t* fwd, const uint64_t* rc, int64_t nk,
    const uint32_t* locs, int64_t nlocs,
    const uint8_t* interval_excluded, int64_t n_excl,
    const uint64_t* masks, int64_t m,
    int32_t k, int32_t prefix_len,
    int32_t max_desert, int32_t seed_dist, int32_t seed_pos_r,
    int64_t* out_mask, uint64_t* out_kmer, int64_t* out_loc, int64_t cap,
    int32_t flags) {
    // flags bit0: EXCLUDE interval/gap-region k-mers from the window
    //   competition (the reference does NOT: its regional re-mask passes
    //   skipRegions=nil, ref: lib-index-build.go:1196, and junctions are
    //   'A'-filled, ref: lib-index-build.go:924, so junction k-mers compete
    //   for capture there; they are only skipped at selection time via the
    //   interval tree).  0 = reference behavior.
    // flags bit1: DISTINCT-prefix candidacy (lexichash
    //   MaskKnownDistinctPrefixes semantics): a k-mer is a candidate for
    //   mask m iff it shares m's *distinct* prefix — the shortest prefix
    //   unique to m among all masks (7 or 8 bases for the default 20k set)
    //   — and wins the XOR-argmin within that variable-length bucket.
    //   Without the bit, candidacy uses the global prefix_len for every
    //   mask (a k-mer then needs a full prefix_len match).
    if (nk <= 0) return 0;
    int64_t L = nk + k - 1;
    uint64_t ccc = 0, ggg = 0, ttt = 0;
    for (int i = 0; i < k; ++i) {
        ccc = (ccc << 2) | 1ULL;
        ggg = (ggg << 2) | 2ULL;
        ttt = (ttt << 2) | 3ULL;
    }

    // prefix_len here is the mask set's DISTINCT prefix length (unique per
    // mask; ref: lexichash MaskKnownDistinctPrefixes(_, _, false)).  It can
    // be large for text-loaded sets, so use binary search over the sorted
    // masks / window k-mers instead of 4^L tables.
    int shift = 2 * (k - prefix_len);
    std::vector<uint64_t> mask_prefs((size_t)m);
    for (int64_t j = 0; j < m; ++j) mask_prefs[(size_t)j] = masks[j] >> shift;

    // distinct-prefix mode (flags bit1): per-mask shortest-unique prefix
    // lengths, from LCPs with sorted neighbors (masks are sorted).
    bool distinct_mode = (flags & 2) != 0;
    // group-prefix mode (flags bit2): candidacy routes by the mask
    // GENERATION prefix length p (max p with 4^p <= m; 7 for the default
    // 20k set, one level shorter than the distinct length) and a k-mer is
    // capturable iff it is the XOR-argmin for ANY mask sharing that
    // p-prefix (a duplicated-prefix pair both compete).  This models the
    // lexichash candidate-mask routing (cf. MaskKmer, used by the
    // reference's reversed-seed pass, lib-index-build.go:813) applied to
    // the window re-mask.
    bool group_mode = (flags & 4) != 0;
    int group_len = 0;
    if (group_mode) {
        while ((1LL << (2 * (group_len + 1))) <= m) ++group_len;
        if (group_len < 1) group_len = 1;
        if (group_len > prefix_len) group_len = prefix_len;
    }
    std::vector<int32_t> dlen;
    std::vector<int32_t> dlen_values;  // unique lengths, ascending
    if (distinct_mode) {
        dlen.resize((size_t)m);
        auto lcp2 = [&](uint64_t a, uint64_t b) -> int32_t {
            uint64_t v = a ^ b;
            if (v == 0) return k;
            int bl = 64 - __builtin_clzll(v);
            return (int32_t)((2 * k - bl) / 2);
        };
        for (int64_t j = 0; j < m; ++j) {
            int32_t nb = 0;
            if (j > 0) nb = std::max(nb, lcp2(masks[j - 1], masks[j]));
            if (j + 1 < m) nb = std::max(nb, lcp2(masks[j], masks[j + 1]));
            int32_t L = nb + 1;
            if (L > k) L = k;
            dlen[(size_t)j] = L;
        }
        dlen_values.assign(dlen.begin(), dlen.end());
        std::sort(dlen_values.begin(), dlen_values.end());
        dlen_values.erase(std::unique(dlen_values.begin(), dlen_values.end()),
                          dlen_values.end());
    }

    int64_t n_out = 0;
    int64_t pre = 0;
    std::vector<uint64_t> wk;  // sorted window k-mers (both strands)

    for (int64_t li = 0; li <= nlocs; ++li) {
        int64_t pos = (li < nlocs) ? (int64_t)(locs[li] >> 1) : (L - k);
        int64_t d = pos - pre;
        if (d < max_desert) { pre = pos; continue; }

        int64_t start = pre - 1000;
        int64_t pos_of_pre = 1000;
        if (start < 0) { pos_of_pre += start; start = 0; }
        int64_t end = pos + 1000 + k;
        if (end > L) end = L;
        int64_t nw = end - start - k + 1;
        if (nw <= 0) { pre = pos; continue; }
        int64_t pos_of_cur = pos_of_pre + d;

        // sorted window k-mers: each distinct-prefix bucket is a contiguous
        // range found by binary search.  K-mers at interval/gap positions
        // compete for capture like in the reference (regional re-mask with
        // skipRegions=nil over the 'A'-filled concatenation); they are only
        // skipped at selection time (pos_ok below).
        bool excl_in_window = (flags & 1) != 0;
        wk.clear();
        wk.reserve((size_t)(2 * nw));
        for (int64_t i = 0; i < nw; ++i) {
            int64_t gp = start + i;
            if (excl_in_window && interval_excluded && gp < n_excl &&
                interval_excluded[gp]) continue;
            wk.push_back(fwd[gp]);
            wk.push_back(rc[gp]);
        }
        std::sort(wk.begin(), wk.end());

        // Is x the XOR-argmin for mask j among window k-mers sharing the
        // length-L prefix of mask j?
        auto wins_bucket = [&](uint64_t x, int64_t j, int L) -> bool {
            int sh = 2 * (k - L);
            uint64_t pref = masks[j] >> sh;
            uint64_t lo_val = pref << sh;
            uint64_t hi_val = lo_val | ((sh >= 64) ? ~0ULL : ((1ULL << sh) - 1));
            int64_t bl = std::lower_bound(wk.begin(), wk.end(), lo_val) - wk.begin();
            int64_t bh = std::upper_bound(wk.begin(), wk.end(), hi_val) - wk.begin();
            uint64_t mk = masks[j];
            uint64_t bestx = ~0ULL;
            uint64_t winner = 0;
            for (int64_t t = bl; t < bh; ++t) {
                uint64_t xv = wk[(size_t)t] ^ mk;
                if (xv < bestx) { bestx = xv; winner = wk[(size_t)t]; }
            }
            return winner == x;
        };

        auto capturing_mask = [&](uint64_t x) -> int64_t {
            if (distinct_mode) {
                // at most one mask's distinct prefix can match x
                for (int32_t L : dlen_values) {
                    int sh = 2 * (k - L);
                    uint64_t xp = x >> sh;
                    // masks sorted by value => sorted by L-prefix
                    auto cmp_lo = [&](uint64_t mv, uint64_t p) { return (mv >> sh) < p; };
                    auto cmp_hi = [&](uint64_t p, uint64_t mv) { return p < (mv >> sh); };
                    int64_t mlo = std::lower_bound(masks, masks + m, xp, cmp_lo) - masks;
                    int64_t mhi = std::upper_bound(masks, masks + m, xp, cmp_hi) - masks;
                    for (int64_t j = mhi - 1; j >= mlo; --j) {
                        if (dlen[(size_t)j] != L) continue;
                        if (wins_bucket(x, j, L)) return j;
                    }
                }
                return -1;
            }
            if (group_mode) {
                int sh = 2 * (k - group_len);
                uint64_t xp = x >> sh;
                auto cmp_lo = [&](uint64_t mv, uint64_t p) { return (mv >> sh) < p; };
                auto cmp_hi = [&](uint64_t p, uint64_t mv) { return p < (mv >> sh); };
                int64_t mlo = std::lower_bound(masks, masks + m, xp, cmp_lo) - masks;
                int64_t mhi = std::upper_bound(masks, masks + m, xp, cmp_hi) - masks;
                for (int64_t j = mhi - 1; j >= mlo; --j) {  // highest mask wins
                    if (wins_bucket(x, j, group_len)) return j;
                }
                return -1;
            }
            uint64_t pref = x >> shift;
            auto mr = std::equal_range(mask_prefs.begin(), mask_prefs.end(), pref);
            int64_t mlo = mr.first - mask_prefs.begin();
            int64_t mhi = mr.second - mask_prefs.begin();
            if (mhi <= mlo) return -1;
            int64_t best = -1;
            for (int64_t j = mhi - 1; j >= mlo; --j) {  // highest mask wins
                if (wins_bucket(x, j, prefix_len)) { best = j; break; }
            }
            return best;
        };

        auto kmer_ok = [&](uint64_t x) -> bool {
            if (x == 0 || x == ccc || x == ggg || x == ttt) return false;
            return !dust_scalar(x, k);
        };

        auto pos_ok = [&](int64_t gp) -> bool {
            if (gp >= nk) return false;
            if (interval_excluded && gp < n_excl && interval_excluded[gp]) return false;
            return true;
        };

        auto try_pos = [&](int64_t j, int64_t* im, uint64_t* kv, int64_t* lv) -> bool {
            int64_t gp = start + j;
            if (j >= nw || !pos_ok(gp)) return false;
            uint64_t xf = fwd[gp];
            if (kmer_ok(xf)) {
                int64_t mm = capturing_mask(xf);
                if (mm >= 0) { *im = mm; *kv = xf; *lv = gp << 1; return true; }
            }
            uint64_t xr = rc[gp];
            if (kmer_ok(xr)) {
                int64_t mm = capturing_mask(xr);
                if (mm >= 0) { *im = mm; *kv = xr; *lv = (gp << 1) | 1; return true; }
            }
            return false;
        };

        int64_t j = pos_of_pre + seed_dist;
        while (j < pos_of_cur) {
            int64_t jstart = j + 1;
            int64_t end_up = j - seed_pos_r;
            int64_t im; uint64_t kv; int64_t lv;
            bool hit = false;
            while (j > end_up) {
                if (try_pos(j, &im, &kv, &lv)) { hit = true; break; }
                --j;
            }
            if (hit) {
                if (n_out >= cap) return -1;
                out_mask[n_out] = im; out_kmer[n_out] = kv; out_loc[n_out] = lv;
                ++n_out;
                j += seed_dist;
                continue;
            }
            if (jstart >= pos_of_cur) break;
            int64_t end_dn = jstart + seed_pos_r;
            if (end_dn > pos_of_cur - 1) end_dn = pos_of_cur - 1;
            j = jstart;
            while (j < end_dn) {
                if (try_pos(j, &im, &kv, &lv)) { hit = true; break; }
                ++j;
            }
            if (hit) {
                if (n_out >= cap) return -1;
                out_mask[n_out] = im; out_kmer[n_out] = kv; out_loc[n_out] = lv;
                ++n_out;
            }
            j += seed_dist;
        }
        pre = pos;
    }
    return n_out;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Chainer2 backtrack with region splitting (mirrors ops/chaining2.py
// _chain_a_region).  Emits chains as 9-tuples into flat arrays.

extern "C" {

struct C2Params {
    double min_score;
    int32_t min_align_len;
    double heuristic_pident;
};

// out arrays sized cap; chain row: [n_anchors, aligned_q, aligned_t,
// matched, qb, qe, tb, te] int64 x 8 + pident double
static int64_t c2_region(const int64_t* qb, const int64_t* tb, const int64_t* ln,
                         const double* ms, const int64_t* pv,
                         int64_t lo, int64_t hi, const C2Params* P,
                         int64_t Mi0,
                         int64_t* out, double* out_pident, int64_t cap,
                         int64_t n_out, int64_t* totals) {
    if (hi <= lo) return n_out;
    int64_t Mi;
    double M;
    if (Mi0 < 0) {
        Mi = lo;
        M = ms[lo];
        for (int64_t i = lo + 1; i < hi; ++i)
            if (ms[i] > M) { M = ms[i]; Mi = i; }
        if (M < P->min_score) return n_out;
    } else {
        Mi = Mi0;
        M = ms[Mi];
    }

    int64_t i = Mi;
    int64_t qb_b = INT64_MAX, tb_b = INT64_MAX, qe = -1, te = -1;
    bool first = true;
    int64_t n_anchors = 0, n_matched = 0, naq = 0, nat = 0;
    int64_t begin_next = 0;
    int64_t j = i;
    bool left_exit = false;
    while (true) {
        j = pv[i];
        if (j < lo) { left_exit = true; break; }
        ++n_anchors;
        if (first) {
            first = false;
            qe = qb[i] + ln[i] - 1;
            te = tb[i] + ln[i] - 1;
            qb_b = qb[i]; tb_b = tb[i];
            n_matched += ln[i];
        } else {
            qb_b = qb[i]; tb_b = tb[i];
            if (qb[i] + ln[i] - 1 >= begin_next) n_matched += begin_next - qb[i];
            else n_matched += ln[i];
        }
        begin_next = qb[i];
        if (i == j) {
            if (first) break;
            naq += qe - qb_b + 1;
            if (naq < P->min_align_len) { first = true; break; }
            nat += te - tb_b + 1;
            double pident = (double)n_matched / (double)std::max(naq, nat) * 100.0;
            if (pident < P->heuristic_pident) { first = true; break; }
            if (pident > 100.0) pident = 100.0;
            if (n_out < cap) {
                int64_t* row = out + n_out * 8;
                row[0] = n_anchors; row[1] = naq; row[2] = nat; row[3] = n_matched;
                row[4] = qb_b; row[5] = qe; row[6] = tb_b; row[7] = te;
                out_pident[n_out] = pident;
                ++n_out;
                totals[0] += n_matched; totals[1] += naq; totals[2] += nat;
            }
            first = true;
            break;
        }
        i = j;
    }

    if (left_exit && n_anchors > 0) {
        naq += qe - qb_b + 1;
        nat += te - tb_b + 1;
        if (naq >= P->min_align_len) {
            double pident = (double)n_matched / (double)std::max(naq, nat) * 100.0;
            if (pident >= P->heuristic_pident) {
                if (pident > 100.0) pident = 100.0;
                if (n_out < cap) {
                    int64_t* row = out + n_out * 8;
                    row[0] = n_anchors; row[1] = naq; row[2] = nat; row[3] = n_matched;
                    row[4] = qb_b; row[5] = qe; row[6] = tb_b; row[7] = te;
                    out_pident[n_out] = pident;
                    ++n_out;
                    totals[0] += n_matched; totals[1] += naq; totals[2] += nat;
                }
            }
        }
    }

    if (Mi != hi - 1)
        n_out = c2_region(qb, tb, ln, ms, pv, Mi + 1, hi, P, -1, out, out_pident, cap, n_out, totals);
    if (i > lo)
        n_out = c2_region(qb, tb, ln, ms, pv, lo, i, P, -1, out, out_pident, cap, n_out, totals);
    return n_out;
}

int64_t chain2_backtrack(const int64_t* qb, const int64_t* tb, const int64_t* ln,
                         const double* ms, const int64_t* pv, int64_t n,
                         double min_score, int32_t min_align_len,
                         double heuristic_pident,
                         int64_t* out, double* out_pident, int64_t cap,
                         int64_t* totals) {
    int64_t Mi = 0;
    double M = 0.0;
    for (int64_t i = 0; i < n; ++i)
        if (ms[i] > M) { M = ms[i]; Mi = i; }
    if (M < min_score) return 0;
    C2Params P{min_score, min_align_len, heuristic_pident};
    totals[0] = totals[1] = totals[2] = 0;
    return c2_region(qb, tb, ln, ms, pv, 0, n, &P, Mi, out, out_pident, cap, 0, totals);
}

// ---------------------------------------------------------------------------
// SeqComparator probe: match target k-mers against the sorted query k-mer
// table with >=m-prefix ranges (mirrors ops/seqcompare.py compare()).

int64_t compare_probe(const uint64_t* qk, const uint32_t* qv, int64_t nq,
                      const uint64_t* tf, const uint64_t* tr, int64_t nt,
                      const uint8_t* valid, int32_t mprefix, int32_t k,
                      int64_t begin, int64_t end,
                      int64_t* aq, int64_t* at, int64_t* al, uint8_t* arc,
                      int64_t cap) {
    uint64_t suf = ((1ULL << (2 * (k - mprefix))) - 1);
    int64_t w = 0;
    for (int64_t i = 0; i < nt; ++i) {
        if (!valid[i]) continue;
        for (int strand = 0; strand < 2; ++strand) {
            uint64_t t = strand == 0 ? tf[i] : tr[i];
            uint64_t lb = t & ~suf;
            uint64_t rb = t | suf;
            int64_t lo = std::lower_bound(qk, qk + nq, lb) - qk;
            for (int64_t j = lo; j < nq && qk[j] <= rb; ++j) {
                uint64_t x = t ^ qk[j];
                int lcp;
                if (x == 0) lcp = k;
                else lcp = (64 - (64 - __builtin_clzll(x))) / 2 + (k - 32);
                uint32_t v = qv[j];
                if (strand == 0) {
                    if (v & 1) continue;
                    int64_t p = v >> 1;
                    if (p < begin || p + lcp > end) continue;
                    if (w >= cap) return -1;
                    aq[w] = p; at[w] = i; al[w] = lcp; arc[w] = 0; ++w;
                } else {
                    if (!(v & 1)) continue;
                    int64_t p = (int64_t)(v >> 1) + k - lcp;
                    if (p + lcp < begin || p > end) continue;
                    if (w >= cap) return -1;
                    aq[w] = p; at[w] = i + k - lcp; al[w] = lcp; arc[w] = 1; ++w;
                }
            }
        }
    }
    return w;
}

// Same probe, but from raw 2-bit target codes: the k-mer extraction
// (ops/seqcompare.py Compare's kmers_fwd_rc) and the homopolymer validity
// check run inline as a rolling window, saving the tf/tr/valid round-trip
// through numpy (ref: lib-seq_compare.go:335-401).
// qtab: optional 16-bit-prefix bucket table over qk (size 2^bbits + 1,
// qtab[b] = first index whose top bbits equal/exceed b).  Valid because the
// probe range [t&~suf, t|suf] shares its top 2*mprefix >= bbits bits, so all
// candidates live in one bucket; empty buckets skip the search entirely.
int64_t compare_probe_codes(const uint64_t* qk, const uint32_t* qv, int64_t nq,
                            const uint8_t* tcodes, int64_t L,
                            const uint32_t* qtab, int32_t bbits,
                            int32_t mprefix, int32_t k,
                            int64_t begin, int64_t end,
                            int64_t* aq, int64_t* at, int64_t* al, uint8_t* arc,
                            int64_t cap) {
    if (L < k || nq == 0) return 0;
    const uint64_t kmask = (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    uint64_t ccc = 0, ggg = 0, ttt = 0;
    for (int32_t z = 0; z < k; ++z) { ccc = (ccc << 2) | 1; ggg = (ggg << 2) | 2; ttt = (ttt << 2) | 3; }
    const uint64_t suf = ((1ULL << (2 * (k - mprefix))) - 1);
    const int32_t rcshift = 2 * (k - 1);
    const bool use_tab = qtab != nullptr && bbits > 0 && 2 * mprefix >= bbits &&
                         2 * k > bbits;
    const int32_t tabshift = 2 * k - bbits;
    uint64_t fwd = 0, rc = 0;
    for (int64_t i = 0; i < k - 1; ++i) {
        uint64_t c = tcodes[i];
        fwd = ((fwd << 2) | c) & kmask;
        rc = (rc >> 2) | ((3ULL - c) << rcshift);
    }
    int64_t w = 0;
    for (int64_t i0 = k - 1; i0 < L; ++i0) {
        uint64_t c = tcodes[i0];
        fwd = ((fwd << 2) | c) & kmask;
        rc = (rc >> 2) | ((3ULL - c) << rcshift);
        if (fwd == 0 || fwd == ccc || fwd == ggg || fwd == ttt) continue;
        int64_t i = i0 - (k - 1);  // k-mer start in the target
        for (int strand = 0; strand < 2; ++strand) {
            uint64_t t = strand == 0 ? fwd : rc;
            uint64_t lb = t & ~suf;
            uint64_t rb = t | suf;
            int64_t lo, jhi;
            if (use_tab) {
                uint64_t b = t >> tabshift;
                int64_t blo = qtab[b], bhi = qtab[b + 1];
                if (blo >= bhi) continue;
                lo = std::lower_bound(qk + blo, qk + bhi, lb) - qk;
                jhi = bhi;
            } else {
                lo = std::lower_bound(qk, qk + nq, lb) - qk;
                jhi = nq;
            }
            for (int64_t j = lo; j < jhi && qk[j] <= rb; ++j) {
                uint64_t x = t ^ qk[j];
                int lcp;
                if (x == 0) lcp = k;
                else lcp = __builtin_clzll(x) / 2 + (k - 32);
                uint32_t v = qv[j];
                if (strand == 0) {
                    if (v & 1) continue;
                    int64_t p = v >> 1;
                    if (p < begin || p + lcp > end) continue;
                    if (w >= cap) return -1;
                    aq[w] = p; at[w] = i; al[w] = lcp; arc[w] = 0; ++w;
                } else {
                    if (!(v & 1)) continue;
                    int64_t p = (int64_t)(v >> 1) + k - lcp;
                    if (p + lcp < begin || p > end) continue;
                    if (w >= cap) return -1;
                    aq[w] = p; at[w] = i + k - lcp; al[w] = lcp; arc[w] = 1; ++w;
                }
            }
        }
    }
    return w;
}

// Fused SeqComparator pipeline: probe -> sort (QBegin asc, QEnd desc,
// TBegin asc) -> nested-anchor removal -> tandem-repeat trim -> Chainer2
// forward DP, all in one call (mirrors ops/seqcompare.py _finish_compare +
// ops/chaining2.py chain2; ref: lib-seq_compare.go:335-521,
// lib-chaining2.go:222-307).  Outputs the cleaned anchors plus the DP
// tables; backtracking stays on the Python side.  Returns the final anchor
// count, 0 if nothing survives, -1 on cap overflow.
// nanosecond atomics: align_paths_batch runs these on many threads
static std::atomic<int64_t> g_prof2[4] = {{0}, {0}, {0}, {0}};
extern "C" void get_prep_prof(double* out);
void get_prep_prof(double* out) { for (int i = 0; i < 4; ++i) { out[i] = 1e-9 * (double)g_prof2[i].exchange(0); } }
static inline double now2_s() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

int64_t compare_prepare(const uint64_t* qk, const uint32_t* qv, int64_t nq,
                        const uint8_t* tcodes, int64_t L,
                        const uint32_t* qtab, int32_t bbits,
                        int32_t mprefix, int32_t k,
                        int64_t begin, int64_t end,
                        int32_t band_base, int32_t band_count, double max_gap,
                        int64_t* aq, int64_t* at, int64_t* al, uint8_t* arc,
                        double* max_scores, int64_t* prev_idx, int64_t cap) {
    double tp0 = now2_s();
    int64_t w = compare_probe_codes(qk, qv, nq, tcodes, L, qtab, bbits,
                                    mprefix, k, begin, end, aq, at, al, arc, cap);
    g_prof2[0].fetch_add((int64_t)(1e9 * (now2_s() - tp0)), std::memory_order_relaxed);
    if (w <= 0) return w;
    tp0 = now2_s();

    // sort indices by (QBegin asc, QEnd desc, TBegin asc)
    static thread_local std::vector<int64_t> sq, st, sl;
    static thread_local std::vector<uint8_t> sc;
    sq.resize((size_t)w); st.resize((size_t)w); sl.resize((size_t)w);
    sc.resize((size_t)w);
    if (L + 64 < (1 << 21) && end + 64 < (1 << 21)) {
        // packed-key sort: one uint64 compare instead of a 3-key lambda
        // (coordinates fit 21 bits for windows under 2 Mb)
        static thread_local std::vector<std::pair<uint64_t, uint32_t>> keys;
        keys.resize((size_t)w);
        const uint64_t QE_MAX = (1 << 21) - 1;
        for (int64_t i = 0; i < w; ++i)
            keys[(size_t)i] = {((uint64_t)aq[i] << 42) |
                               ((QE_MAX - (uint64_t)(aq[i] + al[i])) << 21) |
                               (uint64_t)at[i],
                               (uint32_t)i};
        std::sort(keys.begin(), keys.end());
        for (int64_t i = 0; i < w; ++i) {
            int64_t o = keys[(size_t)i].second;
            sq[(size_t)i] = aq[o]; st[(size_t)i] = at[o];
            sl[(size_t)i] = al[o]; sc[(size_t)i] = arc[o];
        }
    } else {
        std::vector<int64_t> ord((size_t)w);
        for (int64_t i = 0; i < w; ++i) ord[(size_t)i] = i;
        std::sort(ord.begin(), ord.end(), [&](int64_t x, int64_t y) {
            if (aq[x] != aq[y]) return aq[x] < aq[y];
            int64_t ex = aq[x] + al[x], ey = aq[y] + al[y];
            if (ex != ey) return ex > ey;
            return at[x] < at[y];
        });
        for (int64_t i = 0; i < w; ++i) {
            int64_t o = ord[(size_t)i];
            sq[(size_t)i] = aq[o]; st[(size_t)i] = at[o];
            sl[(size_t)i] = al[o]; sc[(size_t)i] = arc[o];
        }
    }

    g_prof2[1].fetch_add((int64_t)(1e9 * (now2_s() - tp0)), std::memory_order_relaxed);
    tp0 = now2_s();
    // drop nested anchors (clear_substr_pairs_mark semantics, int64)
    static thread_local std::vector<int64_t> keep;
    keep.clear();
    keep.reserve((size_t)w);
    keep.push_back(0);
    for (int64_t i = 1; i < w; ++i) {
        int64_t vqe = sq[(size_t)i] + sl[(size_t)i];
        int64_t upbound = vqe - k;
        if (upbound < 0) upbound = 0;
        int64_t vtb = st[(size_t)i], vte = st[(size_t)i] + sl[(size_t)i];
        int64_t lo = 0, hi = i + 1;
        while (lo < hi) {
            int64_t mid = (lo + hi) >> 1;
            if (sq[(size_t)mid] < upbound) lo = mid + 1; else hi = mid;
        }
        bool drop = false;
        for (int64_t j = lo; j < i; ++j) {
            if (vqe <= sq[(size_t)j] + sl[(size_t)j] && vtb >= st[(size_t)j] &&
                vte <= st[(size_t)j] + sl[(size_t)j]) { drop = true; break; }
        }
        if (!drop) keep.push_back(i);
    }
    int64_t n = (int64_t)keep.size();
    for (int64_t i = 0; i < n; ++i) {
        int64_t o = keep[(size_t)i];
        sq[(size_t)i] = sq[(size_t)o]; st[(size_t)i] = st[(size_t)o];
        sl[(size_t)i] = sl[(size_t)o]; sc[(size_t)i] = sc[(size_t)o];
    }

    // trim tandem-repeat artifacts (TrimSubStrPairs, min_dist=100)
    if (n >= 2) {
        auto dist = [&](int64_t i, int64_t j) {
            int64_t dq = std::llabs(sq[(size_t)i] - sq[(size_t)j]);
            int64_t dt = std::llabs(st[(size_t)i] - st[(size_t)j]);
            return dq > dt ? dq : dt;
        };
        auto gap2 = [&](int64_t i, int64_t j) {
            int64_t dq = std::llabs(sq[(size_t)i] - sq[(size_t)j]);
            int64_t dt = std::llabs(st[(size_t)i] - st[(size_t)j]);
            return std::llabs(dq - dt);
        };
        auto overlap = [&](int64_t i, int64_t j) {  // i in front of j
            int64_t qo = 0, to = 0;
            if (sq[(size_t)j] >= sq[(size_t)i] && sq[(size_t)j] <= sq[(size_t)i] + sl[(size_t)i])
                qo = sq[(size_t)i] + sl[(size_t)i] - sq[(size_t)j] + 1;
            if (st[(size_t)j] >= st[(size_t)i] && st[(size_t)j] <= st[(size_t)i] + sl[(size_t)i])
                to = st[(size_t)i] + sl[(size_t)i] - st[(size_t)j] + 1;
            return qo > to ? qo : to;
        };
        const double min_dist = 100.0;
        int64_t prev = 0, start = 0;
        for (int64_t i = 1; i < n; ++i) {
            if ((double)dist(i, prev) < min_dist &&
                ((sq[(size_t)i] == sq[(size_t)prev] || st[(size_t)i] == st[(size_t)prev]) ||
                 (gap2(prev, i) > 11 &&
                  (double)overlap(prev, i) / (double)sl[(size_t)prev] > 0.8))) {
                start = i - 1;
                prev = i;
                continue;
            }
            break;
        }
        prev = n - 1;
        int64_t endi = n - 1;
        for (int64_t i = n - 2; i >= 0; --i) {
            if ((double)dist(i, prev) < min_dist &&
                ((sq[(size_t)i] == sq[(size_t)prev] || st[(size_t)i] == st[(size_t)prev]) ||
                 (gap2(i, prev) > 11 &&
                  (double)overlap(i, prev) / (double)sl[(size_t)prev] > 0.8))) {
                endi = i;
                prev = i;
                continue;
            }
            break;
        }
        if (!(start == 0 && endi == n - 1)) {
            if (start >= endi) return 0;
            int64_t nn = endi - start + 1;
            for (int64_t i = 0; i < nn; ++i) {
                sq[(size_t)i] = sq[(size_t)(start + i)];
                st[(size_t)i] = st[(size_t)(start + i)];
                sl[(size_t)i] = sl[(size_t)(start + i)];
                sc[(size_t)i] = sc[(size_t)(start + i)];
            }
            n = nn;
        }
    }

    for (int64_t i = 0; i < n; ++i) {
        aq[i] = sq[(size_t)i]; at[i] = st[(size_t)i];
        al[i] = sl[(size_t)i]; arc[i] = sc[(size_t)i];
    }
    g_prof2[2].fetch_add((int64_t)(1e9 * (now2_s() - tp0)), std::memory_order_relaxed);
    tp0 = now2_s();
    if (n >= 2) {
        chain2_forward(aq, at, al, n, band_base, band_count, max_gap,
                       max_scores, prev_idx);
        g_prof2[3].fetch_add((int64_t)(1e9 * (now2_s() - tp0)), std::memory_order_relaxed);
    } else if (n == 1) {
        max_scores[0] = (double)al[0];
        prev_idx[0] = 0;
    }
    return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batch helpers for the query path

extern "C" {

// nearest mask per query k-mer: index minimizing (mask XOR kmer)
// (mirrors masks.py xor_argmin_sorted)
void xor_argmin_batch(const uint64_t* sorted_vals, int64_t n,
                      const uint64_t* queries, int64_t nq, int32_t bits,
                      int64_t* out_idx) {
    // sort queries, co-descend both tries at once (amortizes shared-prefix
    // descent work; same winner semantics as per-query xor_argmin_range),
    // then scatter back to the original order
    std::vector<std::pair<uint64_t, int64_t>> qs((size_t)nq);
    for (int64_t i = 0; i < nq; ++i) qs[(size_t)i] = {queries[i], i};
    std::sort(qs.begin(), qs.end());
    std::vector<uint64_t> qsorted((size_t)nq);
    for (int64_t i = 0; i < nq; ++i) qsorted[(size_t)i] = qs[(size_t)i].first;
    std::vector<int64_t> lo((size_t)nq), hi((size_t)nq);
    xor_argmin_all(qsorted.data(), 0, nq, sorted_vals, 0, n, bits - 1,
                   lo.data(), hi.data());
    for (int64_t i = 0; i < nq; ++i) out_idx[qs[(size_t)i].second] = lo[(size_t)i];
}

// DUST low-complexity flags for a batch of k-mers
// (mirrors utils/kmers.py is_low_complexity_dust)
void dust_batch(const uint64_t* kmers, int64_t n, int32_t k, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) out[i] = dust_scalar(kmers[i], k) ? 1 : 0;
}

// 2-bit unpack: 4 codes per byte, MSB-first (mirrors index/store.py
// unpack_2bit)
void unpack_2bit_window(const uint8_t* packed, int64_t nbytes, uint8_t* out) {
    for (int64_t i = 0; i < nbytes; ++i) {
        uint8_t b = packed[i];
        out[4 * i] = (b >> 6) & 3;
        out[4 * i + 1] = (b >> 4) & 3;
        out[4 * i + 2] = (b >> 2) & 3;
        out[4 * i + 3] = b & 3;
    }
}

// Forward + reverse-complement k-mers at every position, one rolling pass
// (mirrors utils/kmers.py kmers_fwd_rc; first base at the top of the word).
void kmers_fwd_rc_batch(const uint8_t* codes, int64_t L, int32_t k,
                        uint64_t* out_fwd, uint64_t* out_rc) {
    if (L < k) return;
    const uint64_t kmask = (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    const int32_t rcshift = 2 * (k - 1);
    uint64_t fwd = 0, rc = 0;
    for (int64_t i = 0; i < k - 1; ++i) {
        uint64_t c = codes[i];
        fwd = ((fwd << 2) | c) & kmask;
        rc = (rc >> 2) | ((3ULL - c) << rcshift);
    }
    for (int64_t i0 = k - 1; i0 < L; ++i0) {
        uint64_t c = codes[i0];
        fwd = ((fwd << 2) | c) & kmask;
        rc = (rc >> 2) | ((3ULL - c) << rcshift);
        out_fwd[i0 - (k - 1)] = fwd;
        out_rc[i0 - (k - 1)] = rc;
    }
}

// Per-mask prefix-range seed matching (index/search.py _match_chunk):
// for each query k-mer i, scan entries of its mask segment within
// [lb[i], rb[i]], keep entries whose first posting's reverse flag matches,
// and emit (entry index, query row, LCP) (ref: kv-searcher.go:263-469).
// Returns hit count or -1 if cap exceeded.
int64_t range_match(const uint64_t* ek, const int64_t* eoff, const uint64_t* vals,
                    const int64_t* seg_lo, const int64_t* seg_hi,
                    const uint64_t* lb, const uint64_t* rb, const uint64_t* qk,
                    int64_t nq, int32_t k, int32_t want_rev,
                    int64_t* out_e, int64_t* out_q, int64_t* out_l, int64_t cap) {
    const uint64_t want = want_rev ? 1ULL : 0ULL;
    int64_t w = 0;
    for (int64_t i = 0; i < nq; ++i) {
        int64_t lo = seg_lo[i], hi = seg_hi[i];
        if (lo >= hi) continue;
        int64_t e0 = std::lower_bound(ek + lo, ek + hi, lb[i]) - ek;
        int64_t e1 = std::upper_bound(ek + e0, ek + hi, rb[i]) - ek;
        for (int64_t e = e0; e < e1; ++e) {
            if ((vals[eoff[e]] & 1ULL) != want) continue;
            uint64_t x = ek[e] ^ qk[i];
            int64_t lcp = x == 0 ? k : (__builtin_clzll(x) >> 1) + (k - 32);
            if (w >= cap) return -1;
            out_e[w] = e; out_q[w] = i; out_l[w] = lcp; ++w;
        }
    }
    return w;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused HSP extension + WFA + trimmed stats, batched over the chains of one
// flush group (the phase-4 per-HSP hot loop; mirrors ops/extend.py
// extend_match/_extend_right + wfa_align_stats; ref: extendMatch,
// lib-index-search-util.go:34-200 and lib-index-search.go:2164-2348).

namespace {

// 2-mer chain extension over two (already materialized) windows.
// Mirrors ops/extend.py _extend_right: anchors are all (i, j) pairs with
// s1[i..i+1] == s2[j..j+1], ordered (qb asc, tb asc), chained by Chainer3
// with the extension defaults (ref: lib-index-search-util.go:98-200).
static void extend_right2(const uint8_t* s1, int64_t L1,
                          const uint8_t* s2, int64_t L2,
                          int64_t* e1_out, int64_t* e2_out,
                          std::vector<int32_t>& aq, std::vector<int32_t>& at,
                          std::vector<int32_t>& al,
                          std::vector<int32_t>& tpos_bucket,
                          std::vector<int32_t>& tpos_off) {
    *e1_out = 0; *e2_out = 0;
    int64_t n1 = L1 - 1, n2 = L2 - 1;
    if (n1 <= 0 || n2 <= 0) return;
    // bucket t positions by 2-mer value (16 buckets, ascending j)
    int32_t cnt[16] = {0};
    for (int64_t j = 0; j < n2; ++j) ++cnt[(s2[j] << 2) | s2[j + 1]];
    tpos_off.resize(17);
    tpos_off[0] = 0;
    for (int v = 0; v < 16; ++v) tpos_off[v + 1] = tpos_off[v] + cnt[v];
    tpos_bucket.resize((size_t)n2);
    int32_t fill[16];
    for (int v = 0; v < 16; ++v) fill[v] = tpos_off[v];
    for (int64_t j = 0; j < n2; ++j) {
        int v = (s2[j] << 2) | s2[j + 1];
        tpos_bucket[(size_t)fill[v]++] = (int32_t)j;
    }
    aq.clear(); at.clear();
    for (int64_t i = 0; i < n1; ++i) {
        int v = (s1[i] << 2) | s1[i + 1];
        for (int32_t p = tpos_off[v]; p < tpos_off[v + 1]; ++p) {
            aq.push_back((int32_t)i);
            at.push_back(tpos_bucket[(size_t)p]);
        }
    }
    if (aq.empty()) return;
    al.assign(aq.size(), 2);
    int32_t qe = 0, te = 0;
    int32_t ok = chain3_chain(aq.data(), at.data(), al.data(), (int64_t)aq.size(),
                              /*max_gap=*/5, /*min_score=*/1, /*min_align_len=*/2,
                              /*max_distance=*/10, /*band_count=*/20, /*band_base=*/10,
                              &qe, &te);
    if (!ok) return;
    *e1_out = (int64_t)qe + 1;
    *e2_out = (int64_t)te + 1;
}

}  // namespace

extern "C" {

// For each chain c of one flush group: extend both flanks via 2-mer chaining,
// then run WFA + trimmed-alignment stats on the extended windows.  Output row
// layout (int64[16] per chain):
//   [0..9]  wfa_align_stats stats
//   [10..13] s1, e1, s2, e2   (per-side extension lengths)
//   [14..15] qseq_len, tseq_len (extended window sizes)
// Returns 0 on success, or (1 + index of the first chain whose WFA failed)
// so the caller can fall back per chain.
int64_t hsp_extend_wfa_batch(
    const uint8_t* qcodes, int64_t qlen,
    const uint8_t* tcodes, int64_t tlen,
    int32_t rc,
    const int64_t* c_qb, const int64_t* c_qe1,
    const int64_t* c_start, const int64_t* c_end,
    const int64_t* c_ext2, const int64_t* c_tb, const int64_t* c_maxext,
    int64_t n,
    int32_t x, int32_t o, int32_t e,
    int32_t adaptive, int32_t min_wf_len, int32_t max_dist_diff,
    int64_t* out) {
    std::vector<uint8_t> w1, w2, ops;
    std::vector<int32_t> aq, at, al, tb_bucket, tb_off;
    int64_t rcode = 0;
    for (int64_t ci = 0; ci < n; ++ci) {
        int64_t start1 = c_qb[ci], end1 = c_qe1[ci];
        int64_t start2 = c_start[ci], end2 = c_end[ci];
        const int64_t s1_0 = start1, e1_0 = end1, s2_0 = start2, e2_0 = end2;
        int64_t s1 = 0, e1 = 0, s2 = 0, e2 = 0;
        const int64_t m = 2;
        const int64_t ext2 = c_ext2[ci], tbp = c_tb[ci], mx = c_maxext[ci];

        // 3' (right)
        if (end1 + m < qlen && end2 + m < tlen) {
            int64_t ext = rc ? std::min(ext2, tbp) : std::min(ext2, mx);
            if (ext > 2) {
                int64_t e1b = std::min(end1 + ext, qlen);
                int64_t e2b = std::min(end2 + ext, tlen);
                extend_right2(qcodes + end1, e1b - end1, tcodes + end2, e2b - end2,
                              &e1, &e2, aq, at, al, tb_bucket, tb_off);
                if (e1 > 0 || e2 > 0) { end1 += e1; end2 += e2; }
            }
        }
        // 5' (left): reversed slices
        if (start1 > m && start2 > m) {
            int64_t ext = rc ? std::min(ext2, mx) : std::min(ext2, tbp);
            if (ext > 2) {
                int64_t s1b = std::max(start1 - ext, (int64_t)0);
                int64_t s2b = std::max(start2 - ext, (int64_t)0);
                w1.resize((size_t)(start1 - s1b));
                w2.resize((size_t)(start2 - s2b));
                for (int64_t i2 = 0; i2 < start1 - s1b; ++i2) w1[(size_t)i2] = qcodes[start1 - 1 - i2];
                for (int64_t i2 = 0; i2 < start2 - s2b; ++i2) w2[(size_t)i2] = tcodes[start2 - 1 - i2];
                extend_right2(w1.data(), start1 - s1b, w2.data(), start2 - s2b,
                              &s1, &s2, aq, at, al, tb_bucket, tb_off);
                if (s1 > 0 || s2 > 0) { start1 -= s1; start2 -= s2; }
            }
        }
        if (start1 < 0 || start2 < 0) { start1 = s1_0; start2 = s2_0; }
        if (end1 > qlen || end2 > tlen) { end1 = e1_0; end2 = e2_0; }

        int64_t qn = end1 - start1, tn = end2 - start2;
        int64_t cap = 2 * (qn + tn) + 16;
        ops.resize((size_t)cap);
        int64_t* stats = out + ci * 16;
        int64_t w = wfa_align_stats(qcodes + start1, qn, tcodes + start2, tn,
                                    x, o, e, adaptive, min_wf_len, max_dist_diff,
                                    ops.data(), cap, stats);
        stats[10] = s1; stats[11] = e1; stats[12] = s2; stats[13] = e2;
        stats[14] = qn; stats[15] = tn;
        if (w < 0 && rcode == 0) rcode = 1 + ci;
    }
    return rcode;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Whole-genome phase-4 fusion: for every chain window (path) of one genome,
// run pseudo-alignment (compare_prepare + Chainer2 backtrack), contig
// assignment, HSP-group flushing with dedup, 2-mer extension, WFA and
// BLAST-style scoring — one C call per genome instead of ~10 Python/ctypes
// round-trips per HSP.  Mirrors index/search.py _align_genome/_flush_hsp_group
// (ref: falin, lib-index-search.go:1845-2720).

namespace {

struct C2R {
    int64_t n_anchors, matched, abq, abt, qb, qe, tb, te;
    int64_t max_ext, t_off_begin;
    double pident;
};

// _find_contig (index/search.py; ref: lib-index-search.go:2049-2100)
static void find_contig(const int64_t* seq_sizes, int64_t num_seqs,
                        int64_t interval, int32_t k, bool rc,
                        int64_t t_begin, int64_t t_end, int64_t tb2, int64_t te2,
                        int64_t* i_seq_out, int64_t* off_out) {
    int64_t b, e;
    if (rc) { b = t_end - te2 + k; e = t_end - tb2 - k; }
    else    { b = t_begin + tb2 + k; e = t_begin + te2 - k; }
    if (b >= e) {
        if (rc) { b = t_end - te2; e = t_end - tb2; }
        else    { b = t_begin + tb2; e = t_begin + te2; }
    }
    int64_t off_begin = 0, off_end = 0;
    for (int64_t j = 0; j < num_seqs; ++j) {
        off_end += seq_sizes[j] - 1;
        if (b + k >= off_begin && e - k <= off_end) { *i_seq_out = j; *off_out = off_begin; return; }
        if (e < off_begin) { *i_seq_out = -1; *off_out = 0; return; }
        off_end += interval + 1;
        off_begin = off_end;
    }
    *i_seq_out = -1; *off_out = 0;
}

// _convert_chain (index/search.py; ref: lib-index-search.go:2380-2411)
static void convert_chain(C2R& c, bool rc, int64_t t_begin, int64_t t_end,
                          int64_t t_off_begin, int64_t seq_size, int64_t tlen) {
    int64_t tb = c.tb, te = c.te;
    c.t_off_begin = t_off_begin;
    if (rc) {
        c.tb = t_begin - t_off_begin + (tlen - te - 1);
        if (c.tb < 0) { c.qe += c.tb; c.abq += c.tb; c.tb = 0; }
        c.te = t_begin - t_off_begin + (tlen - tb - 1);
        if (c.te > seq_size - 1) { c.qb += c.te - (seq_size - 1); c.te = seq_size - 1; }
    } else {
        c.tb = t_begin - t_off_begin + tb;
        if (c.tb < 0) { c.qb -= c.tb; c.abq += c.tb; c.tb = 0; }
        c.te = t_begin - t_off_begin + te;
        if (c.te > seq_size - 1) { c.qe -= c.te - (seq_size - 1); c.te = seq_size - 1; }
    }
    c.max_ext = seq_size - 1 - c.te;
}

struct DedupKey {
    int64_t qb, qe, tb, te, iseq;
    bool rc;
    bool operator<(const DedupKey& o) const {
        if (qb != o.qb) return qb < o.qb;
        if (qe != o.qe) return qe < o.qe;
        if (tb != o.tb) return tb < o.tb;
        if (te != o.te) return te < o.te;
        if (iseq != o.iseq) return iseq < o.iseq;
        return rc < o.rc;
    }
};

}  // namespace

extern "C" {

// profiling accumulators for align_paths (fetched by get_align_prof)
static std::atomic<int64_t> g_prof[4] = {{0}, {0}, {0}, {0}};  // compare, backtrack, extend, wfa (ns)
static inline double now_s() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}
void get_align_prof(double* out) { for (int i = 0; i < 4; ++i) { out[i] = 1e-9 * (double)g_prof[i].exchange(0); } }

// Output row layout (double[18] per kept HSP):
//  0 path_idx  1 group_id  2 i_seq  3 qbegin  4 qend  5 tbegin  6 tend
//  7 aligned_length  8 matched_bases  9 gaps  10 pident  11 aligned_fraction
// 12 aligned_bases_q 13 score 14 bit_score 15 evalue 16 n_anchors 17 rc
// Returns the number of rows, or -1 if row_cap was exceeded (caller retries),
// or -2 if a WFA alignment failed (caller falls back to the Python path).
int64_t align_paths(
    const uint8_t* qcodes, int64_t qlen,
    const uint64_t* qk, const uint32_t* qv, int64_t nq,
    const uint32_t* qtab, int32_t bbits,
    int32_t cmp_k, int32_t cmp_min_prefix,
    int32_t band_base, int32_t band_count, double c2_max_gap,
    double c2_min_score, int32_t c2_min_align_len, double c2_heur_pident,
    const uint8_t* tbuf, const int64_t* t_off, const int64_t* t_len,
    const int64_t* p_qbegin, const int64_t* p_qend,
    const int64_t* p_tbegin, const int64_t* p_tend,
    const uint8_t* p_rc,
    int64_t n_paths,
    const int64_t* seq_sizes, int64_t num_seqs, int64_t interval, int32_t k,
    int64_t ext2_base, double total_bases, double max_evalue,
    double min_qcov_hsp, double min_identity,
    int32_t x, int32_t o, int32_t e,
    int32_t adaptive, int32_t min_wf_len, int32_t max_dist_diff,
    // optional precomputed pseudo-alignment (device path): per path pi with
    // pre_cnt[pi] >= 0, chains are taken from pre_rows[pre_off[pi]..] (8
    // int64 per chain: n_anchors, naq, nat, matched, qb, qe, tb, te — the
    // exact output of chain2_backtrack) and compare/backtrack are skipped.
    const int64_t* pre_rows, const int64_t* pre_off, const int64_t* pre_cnt,
    double* out_rows, int64_t row_cap,
    // two-phase WFA offload (device WFA):
    //   span_mode 0: normal (WFA inline, host wavefronts)
    //   span_mode 1: collect — write each chain's extended WFA window
    //     [start1, qn, start2, tn, path] into span_buf and skip WFA/scoring;
    //     the function returns the span count (-1 if span_cap exceeded)
    //   span_mode 2: consume — the i-th WFA call takes its per-base op
    //     stream from inj_ops[inj_off[i] : +inj_len[i]] instead of running
    //     the wavefronts (the caller computed them batched on the device;
    //     iteration order is deterministic, so ordinals line up with mode 1)
    int32_t span_mode,
    int64_t* span_buf, int64_t span_cap,
    const uint8_t* inj_ops, const int64_t* inj_off, const int64_t* inj_len) {

    int64_t n_rows = 0;
    int64_t group_id = 0;
    int64_t span_n = 0;
    bool overflow = false, wfa_fail = false;
    std::set<DedupKey> dedup;
    // scratch
    std::vector<int64_t> aq, at, al, sc_pv;
    std::vector<uint8_t> arc;
    std::vector<double> sc_ms;
    std::vector<int64_t> bt_rows;
    std::vector<double> bt_pident;
    std::vector<uint8_t> w1, w2, ops;
    std::vector<int32_t> xq, xt, xl, xb, xo;

    // flush one group of converted chains into out_rows
    auto flush = [&](std::vector<C2R>& group, int64_t i_seq, int64_t path_idx,
                     bool rc, const uint8_t* tcodes, int64_t tlen,
                     int64_t t_begin, int64_t t_end) {
        bool has_result = false;
        int64_t first_row = n_rows;
        for (C2R& c : group) {
            if (c.qb >= c.qe + 1) continue;
            int64_t start, end;
            if (rc) { start = t_end - c.te - c.t_off_begin;
                      end = t_end - c.tb - c.t_off_begin + 1; }
            else    { start = c.t_off_begin + c.tb - t_begin;
                      end = c.t_off_begin + c.te - t_begin + 1; }
            if (start >= end) continue;
            int64_t ext2 = ext2_base;
            if (c.abq > 1000000) ext2 += 80;
            else if (c.abq > 250000) ext2 += 40;
            else if (c.abq > 50000) ext2 += 20;
            else if (c.abq > 10000) ext2 += 10;

            // extend_match (mirrors ops/extend.py)
            double te0 = now_s();
            int64_t start1 = c.qb, end1 = c.qe + 1, start2 = start, end2 = end;
            const int64_t s1_0 = start1, e1_0 = end1, s2_0 = start2, e2_0 = end2;
            int64_t s1 = 0, e1 = 0, s2 = 0, e2 = 0;
            if (end1 + 2 < qlen && end2 + 2 < tlen) {
                int64_t ext = rc ? std::min(ext2, c.tb) : std::min(ext2, c.max_ext);
                if (ext > 2) {
                    int64_t e1b = std::min(end1 + ext, qlen);
                    int64_t e2b = std::min(end2 + ext, tlen);
                    extend_right2(qcodes + end1, e1b - end1, tcodes + end2, e2b - end2,
                                  &e1, &e2, xq, xt, xl, xb, xo);
                    if (e1 > 0 || e2 > 0) { end1 += e1; end2 += e2; }
                }
            }
            if (start1 > 2 && start2 > 2) {
                int64_t ext = rc ? std::min(ext2, c.max_ext) : std::min(ext2, c.tb);
                if (ext > 2) {
                    int64_t s1b = std::max(start1 - ext, (int64_t)0);
                    int64_t s2b = std::max(start2 - ext, (int64_t)0);
                    w1.resize((size_t)(start1 - s1b));
                    w2.resize((size_t)(start2 - s2b));
                    for (int64_t i2 = 0; i2 < start1 - s1b; ++i2) w1[(size_t)i2] = qcodes[start1 - 1 - i2];
                    for (int64_t i2 = 0; i2 < start2 - s2b; ++i2) w2[(size_t)i2] = tcodes[start2 - 1 - i2];
                    extend_right2(w1.data(), start1 - s1b, w2.data(), start2 - s2b,
                                  &s1, &s2, xq, xt, xl, xb, xo);
                    if (s1 > 0 || s2 > 0) { start1 -= s1; start2 -= s2; }
                }
            }
            if (start1 < 0 || start2 < 0) { start1 = s1_0; start2 = s2_0; }
            if (end1 > qlen || end2 > tlen) { end1 = e1_0; end2 = e2_0; }

            g_prof[2].fetch_add((int64_t)(1e9 * (now_s() - te0)), std::memory_order_relaxed);
            int64_t qn = end1 - start1, tn = end2 - start2;
            if (span_mode == 1) {
                if (span_n >= span_cap) { overflow = true; return; }
                int64_t* sp = span_buf + span_n * 5;
                sp[0] = start1; sp[1] = qn; sp[2] = start2; sp[3] = tn;
                sp[4] = path_idx;
                ++span_n;
                continue;
            }
            int64_t stats[10];
            int64_t w;
            if (span_mode == 2) {
                const uint8_t* po = inj_ops + inj_off[span_n];
                w = inj_len[span_n];
                ++span_n;
                ops_to_stats(po, w, stats);
            } else {
                int64_t cap = 2 * (qn + tn) + 16;
                ops.resize((size_t)cap);
                double tw0 = now_s();
                w = wfa_align_stats(qcodes + start1, qn, tcodes + start2, tn,
                                    x, o, e, adaptive, min_wf_len, max_dist_diff,
                                    ops.data(), cap, stats);
                g_prof[3].fetch_add((int64_t)(1e9 * (now_s() - tw0)), std::memory_order_relaxed);
                if (w < 0) { wfa_fail = true; return; }
            }
            if (stats[1] == 0) continue;  // empty trimmed region
            int64_t a_len = stats[1], a_matches = stats[2], a_gaps = stats[4];
            int64_t cg_qb = stats[5], cg_qe = stats[6];
            int64_t cg_tb = stats[7], cg_te = stats[8];
            int64_t score = stats[9];
            // score_to_bit_evalue (ops/align.py; ref: lib-index-search-util.go:259)
            int64_t s_r = score;
            if (s_r & 1) s_r -= 1;
            double bitf = (0.625 * (double)s_r - std::log(0.41)) / std::log(2.0);
            double evalue = total_bases * std::pow(2.0, -bitf) * (double)qn;
            int64_t bits = (int64_t)bitf;
            if (evalue > max_evalue) continue;

            // coordinate updates use the RAW extension lengths (the Python
            // extend_match returns them even if the safety reset fired)
            c.qb = (c.qb - s1) + cg_qb - 1;
            c.qe = (c.qe + e1) - (qn - cg_qe);
            if (rc) {
                c.tb -= e2;
                c.te += s2;
                c.tb = c.tb + (tn - cg_te);
                c.te = c.te - (cg_tb - 1);
            } else {
                c.tb -= s2;
                c.te += e2;
                c.tb = c.tb + (cg_tb - 1);
                c.te = c.te - (tn - cg_te);
            }
            c.abq = c.qe - c.qb + 1;
            double afrac = std::min((double)c.abq / (double)qlen * 100.0, 100.0);
            double pident = a_len ? (double)a_matches / (double)a_len * 100.0 : 0.0;
            if (afrac < min_qcov_hsp || pident < min_identity) continue;

            if (n_rows >= row_cap) { overflow = true; return; }
            double* row = out_rows + n_rows * 18;
            row[0] = (double)path_idx; row[1] = (double)group_id; row[2] = (double)i_seq;
            row[3] = (double)c.qb; row[4] = (double)c.qe;
            row[5] = (double)c.tb; row[6] = (double)c.te;
            row[7] = (double)a_len; row[8] = (double)a_matches; row[9] = (double)a_gaps;
            row[10] = pident; row[11] = afrac; row[12] = (double)c.abq;
            row[13] = (double)score; row[14] = (double)bits; row[15] = evalue;
            row[16] = (double)c.n_anchors; row[17] = rc ? 1.0 : 0.0;
            ++n_rows;
            has_result = true;
        }
        if (has_result) ++group_id;
        else n_rows = first_row;
    };

    for (int64_t pi = 0; pi < n_paths && !overflow && !wfa_fail; ++pi) {
        const uint8_t* tcodes = tbuf + t_off[pi];
        int64_t L = t_len[pi];
        bool rc = p_rc[pi] != 0;
        int64_t t_begin = p_tbegin[pi], t_end = p_tend[pi];

        std::vector<C2R> pre_chains;
        bool have_pre = pre_cnt != nullptr && pre_cnt[pi] >= 0;
        if (have_pre) {
            for (int64_t i = 0; i < pre_cnt[pi]; ++i) {
                const int64_t* r = pre_rows + (pre_off[pi] + i) * 8;
                C2R c{};
                c.n_anchors = r[0]; c.abq = r[1]; c.abt = r[2]; c.matched = r[3];
                c.qb = r[4]; c.qe = r[5]; c.tb = r[6]; c.te = r[7];
                pre_chains.push_back(c);
            }
            if (pre_chains.empty()) continue;
        }

        // ---- compare (ops/seqcompare.py compare; ref: lib-seq_compare.go:335) ----
        int32_t m = cmp_min_prefix;
        if (L >= 1000000) m += 8;
        else if (L >= 250000) m += 6;
        else if (L >= 50000) m += 4;
        else if (L >= 10000) m += 2;
        if (L < cmp_k || nq == 0) continue;

        int64_t cap = std::max((int64_t)8 * std::max(L - cmp_k + 1, (int64_t)1), (int64_t)4096);
        int64_t n;
        double tt0 = now_s();
        if (have_pre) { cap = 0; n = 0; }
        else while (true) {
            aq.resize((size_t)cap); at.resize((size_t)cap); al.resize((size_t)cap);
            arc.resize((size_t)cap); sc_ms.resize((size_t)cap); sc_pv.resize((size_t)cap);
            n = compare_prepare(qk, qv, nq, tcodes, L, qtab, bbits, m, cmp_k,
                                p_qbegin[pi], p_qend[pi],
                                band_base, band_count, c2_max_gap,
                                aq.data(), at.data(), al.data(), arc.data(),
                                sc_ms.data(), sc_pv.data(), cap);
            if (n == -1) { cap *= 4; continue; }
            break;
        }
        g_prof[0].fetch_add((int64_t)(1e9 * (now_s() - tt0)), std::memory_order_relaxed);
        if (!have_pre && n == 0) continue;

        std::vector<C2R> chains;
        if (have_pre) {
            chains.swap(pre_chains);
        } else if (n == 1) {
            int64_t slen = al[0];
            if ((double)slen >= c2_min_score && slen >= c2_min_align_len) {
                C2R c{};
                c.n_anchors = 1; c.matched = slen; c.abq = slen; c.abt = slen;
                c.qb = aq[0]; c.qe = aq[0] + slen - 1;
                c.tb = at[0]; c.te = at[0] + slen - 1;
                c.pident = 100.0;
                chains.push_back(c);
            }
        } else {
            bt_rows.resize((size_t)n * 8);
            bt_pident.resize((size_t)n);
            int64_t totals[3];
            double tb0 = now_s();
            int64_t nc = chain2_backtrack(aq.data(), at.data(), al.data(),
                                          sc_ms.data(), sc_pv.data(), n,
                                          c2_min_score, c2_min_align_len,
                                          c2_heur_pident,
                                          bt_rows.data(), bt_pident.data(), n, totals);
            g_prof[1].fetch_add((int64_t)(1e9 * (now_s() - tb0)), std::memory_order_relaxed);
            for (int64_t i = 0; i < nc; ++i) {
                const int64_t* r = bt_rows.data() + i * 8;
                C2R c{};
                c.n_anchors = r[0]; c.abq = r[1]; c.abt = r[2]; c.matched = r[3];
                c.qb = r[4]; c.qe = r[5]; c.tb = r[6]; c.te = r[7];
                c.pident = bt_pident[(size_t)i];
                chains.push_back(c);
            }
        }
        if (chains.empty()) continue;
        std::stable_sort(chains.begin(), chains.end(),
                         [](const C2R& a, const C2R& b) { return a.qb < b.qb; });

        // ---- group loop (index/search.py _align_genome chain loop) ----
        int64_t i_seq_pre = -1, last_i_seq = -1;
        std::vector<C2R> group;
        for (C2R& c : chains) {
            int64_t tb2 = c.tb, te2 = c.te;
            int64_t i_seq = 0, t_off_begin = 0;
            if (num_seqs > 1) {
                find_contig(seq_sizes, num_seqs, interval, k, rc, t_begin, t_end,
                            tb2, te2, &i_seq, &t_off_begin);
                if (i_seq < 0) continue;
                if (i_seq_pre >= 0 && i_seq != i_seq_pre) {
                    int64_t i_seq0 = i_seq;
                    convert_chain(c, rc, t_begin, t_end, t_off_begin,
                                  seq_sizes[i_seq_pre], L);
                    if (!group.empty()) {
                        flush(group, i_seq_pre, pi, rc, tcodes, L, t_begin, t_end);
                        if (overflow || wfa_fail) break;
                    }
                    group.clear();
                    DedupKey h{c.qb, c.qe, c.tb, c.te, i_seq_pre, rc};
                    if (dedup.insert(h).second) group.push_back(c);
                    i_seq_pre = -1;
                    last_i_seq = i_seq0;
                    continue;
                }
            }
            i_seq_pre = i_seq;
            last_i_seq = i_seq;
            convert_chain(c, rc, t_begin, t_end, t_off_begin, seq_sizes[i_seq], L);
            DedupKey h{c.qb, c.qe, c.tb, c.te, i_seq, rc};
            if (!dedup.insert(h).second) continue;
            group.push_back(c);
        }
        if (overflow || wfa_fail) break;
        if (last_i_seq >= 0 && !group.empty())
            flush(group, last_i_seq, pi, rc, tcodes, L, t_begin, t_end);
    }
    if (wfa_fail) return -2;
    if (overflow) return -1;
    return span_mode == 1 ? span_n : n_rows;
}

// ---------------------------------------------------------------------------
// Phase 2b: postings gather + bit-slice decode + genome grouping for one
// query in a single pass (mirror of index/search.py::_collect_anchors's
// numpy tail; posting layout ref: lib-index-build.go:412-455, coordinate
// fix-ups ref: lib-index-search.go:1455-1483).
//
// Hits arrive as the concatenated per-chunk match results (the same order
// the numpy path concatenates: per chunk, forward block then suffix
// block); per chunk the values / entry_offsets base pointers differ
// (mmap'd columnar chunks), so they come as pointer tables indexed by
// chunk_of_hit.  Expansion order is value-major, query-location-minor —
// identical to np.repeat.  Output anchors are stably grouped by genome
// code ascending (the numpy path's stable argsort over ref_idx).
//
// Returns the anchor count, or -1 when cap is insufficient (required size
// in *need; caller re-allocates and retries).
int64_t collect_anchors(
    const uint64_t* const* values_ptrs, const int64_t* const* eoff_ptrs,
    const int32_t* chunk_of_hit, const int64_t* eidx,
    const int64_t* lcp, const int64_t* qmask, int64_t n_hits,
    const uint32_t* pos_flat, const int64_t* pos_off, const int64_t* npos,
    int32_t k,
    int64_t* out_ref,
    int32_t* out_bq, int32_t* out_bt, int32_t* out_len,
    uint8_t* out_rcq, uint8_t* out_rct,
    int64_t cap, int64_t* need) {
    // pass 1: total expansion size
    int64_t total = 0;
    for (int64_t h = 0; h < n_hits; ++h) {
        const int64_t* eoff = eoff_ptrs[chunk_of_hit[h]];
        const int64_t e = eidx[h];
        total += (eoff[e + 1] - eoff[e]) * npos[qmask[h]];
    }
    *need = total;
    if (total > cap) return -1;

    // pass 2: gather + decode in input order
    std::vector<int64_t> ref((size_t)total);
    std::vector<int32_t> bq((size_t)total), bt((size_t)total), ln((size_t)total);
    std::vector<uint8_t> rcq((size_t)total), rct((size_t)total);
    int64_t w = 0;
    for (int64_t h = 0; h < n_hits; ++h) {
        const int32_t c = chunk_of_hit[h];
        const int64_t* eoff = eoff_ptrs[c];
        const uint64_t* values = values_ptrs[c];
        const int64_t e = eidx[h];
        const int64_t m = qmask[h];
        const int64_t np_ = npos[m];
        if (np_ == 0) continue;
        const int64_t l = lcp[h];
        const int32_t kl = (int32_t)l;
        const int64_t p0 = pos_off[m];
        for (int64_t vi = eoff[e]; vi < eoff[e + 1]; ++vi) {
            const uint64_t v = values[vi];
            // posting decode (constants.py: BITS_NONE_IDX=30, BITS_IDX=34,
            // BITS_IDX_FLAGS=36)
            const int64_t ridx = (int64_t)(v >> 30);
            const int64_t pos_t = (int64_t)((v << 34) >> 36);
            const bool rv_t = (v & 1) != 0;
            const bool rc_t = ((v >> 1) & 1) != 0;
            for (int64_t pi = 0; pi < np_; ++pi) {
                const uint32_t qloc = pos_flat[p0 + pi];
                const bool rc_q = (qloc & 1) != 0;
                const int64_t pos_q = (int64_t)(qloc >> 1);
                // coordinate fix-ups (lib-index-search.go:1455-1483)
                int64_t begin_q, begin_t;
                if (!rv_t) {
                    begin_q = rc_q ? pos_q + k - l : pos_q;
                    begin_t = rc_t ? pos_t + k - l : pos_t;
                } else {
                    begin_q = rc_q ? pos_q : pos_q + k - l;
                    begin_t = rc_t ? pos_t : pos_t + k - l;
                }
                ref[(size_t)w] = ridx;
                bq[(size_t)w] = (int32_t)begin_q;
                bt[(size_t)w] = (int32_t)begin_t;
                ln[(size_t)w] = kl;
                rcq[(size_t)w] = rc_q ? 1 : 0;
                rct[(size_t)w] = rc_t ? 1 : 0;
                ++w;
            }
        }
    }

    // pass 3: stable group by genome code ascending
    std::vector<int64_t> order((size_t)w);
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t b) { return ref[(size_t)a] < ref[(size_t)b]; });
    for (int64_t i = 0; i < w; ++i) {
        const size_t s = (size_t)order[(size_t)i];
        out_ref[i] = ref[s];
        out_bq[i] = bq[s];
        out_bt[i] = bt[s];
        out_len[i] = ln[s];
        out_rcq[i] = rcq[s];
        out_rct[i] = rct[s];
    }
    return w;
}

// ---------------------------------------------------------------------------
// Batched phase 4 for the MANY-HIT regime: align_paths for many genomes of
// one query in a single call, threaded across genomes (each genome's work is
// independent; the per-genome Python marshaling of ~50 ctypes args costs
// more than the C work at 1000 genome hits/query).  Per-query constants are
// passed once; per-genome inputs arrive concatenated with offset arrays:
//   tbuf_goff[g]   genome g's start in tbuf_all (its t_off values stay
//                  genome-relative, exactly as align_paths expects)
//   path_goff[g]   genome g's path range in t_off/t_len/p_*
//   seq_goff[g]    genome g's contig-size range in seq_sizes_all
//   row_goff[g]    genome g's row slot in out_rows (capacity
//                  row_goff[g+1]-row_goff[g]); out_counts[g] = rows written,
//                  -1 (slot overflow: caller retries that genome alone) or
//                  -2 (WFA failure: caller uses the Python path)
void align_paths_batch(
    const uint8_t* qcodes, int64_t qlen,
    const uint64_t* qk, const uint32_t* qv, int64_t nq,
    const uint32_t* qtab, int32_t bbits,
    int32_t cmp_k, int32_t cmp_min_prefix,
    int32_t band_base, int32_t band_count, double c2_max_gap,
    double c2_min_score, int32_t c2_min_align_len, double c2_heur_pident,
    const uint8_t* tbuf_all, const int64_t* tbuf_goff,
    const int64_t* t_off_all, const int64_t* t_len_all,
    const int64_t* p_qbegin, const int64_t* p_qend,
    const int64_t* p_tbegin, const int64_t* p_tend, const uint8_t* p_rc,
    const int64_t* path_goff,
    const int64_t* seq_sizes_all, const int64_t* seq_goff,
    int64_t interval, int32_t k,
    int64_t ext2_base, double total_bases, double max_evalue,
    double min_qcov_hsp, double min_identity,
    int32_t x, int32_t o, int32_t e,
    int32_t adaptive, int32_t min_wf_len, int32_t max_dist_diff,
    int64_t n_genomes, int32_t n_threads,
    // optional device pseudo-alignment rows, as align_paths takes them:
    // pre_cnt_all/pre_off_all per path (path_goff ranges), pre_off_all
    // indexing pre_rows_all directly; null pre_cnt_all: none
    const int64_t* pre_rows_all, const int64_t* pre_off_all,
    const int64_t* pre_cnt_all,
    double* out_rows, const int64_t* row_goff, int64_t* out_counts) {
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        for (;;) {
            int64_t g = next.fetch_add(1, std::memory_order_relaxed);
            if (g >= n_genomes) return;
            const int64_t p0 = path_goff[g];
            const int64_t np = path_goff[g + 1] - p0;
            const int64_t s0 = seq_goff[g];
            const bool pre = pre_cnt_all != nullptr;
            out_counts[g] = align_paths(
                qcodes, qlen, qk, qv, nq, qtab, bbits,
                cmp_k, cmp_min_prefix, band_base, band_count, c2_max_gap,
                c2_min_score, c2_min_align_len, c2_heur_pident,
                tbuf_all + tbuf_goff[g], t_off_all + p0, t_len_all + p0,
                p_qbegin + p0, p_qend + p0, p_tbegin + p0, p_tend + p0,
                p_rc + p0, np,
                seq_sizes_all + s0, seq_goff[g + 1] - s0, interval, k,
                ext2_base, total_bases, max_evalue, min_qcov_hsp, min_identity,
                x, o, e, adaptive, min_wf_len, max_dist_diff,
                pre ? pre_rows_all : nullptr, pre ? pre_off_all + p0 : nullptr,
                pre ? pre_cnt_all + p0 : nullptr,
                out_rows + row_goff[g] * 18, row_goff[g + 1] - row_goff[g],
                0, nullptr, 0, nullptr, nullptr, nullptr);
        }
    };
    int nt = n_threads > 0 ? n_threads
                           : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if ((int64_t)nt > n_genomes) nt = (int)n_genomes;
    if (nt <= 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        pool.reserve((size_t)nt);
        for (int i = 0; i < nt; ++i) pool.emplace_back(worker);
        for (auto& t : pool) t.join();
    }
}

// ---------------------------------------------------------------------------
// Batched phase-3 chaining for the MANY-HIT regime: per-genome anchor sort +
// nested-anchor removal + chain1 forward DP + backtracking in one call,
// threaded across genomes.  Exact mirror of ops/chaining.py
// (clear_substr_pairs + chain + _chain_backtrack; ref: lib-chaining.go
// :122-633, lib-index-search.go:826-953) — the per-genome Python loop in
// search.py::_chain_genomes costs ~0.6 ms/genome at 1000 genome hits/query.
//
// Inputs: concatenated per-genome anchors in their ORIGINAL order;
// off[g]..off[g+1] is genome g's slice.  Outputs use disjoint per-genome
// slots so genomes can run on any thread:
//   kept_idx   at off[g] (kept_counts[g] entries): local indices (within
//              genome g, original order) of surviving anchors, sorted by
//              (QBegin asc, QEnd desc, TBegin asc)
//   path_nodes at 2*off[g] (path_node_counts[g] entries): concatenated
//              paths; values index the kept array
//   path_lens  at off[g] (path_counts[g] entries)
//   scores[g]  best chain score (chain() return, 0 if no anchors)
void chain1_batch(const int32_t* qb, const int32_t* tb, const int32_t* ln,
                  const int64_t* off, int64_t n_genomes, int32_t k,
                  float max_gap, float min_score, int32_t max_dist,
                  int64_t top_chains, int32_t n_threads,
                  int64_t* kept_idx, int64_t* kept_counts,
                  int32_t* path_nodes, int64_t* path_node_counts,
                  int32_t* path_lens, int64_t* path_counts, float* scores) {
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        std::vector<int32_t> ord, sq, st, sl, tmp;
        std::vector<float> ms;
        std::vector<int64_t> prev;
        std::vector<int8_t> dirs;
        std::vector<uint8_t> visited;
        std::vector<uint64_t> order;
        for (;;) {
            int64_t g = next.fetch_add(1, std::memory_order_relaxed);
            if (g >= n_genomes) return;
            const int64_t base = off[g];
            const int64_t n0 = off[g + 1] - base;
            const int32_t* gq = qb + base;
            const int32_t* gt = tb + base;
            const int32_t* gl = ln + base;
            int64_t* kidx = kept_idx + base;
            int32_t* pnodes = path_nodes + 2 * base;
            int32_t* plens = path_lens + base;
            scores[g] = 0.0f;
            kept_counts[g] = 0;
            path_counts[g] = 0;
            path_node_counts[g] = 0;
            if (n0 == 0) continue;

            // sort by (QBegin asc, QEnd desc, TBegin asc); stable = lexsort
            int64_t n1;
            if (n0 > 1) {
                ord.resize((size_t)n0);
                std::iota(ord.begin(), ord.end(), 0);
                std::stable_sort(ord.begin(), ord.end(),
                                 [&](int32_t a, int32_t b) {
                    if (gq[a] != gq[b]) return gq[a] < gq[b];
                    const int32_t ea = gq[a] + gl[a], eb = gq[b] + gl[b];
                    if (ea != eb) return ea > eb;
                    return gt[a] < gt[b];
                });
                sq.resize((size_t)n0); st.resize((size_t)n0); sl.resize((size_t)n0);
                for (int64_t i = 0; i < n0; ++i) {
                    const int32_t o = ord[(size_t)i];
                    sq[(size_t)i] = gq[o]; st[(size_t)i] = gt[o]; sl[(size_t)i] = gl[o];
                }
                // nested-anchor removal: drop marks over the FULL sorted
                // array (dropped anchors still participate as j), compact
                n1 = 1;
                kidx[0] = ord[0];  // position 0 is never dropped
                for (int64_t i = 1; i < n0; ++i) {
                    const int32_t vqe = sq[(size_t)i] + sl[(size_t)i];
                    int32_t upbound = vqe - k;
                    if (upbound < 0) upbound = 0;
                    const int32_t vtb = st[(size_t)i];
                    const int32_t vte = vtb + sl[(size_t)i];
                    int64_t lo = 0, hi = i + 1;
                    while (lo < hi) {
                        const int64_t mid = (lo + hi) >> 1;
                        if (sq[(size_t)mid] < upbound) lo = mid + 1; else hi = mid;
                    }
                    bool drop = false;
                    for (int64_t j = lo; j < i; ++j) {
                        if (vqe <= sq[(size_t)j] + sl[(size_t)j] &&
                            vtb >= st[(size_t)j] &&
                            vte <= st[(size_t)j] + sl[(size_t)j]) { drop = true; break; }
                    }
                    if (!drop) {
                        // compact in place: positions < i already final only
                        // if no drops happened before; write to parallel slot
                        kidx[n1] = ord[(size_t)i];
                        ++n1;
                    }
                }
                if (n1 != n0) {
                    // re-gather compacted sorted arrays from kept indices
                    for (int64_t i = 0; i < n1; ++i) {
                        const int64_t o = kidx[i];
                        sq[(size_t)i] = gq[o]; st[(size_t)i] = gt[o]; sl[(size_t)i] = gl[o];
                    }
                }
            } else {
                kidx[0] = 0;
                n1 = 1;
            }
            kept_counts[g] = n1;

            if (n1 == 1) {
                const int32_t l0 = (n0 > 1) ? sl[0] : gl[0];
                const float w = seed_weight_f((float)l0);
                scores[g] = w;
                if (w >= min_score) {
                    pnodes[0] = 0;
                    plens[0] = 1;
                    path_counts[g] = 1;
                    path_node_counts[g] = 1;
                }
                continue;
            }

            // forward DP (identical to chain1_forward)
            ms.resize((size_t)n1);
            prev.resize((size_t)n1);
            dirs.resize((size_t)n1);
            chain1_forward(sq.data(), st.data(), sl.data(), n1,
                           max_gap, min_score, max_dist,
                           ms.data(), prev.data(), dirs.data());

            // backtrack (mirror of ops/chaining.py::_chain_backtrack)
            order.resize((size_t)n1);
            for (int64_t i = 0; i < n1; ++i) {
                uint32_t sb;
                std::memcpy(&sb, &ms[(size_t)i], 4);
                order[(size_t)i] = ((uint64_t)sb << 32) | (uint64_t)i;
            }
            std::sort(order.begin(), order.end(), std::greater<uint64_t>());
            visited.assign((size_t)n1, 0);
            float max_score = 0.0f;
            bool first = true;
            int64_t oi = 0, n_checked = 0, node_w = 0, n_paths = 0;
            for (;;) {
                ++n_checked;
                if (top_chains > 0 && n_checked > top_chains) break;
                float M = 0.0f;
                int64_t Mi = -1;
                while (oi < n1) {
                    const int64_t ci = (int64_t)(order[(size_t)oi] & 0xffffffffu);
                    ++oi;
                    if (!visited[(size_t)ci]) { M = ms[(size_t)ci]; Mi = ci; break; }
                }
                if (Mi < 0 || M < min_score) break;
                if (first) { max_score = M; first = false; }
                tmp.clear();
                int64_t i = Mi;
                for (;;) {
                    const int64_t j = prev[(size_t)i];
                    const bool change_dir = (i != j) && dirs[(size_t)j] != 0 &&
                                            dirs[(size_t)i] != dirs[(size_t)j];
                    if (visited[(size_t)j] && !change_dir) {
                        visited[(size_t)i] = 1;  // abandoned branch
                        break;
                    }
                    tmp.push_back((int32_t)i);
                    visited[(size_t)i] = 1;
                    if (i == j || change_dir) {
                        if (change_dir) tmp.push_back((int32_t)j);
                        for (size_t z = tmp.size(); z-- > 0;)
                            pnodes[node_w++] = tmp[z];
                        plens[n_paths++] = (int32_t)tmp.size();
                        break;
                    }
                    i = j;
                }
            }
            scores[g] = max_score;
            path_counts[g] = n_paths;
            path_node_counts[g] = node_w;
        }
    };
    int nt = n_threads > 0 ? n_threads
                           : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if ((int64_t)nt > n_genomes) nt = (int)n_genomes;
    if (nt <= 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        pool.reserve((size_t)nt);
        for (int i = 0; i < nt; ++i) pool.emplace_back(worker);
        for (auto& t : pool) t.join();
    }
}

}  // extern "C"
