"""Native (C++) runtime kernels, compiled on demand and loaded via ctypes.

The Python/NumPy implementations in ops/ remain the reference semantics;
these kernels are exact mirrors (cross-checked by tests/test_native.py)
used for the host hot loops: WFA alignment, chaining DPs, anchor dedup.

Set LEXICMAP_TPU_NO_NATIVE=1 to force the pure-Python path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "core.cpp")
_LIB = os.path.join(_HERE, "libcore.so")

_lib = None


def _build() -> bool:
    try:
        src_mtime = os.path.getmtime(_SRC)
        if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= src_mtime:
            return True
        # unique tmp name: concurrent builds (forked index workers) must
        # not race on the rename
        tmp = f"{_LIB}.{os.getpid()}.tmp"
        cmd = [
            # -ffp-contract=off: GCC at -O3 otherwise contracts float
            # mul+add chains into FMAs, which rounds differently (1-2 ulp)
            # from the reference's Go on amd64 (gc emits no auto-FMA
            # there), from numpy, and from the device DP — chain scores
            # must be bit-identical across all four
            "g++", "-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
            "-pthread", "-shared", "-fPIC", _SRC, "-o", tmp,
        ]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB)
        return True
    except Exception as exc:  # pragma: no cover
        print(f"lexicmap_tpu: native build failed ({exc}); using Python path",
              file=sys.stderr)
        return False


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get("LEXICMAP_TPU_NO_NATIVE"):
        return None
    if not _build():
        return None
    lib = ctypes.CDLL(_LIB)
    i8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    s8p = np.ctypeslib.ndpointer(dtype=np.int8, flags="C_CONTIGUOUS")

    # raw pointers for the hottest per-HSP call: ndpointer validation
    # (from_param + cast) costs more than the C work for short alignments
    lib.wfa_align.restype = ctypes.c_int64
    lib.wfa_align.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.wfa_align_stats.restype = ctypes.c_int64
    lib.wfa_align_stats.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.chain2_forward.restype = None
    lib.chain2_forward.argtypes = [
        i64p, i64p, i64p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_double, f64p, i64p,
    ]
    lib.chain1_forward.restype = None
    lib.chain1_forward.argtypes = [
        i32p, i32p, i32p, ctypes.c_int64,
        ctypes.c_float, ctypes.c_float, ctypes.c_int32, f32p, i64p, s8p,
    ]
    lib.clear_substr_pairs_mark.restype = None
    lib.clear_substr_pairs_mark.argtypes = [
        i32p, i32p, i32p, ctypes.c_int64, ctypes.c_int32, i8p,
    ]
    lib.chain1_batch.restype = None
    lib.chain1_batch.argtypes = [
        i32p, i32p, i32p, i64p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_float, ctypes.c_float, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int32,
        i64p, i64p, i32p, i64p, i32p, i64p, f32p,
    ]
    lib.chain3_chain.restype = ctypes.c_int32
    lib.chain3_chain.argtypes = [
        i32p, i32p, i32p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    u64p = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
    lib.chain2_backtrack.restype = ctypes.c_int64
    lib.chain2_backtrack.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_double, ctypes.c_int32, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.xor_argmin_batch.restype = None
    lib.xor_argmin_batch.argtypes = [
        u64p, ctypes.c_int64, u64p, ctypes.c_int64, ctypes.c_int32, i64p,
    ]
    lib.dust_batch.restype = None
    lib.dust_batch.argtypes = [u64p, ctypes.c_int64, ctypes.c_int32, i8p]
    lib.compare_probe.restype = ctypes.c_int64
    lib.compare_probe.argtypes = [
        u64p, u32p, ctypes.c_int64,
        u64p, u64p, ctypes.c_int64,
        i8p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, i64p, i8p, ctypes.c_int64,
    ]
    lib.compare_probe_codes.restype = ctypes.c_int64
    lib.compare_probe_codes.argtypes = [
        u64p, u32p, ctypes.c_int64,
        i8p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, i64p, i8p, ctypes.c_int64,
    ]
    lib.unpack_2bit_window.restype = None
    lib.unpack_2bit_window.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.kmers_fwd_rc_batch.restype = None
    lib.kmers_fwd_rc_batch.argtypes = [i8p, ctypes.c_int64, ctypes.c_int32, u64p, u64p]
    lib.range_match.restype = ctypes.c_int64
    lib.range_match.argtypes = [
        u64p, i64p, u64p,
        i64p, i64p,
        u64p, u64p, u64p,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        i64p, i64p, i64p, ctypes.c_int64,
    ]
    lib.compare_prepare.restype = ctypes.c_int64
    lib.compare_prepare.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.hsp_extend_wfa_batch.restype = ctypes.c_int64
    lib.hsp_extend_wfa_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p,
    ]
    lib.align_paths.restype = ctypes.c_int64
    lib.align_paths.argtypes = (
        [ctypes.c_void_p, ctypes.c_int64]            # qcodes
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]  # qk, qv, nq
        + [ctypes.c_void_p, ctypes.c_int32]          # qtab, bbits
        + [ctypes.c_int32] * 2                       # cmp_k, cmp_min_prefix
        + [ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
           ctypes.c_double, ctypes.c_int32, ctypes.c_double]  # chain2 opts
        + [ctypes.c_void_p] * 3                      # tbuf, t_off, t_len
        + [ctypes.c_void_p] * 5                      # p_qbegin..p_rc
        + [ctypes.c_int64]                           # n_paths
        + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32]  # seq_sizes...
        + [ctypes.c_int64, ctypes.c_double, ctypes.c_double,
           ctypes.c_double, ctypes.c_double]         # ext2, totals, filters
        + [ctypes.c_int32] * 6                       # wfa params
        + [ctypes.c_void_p] * 3                      # pre_rows, pre_off, pre_cnt
        + [ctypes.c_void_p, ctypes.c_int64]          # out rows
        + [ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64]  # span_mode, span_buf, span_cap
        + [ctypes.c_void_p] * 3                      # inj_ops, inj_off, inj_len
    )
    lib.collect_anchors.restype = ctypes.c_int64
    lib.collect_anchors.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,            # values_ptrs, eoff_ptrs
        i32p, i64p, i64p, i64p, ctypes.c_int64,      # chunk_of_hit..n_hits
        ctypes.c_void_p, i64p, i64p,                 # pos_flat, pos_off, npos
        ctypes.c_int32,                              # k
        i64p, i32p, i32p, i32p, i8p, i8p,            # outputs
        ctypes.c_int64, i64p,                        # cap, need
    ]
    lib.align_paths_batch.restype = None
    lib.align_paths_batch.argtypes = (
        [ctypes.c_void_p, ctypes.c_int64]            # qcodes
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]  # qk, qv, nq
        + [ctypes.c_void_p, ctypes.c_int32]          # qtab, bbits
        + [ctypes.c_int32] * 2                       # cmp_k, cmp_min_prefix
        + [ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
           ctypes.c_double, ctypes.c_int32, ctypes.c_double]  # chain2 opts
        + [ctypes.c_void_p, ctypes.c_void_p]         # tbuf_all, tbuf_goff
        + [ctypes.c_void_p, ctypes.c_void_p]         # t_off_all, t_len_all
        + [ctypes.c_void_p] * 5                      # p_qbegin..p_rc
        + [ctypes.c_void_p]                          # path_goff
        + [ctypes.c_void_p, ctypes.c_void_p]         # seq_sizes_all, seq_goff
        + [ctypes.c_int64, ctypes.c_int32]           # interval, k
        + [ctypes.c_int64, ctypes.c_double, ctypes.c_double,
           ctypes.c_double, ctypes.c_double]         # ext2, totals, filters
        + [ctypes.c_int32] * 6                       # wfa params
        + [ctypes.c_int64, ctypes.c_int32]           # n_genomes, n_threads
        + [ctypes.c_void_p] * 3                      # pre_rows, pre_off, pre_cnt
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]  # rows, goff, counts
    )
    lib.capture_native.restype = ctypes.c_int64
    lib.capture_native.argtypes = [
        u64p, u64p, ctypes.c_int64, ctypes.c_void_p, u64p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        u64p, i64p, u32p, ctypes.c_int64,
    ]
    lib.fill_deserts_native.restype = ctypes.c_int64
    lib.fill_deserts_native.argtypes = [
        u64p, u64p, ctypes.c_int64, u32p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, u64p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, i64p, u64p, i64p, ctypes.c_int64, ctypes.c_int32,
    ]
    _lib = lib
    return _lib


def wfa_align_native(q: np.ndarray, t: np.ndarray, x=4, o=6, e=2,
                     adaptive=True, min_wf_len=10, max_dist_diff=50):
    """Returns run-length ops [(op, n), ...] or None (fallback needed)."""
    lib = get_lib()
    if lib is None:
        return None
    n, m = int(q.shape[0]), int(t.shape[0])
    cap = 2 * (n + m) + 16
    out = np.empty(cap, dtype=np.uint8)
    q = np.ascontiguousarray(q, dtype=np.uint8)
    t = np.ascontiguousarray(t, dtype=np.uint8)
    w = lib.wfa_align(
        q.ctypes.data, n, t.ctypes.data, m,
        x, o, e, 1 if adaptive else 0, min_wf_len, max_dist_diff,
        out.ctypes.data, cap,
    )
    if w < 0:
        return None
    if w == 0:
        return []
    buf = out[:w]
    # vectorized run-length encoding
    bounds = np.nonzero(buf[1:] != buf[:-1])[0] + 1
    starts = np.concatenate(([0], bounds))
    ends = np.concatenate((bounds, [w]))
    return [
        (chr(buf[s]), int(e - s)) for s, e in zip(starts, ends)
    ]


def wfa_align_stats_native(q, t, x=4, o=6, e=2,
                           adaptive=True, min_wf_len=10, max_dist_diff=50):
    """WFA + single-pass trimmed-alignment stats.  Returns
    (stats int64[10], ops_bytes) or None (fallback needed); see core.cpp
    wfa_align_stats for the stats layout."""
    lib = get_lib()
    if lib is None:
        return None
    n, m = int(q.shape[0]), int(t.shape[0])
    cap = 2 * (n + m) + 16
    out = np.empty(cap, dtype=np.uint8)
    stats = np.zeros(10, dtype=np.int64)
    q = np.ascontiguousarray(q, dtype=np.uint8)
    t = np.ascontiguousarray(t, dtype=np.uint8)
    w = lib.wfa_align_stats(
        q.ctypes.data, n, t.ctypes.data, m,
        x, o, e, 1 if adaptive else 0, min_wf_len, max_dist_diff,
        out.ctypes.data, cap, stats.ctypes.data,
    )
    if w < 0:
        return None
    return stats, out[:w]


def chain2_forward_native(qb, tb, ln, band_base, band_count, max_gap):
    lib = get_lib()
    if lib is None:
        return None
    n = int(qb.shape[0])
    scores = np.empty(n, dtype=np.float64)
    prev = np.empty(n, dtype=np.int64)
    lib.chain2_forward(
        np.ascontiguousarray(qb, dtype=np.int64),
        np.ascontiguousarray(tb, dtype=np.int64),
        np.ascontiguousarray(ln, dtype=np.int64),
        n, band_base, band_count, float(max_gap), scores, prev,
    )
    return scores, prev


def chain1_forward_native(qb, tb, ln, max_gap, min_score, max_dist):
    lib = get_lib()
    if lib is None:
        return None
    n = int(qb.shape[0])
    scores = np.empty(n, dtype=np.float32)
    prev = np.empty(n, dtype=np.int64)
    dirs = np.empty(n, dtype=np.int8)
    lib.chain1_forward(
        np.ascontiguousarray(qb, dtype=np.int32),
        np.ascontiguousarray(tb, dtype=np.int32),
        np.ascontiguousarray(ln, dtype=np.int32),
        n, float(max_gap), float(min_score), int(max_dist), scores, prev, dirs,
    )
    return scores, prev, dirs


def chain1_batch_native(genomes, k, max_gap, min_score, max_dist,
                        top_chains, threads=0):
    """Batched phase-3 chaining (sort + nested-anchor removal + chain1 DP +
    backtrack) for many genomes in ONE native call, threaded across genomes.
    `genomes` is a list of (qbegin, tbegin, length) int32 arrays in their
    original (uncleaned) order.  Returns a list of
    (kept_idx int64[], paths list[int32[]], score float) — kept_idx are the
    surviving anchors (already in chaining sort order) as indices into the
    input arrays; path values index kept_idx — or None if the lib is
    unavailable.  Bit-identical to ops/chaining.py (tests/test_native.py)."""
    lib = get_lib()
    if lib is None:
        return None
    n_g = len(genomes)
    if n_g == 0:
        return []
    off = np.zeros(n_g + 1, dtype=np.int64)
    for i, (q, _, _) in enumerate(genomes):
        off[i + 1] = off[i] + q.shape[0]
    total = int(off[-1])
    qb = np.empty(total, dtype=np.int32)
    tb = np.empty(total, dtype=np.int32)
    ln = np.empty(total, dtype=np.int32)
    for i, (q, t, l) in enumerate(genomes):
        s, e = off[i], off[i + 1]
        qb[s:e] = q
        tb[s:e] = t
        ln[s:e] = l
    kept_idx = np.empty(total, dtype=np.int64)
    kept_counts = np.empty(n_g, dtype=np.int64)
    path_nodes = np.empty(2 * total, dtype=np.int32)
    path_node_counts = np.empty(n_g, dtype=np.int64)
    path_lens = np.empty(total, dtype=np.int32)
    path_counts = np.empty(n_g, dtype=np.int64)
    scores = np.empty(n_g, dtype=np.float32)
    lib.chain1_batch(
        qb, tb, ln, off, n_g, int(k),
        float(max_gap), float(min_score), int(max_dist),
        int(top_chains), int(threads),
        kept_idx, kept_counts, path_nodes, path_node_counts,
        path_lens, path_counts, scores,
    )
    out = []
    for g in range(n_g):
        s = int(off[g])
        kept = kept_idx[s : s + int(kept_counts[g])]
        npaths = int(path_counts[g])
        if npaths:
            lens = path_lens[s : s + npaths]
            nodes = path_nodes[2 * s : 2 * s + int(path_node_counts[g])]
            paths = np.split(nodes, np.cumsum(lens[:-1])) if npaths > 1 else [nodes]
        else:
            paths = []
        out.append((kept, paths, float(scores[g])))
    return out


def clear_mark_native(qb, tb, ln, k):
    lib = get_lib()
    if lib is None:
        return None
    n = int(qb.shape[0])
    drop = np.empty(n, dtype=np.uint8)
    lib.clear_substr_pairs_mark(
        np.ascontiguousarray(qb, dtype=np.int32),
        np.ascontiguousarray(tb, dtype=np.int32),
        np.ascontiguousarray(ln, dtype=np.int32),
        n, int(k), drop,
    )
    return drop.astype(bool)


def collect_anchors_native(chunk_ptrs, chunk_of_hit, eidx, lcp, qmask,
                           pos_flat, pos_off, npos, k):
    """Phase 2b in one C call: postings gather + bit-slice decode + stable
    genome grouping (mirror of the numpy tail of _collect_anchors).
    chunk_ptrs: per chunk, (values_address, entry_offsets_address) of the
    mmap'd columnar arrays.  Returns (ref, begin_q, begin_t, length, rc_q,
    rc_t) with anchors stably grouped by ascending genome code, or None."""
    lib = get_lib()
    if lib is None:
        return None
    n_hits = int(eidx.shape[0])
    vptr = np.array([a for a, _ in chunk_ptrs], dtype=np.uint64)
    eptr = np.array([b for _, b in chunk_ptrs], dtype=np.uint64)
    chunk_of_hit = np.ascontiguousarray(chunk_of_hit, dtype=np.int32)
    eidx = np.ascontiguousarray(eidx, dtype=np.int64)
    lcp = np.ascontiguousarray(lcp, dtype=np.int64)
    qmask = np.ascontiguousarray(qmask, dtype=np.int64)
    pos_flat = np.ascontiguousarray(pos_flat, dtype=np.uint32)
    pos_off = np.ascontiguousarray(pos_off, dtype=np.int64)
    npos = np.ascontiguousarray(npos, dtype=np.int64)
    need = np.zeros(1, dtype=np.int64)
    cap = max(8 * n_hits, 4096)
    while True:
        ref = np.empty(cap, dtype=np.int64)
        bq = np.empty(cap, dtype=np.int32)
        bt = np.empty(cap, dtype=np.int32)
        ln = np.empty(cap, dtype=np.int32)
        rcq = np.empty(cap, dtype=np.uint8)
        rct = np.empty(cap, dtype=np.uint8)
        w = lib.collect_anchors(
            vptr.ctypes.data, eptr.ctypes.data,
            chunk_of_hit, eidx, lcp, qmask, n_hits,
            pos_flat.ctypes.data, pos_off, npos, int(k),
            ref, bq, bt, ln, rcq, rct, cap, need,
        )
        if w == -1:
            cap = int(need[0])
            continue
        return (
            ref[:w], bq[:w], bt[:w], ln[:w],
            rcq[:w].astype(bool), rct[:w].astype(bool),
        )


def align_paths_batch_native(ctx_args_list, threads=0, ctx_kw_list=None):
    """Fused phase 4 for MANY genomes of one query in a single threaded C
    call.  `ctx_args_list` is a list of align_paths_native arg tuples (the
    ctx["args"] built by search.py::_align_prepare_native — per-query
    constants must be identical across entries); `ctx_kw_list` the matching
    ctx["kw"] dicts (device pseudo-alignment rows, pre_cnt None for a
    genome without them), or None.  Returns a list with one
    entry per genome: float64 [n, 18] row matrix, or the string "overflow"
    (caller retries that genome via align_paths_native) or "wfa_fail"
    (caller uses the Python per-chain path).  None if the lib is missing."""
    lib = get_lib()
    if lib is None or not ctx_args_list:
        return None
    a0 = ctx_args_list[0]
    (qcodes, qk, qv, qtab, bbits, cmp_k, cmp_min_prefix,
     band_base, band_count, c2_max_gap, c2_min_score, c2_min_align_len,
     c2_heur) = a0[:13]
    (interval, k) = a0[22:24]
    (ext2_base, total_bases, max_evalue, min_qcov_hsp, min_identity) = a0[24:29]
    qcodes = np.ascontiguousarray(qcodes, dtype=np.uint8)
    qk = np.ascontiguousarray(qk, dtype=np.uint64)
    qv = np.ascontiguousarray(qv, dtype=np.uint32)
    tab_ptr = 0
    if qtab is not None:
        qtab = np.ascontiguousarray(qtab, dtype=np.uint32)
        tab_ptr = qtab.ctypes.data

    n_g = len(ctx_args_list)
    i64 = lambda x: np.ascontiguousarray(x, dtype=np.int64)
    tbuf_goff = np.zeros(n_g + 1, dtype=np.int64)
    path_goff = np.zeros(n_g + 1, dtype=np.int64)
    seq_goff = np.zeros(n_g + 1, dtype=np.int64)
    row_goff = np.zeros(n_g + 1, dtype=np.int64)
    tbufs, toffs, tlens, pqb, pqe, ptb, pte, prc, seqs = \
        [], [], [], [], [], [], [], [], []
    for i, args in enumerate(ctx_args_list):
        tbuf, t_off, t_len = args[13], i64(args[14]), i64(args[15])
        tbufs.append(np.ascontiguousarray(tbuf, dtype=np.uint8))
        toffs.append(t_off)
        tlens.append(t_len)
        pqb.append(i64(args[16]))
        pqe.append(i64(args[17]))
        ptb.append(i64(args[18]))
        pte.append(i64(args[19]))
        prc.append(np.ascontiguousarray(args[20], dtype=np.uint8))
        seqs.append(i64(args[21]))
        n_paths = t_off.shape[0]
        tbuf_goff[i + 1] = tbuf_goff[i] + tbufs[-1].shape[0]
        path_goff[i + 1] = path_goff[i] + n_paths
        seq_goff[i + 1] = seq_goff[i] + seqs[-1].shape[0]
        row_goff[i + 1] = row_goff[i] + max(64, 8 * n_paths)
    cat = np.concatenate
    tbuf_all = cat(tbufs) if tbufs else np.zeros(0, dtype=np.uint8)
    t_off_all = cat(toffs)
    t_len_all = cat(tlens)
    p_qbegin, p_qend = cat(pqb), cat(pqe)
    p_tbegin, p_tend = cat(ptb), cat(pte)
    p_rc = cat(prc)
    seq_sizes_all = cat(seqs)
    pre_ptrs = (0, 0, 0)
    if ctx_kw_list is not None and any(kw["pre_cnt"] is not None for kw in ctx_kw_list):
        # per path: -1 (host compare) unless the genome brought device rows;
        # offsets made absolute in the concatenated row block
        pre_cnt_all = np.full(int(path_goff[-1]), -1, dtype=np.int64)
        pre_off_all = np.zeros(int(path_goff[-1]), dtype=np.int64)
        blocks, base = [], 0
        for g, kw in enumerate(ctx_kw_list):
            if kw["pre_cnt"] is None:
                continue
            s, t = int(path_goff[g]), int(path_goff[g + 1])
            pre_cnt_all[s:t] = kw["pre_cnt"]
            pre_off_all[s:t] = i64(kw["pre_off"]) + base
            blocks.append(i64(kw["pre_rows"]).reshape(-1, 8))
            base += blocks[-1].shape[0]
        pre_rows_all = cat(blocks) if base else np.zeros((1, 8), dtype=np.int64)
        pre_ptrs = (pre_rows_all.ctypes.data, pre_off_all.ctypes.data,
                    pre_cnt_all.ctypes.data)
    out_rows = np.empty((int(row_goff[-1]), 18), dtype=np.float64)
    out_counts = np.empty(n_g, dtype=np.int64)
    lib.align_paths_batch(
        qcodes.ctypes.data, int(qcodes.shape[0]),
        qk.ctypes.data, qv.ctypes.data, int(qk.shape[0]),
        tab_ptr, int(bbits),
        int(cmp_k), int(cmp_min_prefix),
        int(band_base), int(band_count), float(c2_max_gap),
        float(c2_min_score), int(c2_min_align_len), float(c2_heur),
        tbuf_all.ctypes.data, tbuf_goff.ctypes.data,
        t_off_all.ctypes.data, t_len_all.ctypes.data,
        p_qbegin.ctypes.data, p_qend.ctypes.data,
        p_tbegin.ctypes.data, p_tend.ctypes.data, p_rc.ctypes.data,
        path_goff.ctypes.data,
        seq_sizes_all.ctypes.data, seq_goff.ctypes.data,
        int(interval), int(k),
        int(ext2_base), float(total_bases), float(max_evalue),
        float(min_qcov_hsp), float(min_identity),
        4, 6, 2, 1, 10, 50,
        n_g, int(threads),
        *pre_ptrs,
        out_rows.ctypes.data, row_goff.ctypes.data, out_counts.ctypes.data,
    )
    out = []
    for g in range(n_g):
        c = int(out_counts[g])
        if c == -1:
            out.append("overflow")
        elif c == -2:
            out.append("wfa_fail")
        else:
            s = int(row_goff[g])
            out.append(out_rows[s : s + c])
    return out


def capture_native_call(fwd, rc, exclude, masks, k, prefix_len, check_shorter):
    """Returns (kmers[m], counts[m], pos_flat) or None."""
    lib = get_lib()
    if lib is None:
        return None
    n = int(fwd.shape[0])
    m = int(masks.shape[0])
    out_kmers = np.zeros(m, dtype=np.uint64)
    out_counts = np.zeros(m, dtype=np.int64)
    cap = max(8 * m, 1024)
    excl_ptr = None
    if exclude is not None:
        exclude = np.ascontiguousarray(exclude, dtype=np.uint8)
        excl_ptr = exclude.ctypes.data
    fwd = np.ascontiguousarray(fwd, dtype=np.uint64)
    rc = np.ascontiguousarray(rc, dtype=np.uint64)
    masks = np.ascontiguousarray(masks, dtype=np.uint64)
    while True:
        out_pos = np.empty(cap, dtype=np.uint32)
        w = lib.capture_native(
            fwd, rc, n, excl_ptr, masks, m,
            k, prefix_len, 1 if check_shorter else 0,
            out_kmers, out_counts, out_pos, cap,
        )
        if w == -1:
            cap *= 4
            continue
        if w == -2:
            return out_kmers, out_counts, np.empty(0, dtype=np.uint32)
        return out_kmers, out_counts, out_pos[:w]


def fill_deserts_native_call(
    fwd, rc, locs, interval_excluded, masks, k, prefix_len,
    max_desert, seed_dist, seed_pos_r, flags=0,
):
    """Returns list of (mask_idx, kmer, loc) or None."""
    lib = get_lib()
    if lib is None:
        return None
    nk = int(fwd.shape[0])
    nlocs = int(locs.shape[0])
    excl_ptr = None
    n_excl = 0
    if interval_excluded is not None:
        interval_excluded = np.ascontiguousarray(interval_excluded, dtype=np.uint8)
        excl_ptr = interval_excluded.ctypes.data
        n_excl = int(interval_excluded.shape[0])
    fwd = np.ascontiguousarray(fwd, dtype=np.uint64)
    rc = np.ascontiguousarray(rc, dtype=np.uint64)
    locs = np.ascontiguousarray(locs, dtype=np.uint32)
    masks = np.ascontiguousarray(masks, dtype=np.uint64)
    cap = max(4 * (nk // max(seed_dist, 1) + 16), 4096)
    while True:
        om = np.empty(cap, dtype=np.int64)
        ok = np.empty(cap, dtype=np.uint64)
        ol = np.empty(cap, dtype=np.int64)
        w = lib.fill_deserts_native(
            fwd, rc, nk, locs, nlocs, excl_ptr, n_excl,
            masks, int(masks.shape[0]), k, prefix_len,
            max_desert, seed_dist, seed_pos_r, om, ok, ol, cap, flags,
        )
        if w == -1:
            cap *= 4
            continue
        return [(int(om[i]), int(ok[i]), int(ol[i])) for i in range(w)]


def xor_argmin_batch_native(sorted_vals, queries, bits):
    lib = get_lib()
    if lib is None:
        return None
    nq = int(queries.shape[0])
    out = np.empty(nq, dtype=np.int64)
    lib.xor_argmin_batch(
        np.ascontiguousarray(sorted_vals, dtype=np.uint64), int(sorted_vals.shape[0]),
        np.ascontiguousarray(queries, dtype=np.uint64), nq, int(bits), out,
    )
    return out


def dust_batch_native(kmers, k):
    lib = get_lib()
    if lib is None:
        return None
    n = int(kmers.shape[0])
    out = np.empty(n, dtype=np.uint8)
    lib.dust_batch(np.ascontiguousarray(kmers, dtype=np.uint64), n, int(k), out)
    return out.astype(bool)


def chain2_backtrack_native(qb, tb, ln, scores, prev, min_score, min_align_len, heur):
    """Returns (rows [n,8] int64, pidents [n] float64) or None."""
    lib = get_lib()
    if lib is None:
        return None
    n = int(qb.shape[0])
    cap = max(n, 64)
    out = np.empty(cap * 8, dtype=np.int64)
    out_p = np.empty(cap, dtype=np.float64)
    totals = np.zeros(3, dtype=np.int64)
    qb = np.ascontiguousarray(qb, dtype=np.int64)
    tb = np.ascontiguousarray(tb, dtype=np.int64)
    ln = np.ascontiguousarray(ln, dtype=np.int64)
    scores = np.ascontiguousarray(scores, dtype=np.float64)
    prev = np.ascontiguousarray(prev, dtype=np.int64)
    w = lib.chain2_backtrack(
        qb.ctypes.data, tb.ctypes.data, ln.ctypes.data,
        scores.ctypes.data, prev.ctypes.data,
        n, float(min_score), int(min_align_len), float(heur),
        out.ctypes.data, out_p.ctypes.data, cap, totals.ctypes.data,
    )
    return out[: w * 8].reshape(w, 8), out_p[:w], totals


def compare_probe_native(qk, qv, tf, tr, valid, mprefix, k, begin, end):
    """Returns (aq, at, al, arc) anchor arrays or None."""
    lib = get_lib()
    if lib is None:
        return None
    nt = int(tf.shape[0])
    cap = max(8 * nt, 4096)
    qk = np.ascontiguousarray(qk, dtype=np.uint64)
    qv = np.ascontiguousarray(qv, dtype=np.uint32)
    tf = np.ascontiguousarray(tf, dtype=np.uint64)
    tr = np.ascontiguousarray(tr, dtype=np.uint64)
    valid = np.ascontiguousarray(valid.astype(np.uint8))
    while True:
        aq = np.empty(cap, dtype=np.int64)
        at = np.empty(cap, dtype=np.int64)
        al = np.empty(cap, dtype=np.int64)
        arc = np.empty(cap, dtype=np.uint8)
        w = lib.compare_probe(
            qk, qv, int(qk.shape[0]), tf, tr, nt, valid,
            int(mprefix), int(k), int(begin), int(end), aq, at, al, arc, cap,
        )
        if w == -1:
            cap *= 4
            continue
        return aq[:w], at[:w], al[:w], arc[:w].astype(bool)


def compare_probe_codes_native(qk, qv, tcodes, mprefix, k, begin, end, qtab=None, bbits=0):
    """compare_probe from raw 2-bit target codes: rolling k-mer extraction +
    homopolymer filter run inside C.  qtab is an optional bucket table over
    qk's top `bbits` bits.  Returns (aq, at, al, arc) or None."""
    lib = get_lib()
    if lib is None:
        return None
    L = int(tcodes.shape[0])
    cap = max(8 * max(L - int(k) + 1, 1), 4096)
    qk = np.ascontiguousarray(qk, dtype=np.uint64)
    qv = np.ascontiguousarray(qv, dtype=np.uint32)
    tcodes = np.ascontiguousarray(tcodes, dtype=np.uint8)
    tab_ptr = 0
    if qtab is not None:
        qtab = np.ascontiguousarray(qtab, dtype=np.uint32)
        tab_ptr = qtab.ctypes.data
    while True:
        aq = np.empty(cap, dtype=np.int64)
        at = np.empty(cap, dtype=np.int64)
        al = np.empty(cap, dtype=np.int64)
        arc = np.empty(cap, dtype=np.uint8)
        w = lib.compare_probe_codes(
            qk, qv, int(qk.shape[0]), tcodes, L, tab_ptr, int(bbits),
            int(mprefix), int(k), int(begin), int(end), aq, at, al, arc, cap,
        )
        if w == -1:
            cap *= 4
            continue
        return aq[:w], at[:w], al[:w], arc[:w].astype(bool)


def unpack_2bit_native(window, out):
    """Decode 4 MSB-first 2-bit codes per byte of `window` into `out`
    (len(out) == 4*len(window)).  Returns False if the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    lib.unpack_2bit_window(
        np.ascontiguousarray(window, dtype=np.uint8).ctypes.data,
        int(window.shape[0]), out.ctypes.data,
    )
    return True


def kmers_fwd_rc_native(codes, k):
    """Forward + RC k-mers at every position (one rolling C pass).
    Returns (fwd, rc) uint64 arrays or None."""
    lib = get_lib()
    if lib is None:
        return None
    L = int(codes.shape[0])
    n = max(L - int(k) + 1, 0)
    fwd = np.empty(n, dtype=np.uint64)
    rc = np.empty(n, dtype=np.uint64)
    if n:
        lib.kmers_fwd_rc_batch(
            np.ascontiguousarray(codes, dtype=np.uint8), L, int(k), fwd, rc
        )
    return fwd, rc


def range_match_native(entry_kmers, entry_offsets, values, seg_lo, seg_hi,
                       lb, rb, qkmers, k, want_rev):
    """Per-mask prefix-range matching with entry-level flag filter.
    Returns (entry_idx, query_row, lcp) int64 arrays or None."""
    lib = get_lib()
    if lib is None:
        return None
    nq = int(qkmers.shape[0])
    entry_kmers = np.ascontiguousarray(entry_kmers, dtype=np.uint64)
    entry_offsets = np.ascontiguousarray(entry_offsets, dtype=np.int64)
    values = np.ascontiguousarray(values, dtype=np.uint64)
    seg_lo = np.ascontiguousarray(seg_lo, dtype=np.int64)
    seg_hi = np.ascontiguousarray(seg_hi, dtype=np.int64)
    lb = np.ascontiguousarray(lb, dtype=np.uint64)
    rb = np.ascontiguousarray(rb, dtype=np.uint64)
    qkmers = np.ascontiguousarray(qkmers, dtype=np.uint64)
    cap = max(16 * nq, 4096)
    while True:
        out_e = np.empty(cap, dtype=np.int64)
        out_q = np.empty(cap, dtype=np.int64)
        out_l = np.empty(cap, dtype=np.int64)
        w = lib.range_match(
            entry_kmers, entry_offsets, values, seg_lo, seg_hi,
            lb, rb, qkmers, nq, int(k), 1 if want_rev else 0,
            out_e, out_q, out_l, cap,
        )
        if w == -1:
            cap *= 4
            continue
        return out_e[:w], out_q[:w], out_l[:w]


def compare_prepare_native(qk, qv, tcodes, mprefix, k, begin, end,
                           band_base, band_count, max_gap, qtab=None, bbits=0):
    """Fused probe + dedup + trim + Chainer2 forward DP.  Returns
    (aq, at, al, arc, max_scores, prev_idx) with the cleaned anchors,
    or None (fallback needed)."""
    lib = get_lib()
    if lib is None:
        return None
    L = int(tcodes.shape[0])
    cap = max(8 * max(L - int(k) + 1, 1), 4096)
    qk = np.ascontiguousarray(qk, dtype=np.uint64)
    qv = np.ascontiguousarray(qv, dtype=np.uint32)
    tcodes = np.ascontiguousarray(tcodes, dtype=np.uint8)
    tab_ptr = 0
    if qtab is not None:
        qtab = np.ascontiguousarray(qtab, dtype=np.uint32)
        tab_ptr = qtab.ctypes.data
    while True:
        aq = np.empty(cap, dtype=np.int64)
        at = np.empty(cap, dtype=np.int64)
        al = np.empty(cap, dtype=np.int64)
        arc = np.empty(cap, dtype=np.uint8)
        scores = np.empty(cap, dtype=np.float64)
        prev = np.empty(cap, dtype=np.int64)
        n = lib.compare_prepare(
            qk.ctypes.data, qv.ctypes.data, int(qk.shape[0]),
            tcodes.ctypes.data, L, tab_ptr, int(bbits),
            int(mprefix), int(k), int(begin), int(end),
            int(band_base), int(band_count), float(max_gap),
            aq.ctypes.data, at.ctypes.data, al.ctypes.data, arc.ctypes.data,
            scores.ctypes.data, prev.ctypes.data, cap,
        )
        if n == -1:
            cap *= 4
            continue
        return aq[:n], at[:n], al[:n], arc[:n].astype(bool), scores[:n], prev[:n]


def chain3_native(qb, tb, ln, max_gap=5, min_score=1, min_align_len=2,
                  max_distance=10, band_count=20, band_base=10):
    lib = get_lib()
    if lib is None:
        return None
    n = int(qb.shape[0])
    if n == 0:
        return (False, None)
    qe = ctypes.c_int32(0)
    te = ctypes.c_int32(0)
    ok = lib.chain3_chain(
        np.ascontiguousarray(qb, dtype=np.int32),
        np.ascontiguousarray(tb, dtype=np.int32),
        np.ascontiguousarray(ln, dtype=np.int32),
        n, max_gap, min_score, min_align_len, max_distance,
        band_count, band_base, ctypes.byref(qe), ctypes.byref(te),
    )
    if not ok:
        return (False, None)
    return (True, (int(qe.value), int(te.value)))


def hsp_extend_wfa_batch_native(
    qcodes, tcodes, rc,
    c_qb, c_qe1, c_start, c_end, c_ext2, c_tb, c_maxext,
    x=4, o=6, e=2, adaptive=True, min_wf_len=10, max_dist_diff=50,
):
    """Fused per-group HSP extension + WFA + trimmed stats (one C call for
    all chains of a flush group).  Returns (out [n,16] int64, fail_idx) or
    None; fail_idx >= 0 marks the first chain whose WFA needs the fallback
    path.  Row layout: stats[0..9] (wfa_align_stats), [10..13] s1,e1,s2,e2,
    [14..15] extended qseq/tseq lengths."""
    lib = get_lib()
    if lib is None:
        return None
    n = int(c_qb.shape[0])
    if n == 0:
        return np.zeros((0, 16), dtype=np.int64), -1
    qcodes = np.ascontiguousarray(qcodes, dtype=np.uint8)
    tcodes = np.ascontiguousarray(tcodes, dtype=np.uint8)
    out = np.zeros((n, 16), dtype=np.int64)
    args = [np.ascontiguousarray(a, dtype=np.int64)
            for a in (c_qb, c_qe1, c_start, c_end, c_ext2, c_tb, c_maxext)]
    rcode = lib.hsp_extend_wfa_batch(
        qcodes.ctypes.data, int(qcodes.shape[0]),
        tcodes.ctypes.data, int(tcodes.shape[0]),
        1 if rc else 0,
        *(a.ctypes.data for a in args),
        n, x, o, e, 1 if adaptive else 0, min_wf_len, max_dist_diff,
        out.ctypes.data,
    )
    return out, int(rcode) - 1


def align_paths_native(
    qcodes, qk, qv, qtab, bbits,
    cmp_k, cmp_min_prefix,
    band_base, band_count, c2_max_gap, c2_min_score, c2_min_align_len, c2_heur,
    tbuf, t_off, t_len, p_qbegin, p_qend, p_tbegin, p_tend, p_rc,
    seq_sizes, interval, k,
    ext2_base, total_bases, max_evalue, min_qcov_hsp, min_identity,
    x=4, o=6, e=2, adaptive=True, min_wf_len=10, max_dist_diff=50,
    pre_rows=None, pre_off=None, pre_cnt=None,
    span_mode=0, inj_ops=None, inj_off=None, inj_len=None,
):
    """Whole-genome phase-4 fusion: pseudo-align + contig assignment + dedup +
    extend + WFA + scoring for ALL chain windows of one genome in a single C
    call.  Returns the kept-HSP row matrix [n, 18] float64 (see core.cpp
    align_paths for the layout), or None when the caller must fall back to
    the per-chain Python path (no lib, or a WFA failure).

    pre_rows/pre_off/pre_cnt: optional device pseudo-alignment results.  For
    path pi with pre_cnt[pi] >= 0, the pseudo-align stage is skipped and
    chains come from pre_rows[pre_off[pi] : pre_off[pi]+pre_cnt[pi]] (8 int64
    per chain); pre_cnt[pi] == -1 keeps the host pseudo-align for that path.

    span_mode=1 collects each chain's extended WFA window instead of
    aligning: returns an int64 [S, 5] array of (q_start, q_len, t_start,
    t_len, path).  span_mode=2 consumes per-base op streams computed
    elsewhere (device WFA): the i-th WFA call reads
    inj_ops[inj_off[i] : inj_off[i]+inj_len[i]]."""
    lib = get_lib()
    if lib is None:
        return None
    n_paths = int(t_off.shape[0])
    qcodes = np.ascontiguousarray(qcodes, dtype=np.uint8)
    tbuf = np.ascontiguousarray(tbuf, dtype=np.uint8)
    qk = np.ascontiguousarray(qk, dtype=np.uint64)
    qv = np.ascontiguousarray(qv, dtype=np.uint32)
    tab_ptr = 0
    if qtab is not None:
        qtab = np.ascontiguousarray(qtab, dtype=np.uint32)
        tab_ptr = qtab.ctypes.data
    i64 = lambda a: np.ascontiguousarray(a, dtype=np.int64)
    t_off, t_len = i64(t_off), i64(t_len)
    p_qbegin, p_qend = i64(p_qbegin), i64(p_qend)
    p_tbegin, p_tend = i64(p_tbegin), i64(p_tend)
    p_rc = np.ascontiguousarray(p_rc, dtype=np.uint8)
    seq_sizes = i64(seq_sizes)
    pre_rows_ptr = pre_off_ptr = pre_cnt_ptr = 0
    if pre_cnt is not None:
        pre_cnt = i64(pre_cnt)
        pre_off = i64(pre_off)
        pre_rows = i64(pre_rows if pre_rows is not None and len(pre_rows) else np.zeros((1, 8)))
        pre_rows_ptr = pre_rows.ctypes.data
        pre_off_ptr = pre_off.ctypes.data
        pre_cnt_ptr = pre_cnt.ctypes.data
    inj_ops_ptr = inj_off_ptr = inj_len_ptr = 0
    if span_mode == 2:
        inj_ops = np.ascontiguousarray(inj_ops, dtype=np.uint8)
        inj_off = i64(inj_off)
        inj_len = i64(inj_len)
        inj_ops_ptr = inj_ops.ctypes.data
        inj_off_ptr = inj_off.ctypes.data
        inj_len_ptr = inj_len.ctypes.data
    cap = 256
    span_cap = 1024
    while True:
        rows = np.empty((cap, 18), dtype=np.float64)
        span_buf = np.empty((span_cap, 5), dtype=np.int64) if span_mode == 1 \
            else np.empty((1, 5), dtype=np.int64)
        n = lib.align_paths(
            qcodes.ctypes.data, int(qcodes.shape[0]),
            qk.ctypes.data, qv.ctypes.data, int(qk.shape[0]),
            tab_ptr, int(bbits),
            int(cmp_k), int(cmp_min_prefix),
            int(band_base), int(band_count), float(c2_max_gap),
            float(c2_min_score), int(c2_min_align_len), float(c2_heur),
            tbuf.ctypes.data, t_off.ctypes.data, t_len.ctypes.data,
            p_qbegin.ctypes.data, p_qend.ctypes.data,
            p_tbegin.ctypes.data, p_tend.ctypes.data, p_rc.ctypes.data,
            n_paths,
            seq_sizes.ctypes.data, int(seq_sizes.shape[0]), int(interval), int(k),
            int(ext2_base), float(total_bases), float(max_evalue),
            float(min_qcov_hsp), float(min_identity),
            x, o, e, 1 if adaptive else 0, min_wf_len, max_dist_diff,
            pre_rows_ptr, pre_off_ptr, pre_cnt_ptr,
            rows.ctypes.data, cap,
            int(span_mode), span_buf.ctypes.data, span_cap,
            inj_ops_ptr, inj_off_ptr, inj_len_ptr,
        )
        if n == -1:
            cap *= 4
            span_cap *= 4
            continue
        if n == -2:
            return None
        if span_mode == 1:
            return span_buf[:n]
        return rows[:n]
