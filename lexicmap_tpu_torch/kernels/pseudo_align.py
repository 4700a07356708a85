"""Phase-4 pseudo-alignment of a batch of candidate windows: the two
hand-written CUDA kernels of `csrc/pseudo_align.cu` and their plain
PyTorch twins.

  pseudo_probe  (replaces lexicmap_tpu/parallel/pseudo_device.py::build_probe_fn
                 with resident.py::extract_packed fused in): per window, read
                 its 2-bit codes from the genome blob, probe every forward
                 and reverse-complement 31-mer against the query's sorted
                 k-mer table with >=m-base prefix ranges, sort the anchors
                 by (qb asc, qe desc, tb asc), drop nested anchors and trim
                 tandem-repeat artifacts.
  pseudo_chain  (replaces ::build_chain_fn): per window, the Chainer2
                 forward DP and the region-splitting backtrack into chain
                 rows.

Both reproduce the port's native oracle exactly (native/core.cpp
compare_probe_codes, compare_prepare, chain2_forward, c2_region), not the
TPU's sort-join: all scoring is integer, and the two double compares of the
trim and the pident gate are made in double, as the host makes them.

Shared layout:
  window table `win` int64 [W, 8]: word_base, phase, length, rc, query
      index, begin, end, min prefix m (blob geometry as in
      parallel/resident.py; rc windows addressed from their end with
      WORDS_OUT words);
  query tables: qk int64 (every query's sorted k-mers, concatenated), qv
      int32 (pos<<1 | strand), qoff int64 [NQ+1], qtab int32 [NQ, 2^16+1]
      (first index of each 16-bit prefix bucket, as ops/seqcompare.py;
      parallel/pseudo_device.py::query_bucket_table builds it on the card);
  anchors: qb, tb, ln int32 [W, A_CAP], counts and flags int32 [W];
  chain rows: int64 [W, C_CAP, 8] (n_anchors, aligned_q, aligned_t,
      matched, qb, qe, tb, te), counts and flags int32 [W].
Entries past a window's count are unspecified.  A window with a nonzero
flag is not answered (count 0) and goes to the host.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import SearchDefaults
from .runtime import Library, require
from .seed_locate import U32
from .seed_match import bit_length

K = SearchDefaults.CMP_K  # SeqComparator k
L_CAP = 16384  # longest window on the device
WORDS_OUT = L_CAP // 16  # words of an rc window's geometry block
A_CAP = 8192  # anchors per window after the probe (a power of two: the sort)
C_CAP = 32  # chain rows per window
S_CAP = 64  # backtrack region-stack depth
QTAB_BITS = 16  # query bucket table: 2^16 + 1 entries per query
COORD_BITS = 21  # qb, qe, tb fields of the anchor sort key
COORD_MAX = (1 << COORD_BITS) - 1

# flag bits per window; nonzero -> the window goes to the host
F_ANCHOR_OVERFLOW = 1
F_CHAIN_OVERFLOW = 16
F_STACK_OVERFLOW = 32

_M62 = (1 << 62) - 1


def _homopolymers():
    return [sum(b << (2 * z) for z in range(K)) for b in (1, 2, 3)]


# ---------------------------------------------------------------------------
# plain versions


def _rev_pairs32(x):
    """Reverse the 16 2-bit groups of each 32-bit word (int64 holding u32)."""
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & U32


def extract_packed_plain(blob, word_base, phase, length, rc, words_out: int):
    """[B] geometry -> [B, words_out] int32 (u32 bits) LSB-first packed codes.

    blob int32 [NW] (normalized words); word_base int64 [B]; phase, length
    int32 [B]; rc bool [B].  Codes at positions >= length are 0 (the
    pack_codes_2bit pad value).  Bit-identical to the JAX package's
    extract_packed."""
    dev = blob.device
    j = torch.arange(words_out + 1, device=dev)[None, :]
    wi = torch.clamp(word_base.to(torch.int64)[:, None] + j, 0, blob.shape[0] - 1)
    raw = blob[wi].to(torch.int64) & U32  # [B, words_out+1]
    sh = (2 * phase.to(torch.int64))[:, None]
    hi = torch.where(sh > 0, (raw[:, 1:] << ((32 - sh) & 31)) & U32, 0)
    a = (raw[:, :-1] >> sh) | hi  # [B, words_out], phase-aligned
    a_rc = (_rev_pairs32(a) ^ U32).flip(1)
    a = torch.where(rc.to(torch.bool)[:, None], a_rc, a)
    jj = torch.arange(words_out, device=dev)[None, :]
    lw = (length.to(torch.int64) >> 4)[:, None]
    pmask = (1 << (2 * (length.to(torch.int64) & 15))[:, None]) - 1
    wmask = torch.where(jj < lw, U32, torch.where(jj == lw, pmask, 0))
    a = a & wmask
    return torch.where(a >= 1 << 31, a - (1 << 32), a).to(torch.int32)


def unpack_codes(packed):
    """[B, W] int32 (u32 bits) LSB-first packed -> [B, 16*W] int64 codes 0..3."""
    B, W = packed.shape
    shifts = 2 * torch.arange(16, device=packed.device)
    return ((packed.to(torch.int64)[:, :, None] >> shifts) & 3).reshape(B, 16 * W)


def window_codes(blob, win):
    """Per window, its codes as an int64 tensor [L] (extract_packed_plain,
    then the window's words unpacked)."""
    packed = extract_packed_plain(blob, win[:, 0], win[:, 1], win[:, 2], win[:, 3] != 0,
                                  WORDS_OUT)
    out = []
    for w, L in enumerate(win[:, 2].tolist()):
        out.append(unpack_codes(packed[w: w + 1, : (L + 15) // 16])[0, :L])
    return out


def _probe_window(codes, qk, qv, begin, end, m):
    """Anchors (qb, tb, ln) int64 of one window after sort, dedup and trim,
    and its flag: compare_prepare's first half, in tensor code."""
    dev = codes.device
    L, nq = codes.shape[0], qk.shape[0]
    empty = torch.empty(0, dtype=torch.int64, device=dev)
    if L < K or nq == 0:
        return empty, empty, empty, 0
    npos = L - K + 1
    z = torch.arange(K, device=dev)
    c = codes[torch.arange(npos, device=dev)[:, None] + z[None, :]]  # [npos, K]
    fwd = (c << (2 * (K - 1 - z))).sum(1)
    rcm = ((3 - c) << (2 * z)).sum(1)
    valid = fwd != 0
    for h in _homopolymers():
        valid &= fwd != h
    pos = torch.nonzero(valid).flatten()
    suf = (1 << (2 * (K - m))) - 1
    parts = []
    for strand, kmers in ((0, fwd), (1, rcm)):
        t = kmers[pos]
        lo = torch.searchsorted(qk, t & (_M62 ^ suf))
        hi = torch.searchsorted(qk, t | suf, right=True)
        n = hi - lo
        rep = torch.repeat_interleave(torch.arange(t.shape[0], device=dev), n)
        first = torch.cumsum(n, 0) - n
        j = lo[rep] + torch.arange(rep.shape[0], device=dev) - first[rep]
        x = t[rep] ^ qk[j]
        lcp = torch.where(x == 0, K, (64 - bit_length(x)) // 2 + (K - 32))
        v = qv[j].to(torch.int64)
        p = pos[rep]
        if strand == 0:
            aq = v >> 1
            ok = ((v & 1) == 0) & (aq >= begin) & (aq + lcp <= end)
            at = p
        else:
            aq = (v >> 1) + K - lcp
            ok = ((v & 1) == 1) & ~((aq + lcp < begin) | (aq > end))
            at = p + K - lcp
        parts.append((aq[ok], at[ok], lcp[ok], 2 * p[ok] + strand))
    aq, at, ln, tag = (torch.cat(col) for col in zip(*parts))
    if aq.shape[0] > A_CAP:
        return empty, empty, empty, F_ANCHOR_OVERFLOW
    if aq.shape[0] == 0:
        return empty, empty, empty, 0
    # sort by (qb asc, qe desc, tb asc), ties in emission order (i, strand)
    key = (aq << (2 * COORD_BITS)) | ((COORD_MAX - (aq + ln)) << COORD_BITS) | at
    o1 = torch.argsort(tag, stable=True)
    order = o1[torch.argsort(key[o1], stable=True)]
    sq, st, sl = aq[order], at[order], ln[order]
    # nested-anchor removal over the sorted, uncompacted array
    qe, te = sq + sl, st + sl
    lo = torch.searchsorted(sq, torch.clamp(qe - K, min=0))
    n = torch.arange(sq.shape[0], device=dev) - lo
    i_rep = torch.repeat_interleave(torch.arange(sq.shape[0], device=dev), n)
    j_rep = lo[i_rep] + torch.arange(i_rep.shape[0], device=dev) - (torch.cumsum(n, 0) - n)[i_rep]
    nested = (qe[i_rep] <= qe[j_rep]) & (st[i_rep] >= st[j_rep]) & (te[i_rep] <= te[j_rep])
    dropped = torch.zeros(sq.shape[0], dtype=torch.bool, device=dev)
    dropped[i_rep[nested]] = True
    keep = ~dropped
    sq, st, sl = sq[keep], st[keep], sl[keep]
    lo_i, hi_i = _trim_range(sq.tolist(), st.tolist(), sl.tolist())
    if hi_i < lo_i:
        return empty, empty, empty, 0
    return sq[lo_i: hi_i + 1], st[lo_i: hi_i + 1], sl[lo_i: hi_i + 1], 0


def _trim_range(sq, st, sl):
    """TrimSubStrPairs (min_dist 100) over sorted, deduplicated anchors:
    the kept index range [lo, hi], empty when hi < lo (core.cpp
    compare_prepare, the trim block; double compares as there)."""
    n = len(sq)
    if n < 2:
        return 0, n - 1

    def cond(a, b, prev):  # a in front of b; prev is the run's previous anchor
        dq, dt = abs(sq[a] - sq[b]), abs(st[a] - st[b])
        if not float(max(dq, dt)) < 100.0:
            return False
        if sq[a] == sq[b] or st[a] == st[b]:
            return True
        qo = sq[a] + sl[a] - sq[b] + 1 if sq[a] <= sq[b] <= sq[a] + sl[a] else 0
        to = st[a] + sl[a] - st[b] + 1 if st[a] <= st[b] <= st[a] + sl[a] else 0
        return abs(dq - dt) > 11 and float(max(qo, to)) / float(sl[prev]) > 0.8

    start, prev = 0, 0
    for i in range(1, n):
        if not cond(prev, i, prev):
            break
        start, prev = i - 1, i
    endi, prev = n - 1, n - 1
    for i in range(n - 2, -1, -1):
        if not cond(i, prev, prev):
            break
        endi, prev = i, i
    if start == 0 and endi == n - 1:
        return 0, n - 1
    if start >= endi:
        return 0, -1
    return start, endi


def pseudo_probe_plain(blob, win, qk, qv, qoff, qtab):
    """The probe, sort, dedup and trim per window in tensor code (the query
    bucket table is not needed: a searchsorted over the query's whole
    table finds the same ranges).  Same arguments and outputs as
    `pseudo_probe`; entries past each count are 0."""
    del qtab
    W = win.shape[0]
    dev = blob.device
    out = [torch.zeros((W, A_CAP), dtype=torch.int32, device=dev) for _ in range(3)]
    counts = torch.zeros(W, dtype=torch.int32, device=dev)
    flags = torch.zeros(W, dtype=torch.int32, device=dev)
    if W == 0:
        return (*out, counts, flags)
    codes = window_codes(blob, win)
    off = qoff.tolist()
    meta = win.tolist()
    for w in range(W):
        qi, begin, end, m = meta[w][4:8]
        q0, q1 = off[qi], off[qi + 1]
        aq, at, ln, f = _probe_window(codes[w], qk[q0:q1], qv[q0:q1], begin, end, m)
        flags[w] = f
        n = aq.shape[0]
        counts[w] = n
        for o, col in zip(out, (aq, at, ln)):
            o[w, :n] = col.to(torch.int32)
    return (*out, counts, flags)


def _chain_dp(qb, tb, ln, n, band_base, band_count, max_gap):
    """Chainer2 forward DP (core.cpp chain2_forward) for all windows at once,
    one anchor step at a time over the full predecessor prefix, the
    early-exit rules evaluated as masks.  qb/tb/ln int64 [W, N], n [W].
    Returns (scores, prev, cut) int64 [W, N]; cut is the predecessor at
    which anchor i's scan breaks (-1 when it reaches j = 0 unbroken)."""
    W, N = qb.shape
    dev = qb.device
    lane = torch.arange(N, device=dev)
    max_ln = torch.where(lane[None, :] < n[:, None], ln, 0).max(1).values
    scores = torch.zeros((W, N), dtype=torch.int64, device=dev)
    prev = torch.zeros((W, N), dtype=torch.int64, device=dev)
    scores[:, 0] = ln[:, 0]
    msl = torch.zeros((W, N), dtype=torch.int64, device=dev)
    msl[:, 0] = 2 * ln[:, 0]
    cuts = torch.full((W, N), -1, dtype=torch.int64, device=dev)
    for i in range(1, N):
        aq, at, al = qb[:, i: i + 1], tb[:, i: i + 1], ln[:, i: i + 1]
        qj, tj, lj, mj_ = qb[:, :i], tb[:, :i], ln[:, :i], msl[:, :i]
        elig = (qj != aq) & (tj <= at)
        csum = torch.cumsum(elig.to(torch.int64), 1)
        after = csum[:, -1:] - csum  # eligible strictly between j and i
        thr = aq - max_ln[:, None] - band_base
        brk = ((after >= band_count) & (qj < thr)) | (
            elig & (aq - qj - lj > band_base) & (after + 1 > band_count))
        cut = torch.where(brk, lane[None, :i], -1).max(1, keepdim=True).values
        g = (aq - qj - (at - tj)).abs()
        ok = elig & (lane[None, :i] > cut) & (g <= max_gap)
        sc = torch.where(ok, mj_ - g, -(1 << 40))
        best = sc.max(1, keepdim=True).values
        jbest = torch.where(sc == best, lane[None, :i], N).min(1, keepdim=True).values
        use = best >= al
        m = torch.where(use, best, al)
        scores[:, i: i + 1] = m
        prev[:, i: i + 1] = torch.where(use, jbest, i)
        msl[:, i: i + 1] = m + al
        cuts[:, i: i + 1] = cut
    return scores, prev, cuts


def _backtrack(qb, tb, ln, ms, pv, n, min_score, min_align_len, heur):
    """chain2_backtrack + c2_region with an explicit region stack (the right
    region pops first, as the recursion runs it).  Returns (rows, flag)."""
    M, Mi = 0, 0
    for i in range(n):
        if ms[i] > M:
            M, Mi = ms[i], i
    if M < min_score:
        return [], 0
    rows = []
    stack = [(0, n, Mi)]
    while stack:
        lo, hi, Mi = stack.pop()
        if Mi < 0:
            Mi, M = lo, ms[lo]
            for i in range(lo + 1, hi):
                if ms[i] > M:
                    M, Mi = ms[i], i
            if M < min_score:
                continue
        i = Mi
        first, left_exit = True, False
        n_anchors = n_matched = naq = nat = begin_next = 0
        qb_b = tb_b = qe = te = 0
        row = None
        while True:
            j = pv[i]
            if j < lo:
                left_exit = True
                break
            n_anchors += 1
            if first:
                first = False
                qe, te = qb[i] + ln[i] - 1, tb[i] + ln[i] - 1
                qb_b, tb_b = qb[i], tb[i]
                n_matched += ln[i]
            else:
                qb_b, tb_b = qb[i], tb[i]
                n_matched += begin_next - qb[i] if qb[i] + ln[i] - 1 >= begin_next else ln[i]
            begin_next = qb[i]
            if i == j:
                naq += qe - qb_b + 1
                if naq < min_align_len:
                    break
                nat += te - tb_b + 1
                if float(n_matched) / float(max(naq, nat)) * 100.0 < heur:
                    break
                row = [n_anchors, naq, nat, n_matched, qb_b, qe, tb_b, te]
                break
            i = j
        if left_exit and n_anchors > 0:
            naq += qe - qb_b + 1
            nat += te - tb_b + 1
            if naq >= min_align_len and \
                    float(n_matched) / float(max(naq, nat)) * 100.0 >= heur:
                row = [n_anchors, naq, nat, n_matched, qb_b, qe, tb_b, te]
        if row is not None:
            if len(rows) == C_CAP:
                return rows, F_CHAIN_OVERFLOW
            rows.append(row)
        for region in ((lo, i), (Mi + 1, hi)):  # left pushed first: right pops first
            if region[0] < region[1]:
                if len(stack) == S_CAP:
                    return rows, F_STACK_OVERFLOW
                stack.append((*region, -1))
    return rows, 0


def pseudo_chain_plain(qb, tb, ln, counts, flags, band_base, band_count, max_gap,
                       min_score, min_align_len, heur):
    """The Chainer2 DP and backtrack per window in tensor code (the DP
    vectorised over windows and over the predecessor prefix; the backtrack
    in Python).  Same arguments and outputs as `pseudo_chain`; entries past
    each count are 0."""
    W = qb.shape[0]
    dev = qb.device
    rows = torch.zeros((W, C_CAP, 8), dtype=torch.int64, device=dev)
    ccnt = torch.zeros(W, dtype=torch.int32, device=dev)
    cflg = torch.zeros(W, dtype=torch.int32, device=dev)
    n = torch.where(flags == 0, counts, 0).to(torch.int64)
    N = int(n.max()) if W else 0
    if N == 0:
        return rows, ccnt, cflg
    q, t, ll = (a[:, :N].to(torch.int64) for a in (qb, tb, ln))
    ms, pv, _cut = _chain_dp(q, t, ll, n, band_base, band_count, max_gap)
    nl = n.tolist()
    for w in range(W):
        nw = nl[w]
        if nw == 0:
            continue
        qw, tw, lw = q[w, :nw].tolist(), t[w, :nw].tolist(), ll[w, :nw].tolist()
        if nw == 1:
            s = lw[0]
            got = ([[1, s, s, s, qw[0], qw[0] + s - 1, tw[0], tw[0] + s - 1]]
                   if s >= min_score and s >= min_align_len else [])
            f = 0
        else:
            got, f = _backtrack(qw, tw, lw, ms[w, :nw].tolist(), pv[w, :nw].tolist(), nw,
                                min_score, min_align_len, heur)
        cflg[w] = f
        if f == 0 and got:
            ccnt[w] = len(got)
            rows[w, : len(got)] = torch.tensor(got, dtype=torch.int64, device=dev)
    return rows, ccnt, cflg


# ---------------------------------------------------------------------------
# wrappers


LIB = Library("pseudo_align", {
    "pseudo_probe": ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p] + [ctypes.c_int] * 2
                     + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6,
                     ctypes.c_int),
    "pseudo_chain": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                     + [ctypes.c_double, ctypes.c_int, ctypes.c_double]
                     + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
})


def check_windows(win, nq):
    """The window table's value checks, from its column extremes: on a host
    array (numpy) with no wait, on a card tensor with one read of it."""
    if not win.shape[0]:
        return
    if isinstance(win, torch.Tensor):
        lo, hi = torch.stack(torch.aminmax(win, dim=0)).tolist()
    else:
        lo, hi = win.min(0).tolist(), win.max(0).tolist()
    if hi[2] > L_CAP or lo[2] < 0:
        raise ValueError(f"window lengths must be in [0, {L_CAP}]")
    if lo[4] < 0 or hi[4] >= nq:
        raise ValueError("a window's query index is out of range")
    if lo[7] < 1 or hi[7] > K:
        raise ValueError(f"min prefix must be in [1, {K}]")


def pseudo_probe(blob, win, qk, qv, qoff, qtab, checked=False):
    """Anchors of every window: probe, sort, dedup, trim.

    blob int32 [NW] (normalized 2-bit words), win int64 [W, 8], qk int64,
    qv int32, qoff int64 [NQ+1], qtab int32 [NQ, 2^16+1] (see the module
    docstring).  Windows must be at most L_CAP long and every query index in
    range; `checked` says the caller has run check_windows on the table's
    host copy, so the wrapper does not read it back (on the card, the host
    then does not wait before the launch).  Returns (qb, tb, ln int32
    [W, A_CAP], counts, flags int32 [W]).  CUDA tensors launch the kernel
    (`launches` counts them); CPU tensors run the plain version."""
    dev = blob.device
    require("blob", blob, torch.int32, dev)
    if blob.dim() != 1 or blob.shape[0] == 0:
        raise ValueError("blob must be a non-empty 1-D tensor")
    require("win", win, torch.int64, dev)
    if win.dim() != 2 or win.shape[1] != 8:
        raise ValueError(f"win must be [W, 8], got {tuple(win.shape)}")
    require("qoff", qoff, torch.int64, dev)
    NQ = qoff.shape[0] - 1
    require("qk", qk, torch.int64, dev)
    require("qv", qv, torch.int32, dev, qk.shape)
    require("qtab", qtab, torch.int32, dev, (NQ, (1 << QTAB_BITS) + 1))
    W = win.shape[0]
    if dev.type == "cpu":
        if not checked:
            check_windows(win, NQ)
        return pseudo_probe_plain(blob, win, qk, qv, qoff, qtab)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = [torch.empty((W, A_CAP), dtype=torch.int32, device=dev) for _ in range(3)]
    counts = torch.empty(W, dtype=torch.int32, device=dev)
    flags = torch.empty(W, dtype=torch.int32, device=dev)
    if W == 0:
        return (*out, counts, flags)
    if not checked:  # the host waits here: everything else is ready to launch
        check_windows(win, NQ)
    LIB.launch("pseudo_probe", dev, blob.data_ptr(), blob.shape[0], win.data_ptr(), W,
               WORDS_OUT, qk.data_ptr(), qv.data_ptr(), qoff.data_ptr(), qtab.data_ptr(), A_CAP,
               L_CAP, *(o.data_ptr() for o in out), counts.data_ptr(), flags.data_ptr())
    pseudo_probe.launches += 1
    return (*out, counts, flags)


pseudo_probe.launches = 0


def pseudo_chain(qb, tb, ln, counts, flags, band_base=100, band_count=50, max_gap=20,
                 min_score=35, min_align_len=50, heur=15.0):
    """Chain rows of every window from its anchors (the outputs of
    `pseudo_probe`; windows with a probe flag or no anchors are skipped).

    Returns (rows int64 [W, C_CAP, 8], counts, flags int32 [W]); a window's
    rows are in the oracle's emission order.  min_score and heur compare
    as doubles, max_gap as an integer, as in the host code.  CUDA tensors
    launch the kernel (`launches` counts them); CPU tensors run the plain
    version."""
    dev = qb.device
    W = qb.shape[0] if qb.dim() == 2 else -1
    if W < 0 or qb.shape[1] != A_CAP:
        raise ValueError(f"qb must be [W, {A_CAP}], got {tuple(qb.shape)}")
    for name, t in (("qb", qb), ("tb", tb), ("ln", ln)):
        require(name, t, torch.int32, dev, (W, A_CAP))
    for name, t in (("counts", counts), ("flags", flags)):
        require(name, t, torch.int32, dev, (W,))
    args = (band_base, band_count, int(max_gap), float(min_score), min_align_len,
            float(heur))
    if dev.type == "cpu":
        return pseudo_chain_plain(qb, tb, ln, counts, flags, *args)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    rows = torch.empty((W, C_CAP, 8), dtype=torch.int64, device=dev)
    ccnt = torch.empty(W, dtype=torch.int32, device=dev)
    cflg = torch.empty(W, dtype=torch.int32, device=dev)
    if W == 0:
        return rows, ccnt, cflg
    scratch = torch.empty((2, W, A_CAP), dtype=torch.int32, device=dev)
    LIB.launch("pseudo_chain", dev, qb.data_ptr(), tb.data_ptr(), ln.data_ptr(),
               counts.data_ptr(), flags.data_ptr(), W, A_CAP, *args, scratch[0].data_ptr(),
               scratch[1].data_ptr(), rows.data_ptr(), ccnt.data_ptr(), cflg.data_ptr(), C_CAP)
    pseudo_chain.launches += 1
    return rows, ccnt, cflg


pseudo_chain.launches = 0
