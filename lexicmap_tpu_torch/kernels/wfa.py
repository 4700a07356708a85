"""Gap-affine WFA of a batch of sequence pairs: the hand-written CUDA
kernels of `csrc/wfa.cu` (a sizing pass of the forward DP, then the
forward DP writing its history, then the traceback) and their plain
PyTorch twin.

  wfa_batch  (replaces lexicmap_tpu/parallel/wfa_device.py::build_wfa_step
              and ::build_wfa_traceback): per pair, the global gap-affine
              alignment of ops/wfa.py::wfa_align (native wfa_align), as
              (op, count) runs.

Layout: `seq` int64 [NW] holds 64-bit words of 32 bases each, 2 bits a base
MSB first (`pack_words`); a pair is the word offsets of its query and
target (q_off, t_off int64 [B]) and their lengths (n, m int32 [B], each in
[1, L_MAX]).  Outputs: ops int8 [B, CAP] (0 = M, 1 = X, 2 = I, 3 = D) and
cnts int32 [B, CAP], the runs newest first with equal neighbours merged,
and nops int32 [B], the number of runs, or -1 for a pair that overflowed
the window of W diagonals or S scores (or CAP runs): such a pair is not
answered and goes to the host.  On the card the three outputs are views of
one buffer (`runtime.fetch_numpy` brings them back in one copy).  The
history the traceback reads is sized, then written: the sizing pass counts
the int16 cells each pair's live spans take, the wrapper reads the launch's
total back (one 8-byte fetch, labelled SIZE_LABEL) and allocates that
packed arena and a [B, S] int2 row table, `history_bytes_packed`.
`history_bytes(B, S, W)`, room for every score's row at the full window,
is the most a launch could take: the caller bounds B by it.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .runtime import Library, fetch_numpy, require
from .seed_match import bit_length

NEG = -20000  # a dead wavefront cell (int16 history)
ALIGN = 8  # int16 cells: each pair's region of the arena starts 16-byte aligned
BIG = 1 << 20  # the window start of a score with no live source
L_MAX = 30000  # longest sequence: offsets fit the int16 history
OPS = "MXID"
SIZE_LABEL = "device WFA size"  # the card_wait label of the arena's size read

_count_lock = threading.Lock()


def pack_words(seqs) -> tuple[np.ndarray, np.ndarray]:
    """uint8 code arrays -> (words int64 [NW], word offset of each int64).
    A sequence of L bases takes L // 32 + 2 words, the last of them padding,
    so the kernel's 32-base reads never pass the buffer."""
    nw = np.array([c.shape[0] // 32 + 2 for c in seqs], dtype=np.int64)
    offs = np.zeros(len(seqs), dtype=np.int64)
    np.cumsum(nw[:-1], out=offs[1:])
    buf = np.zeros(int(nw.sum()) * 32, dtype=np.uint8)
    for c, o in zip(seqs, offs):
        buf[o * 32: o * 32 + c.shape[0]] = c
    shifts = np.arange(62, -1, -2, dtype=np.uint64)
    words = (buf.reshape(-1, 32).astype(np.uint64) << shifts).sum(axis=1, dtype=np.uint64)
    return words.view(np.int64), offs


def pack_pairs(pairs):
    """(query, target) uint8 code arrays -> wfa_batch's host inputs
    (seq int64 [NW], q_off, t_off int64 [B], n, m int32 [B])."""
    words, offs = pack_words([s for p in pairs for s in p])
    lens = np.array([s.shape[0] for p in pairs for s in p], dtype=np.int32)
    return words, offs[0::2].copy(), offs[1::2].copy(), lens[0::2].copy(), lens[1::2].copy()


def history_bytes(B: int, S: int, W: int) -> int:
    """Device bytes of the most scratch a launch of B pairs can take: room
    for every score's row at the full window W, its row table and each
    pair's final score (history_bytes_packed of B * S * 3 * W cells)."""
    return B * (S * (3 * W * 2 + 8) + 4)


def history_bytes_packed(cells: int, B: int, S: int) -> int:
    """Device bytes of the scratch a launch of B pairs takes when their
    regions of the arena hold `cells` int16 cells in all: the arena, its
    [B, S] int2 row table and each pair's final score (the sizing pass's
    B + 1 int64 offsets besides)."""
    return 2 * cells + B * (8 * S + 4)


def packed_offsets(cells):
    """Each pair's history cells int64 [B] (0 for a flagged pair) -> the
    arena's offsets int64 [B + 1]: pair b's region from off[b], each
    rounded up to ALIGN cells, and the arena's cells in off[B] (what the
    card's wfa_offsets computes)."""
    off = torch.zeros(cells.shape[0] + 1, dtype=torch.int64, device=cells.device)
    torch.cumsum((cells + ALIGN - 1) // ALIGN * ALIGN, 0, out=off[1:])
    return off


# ---------------------------------------------------------------------------
# plain version


def _sliding_words(seq, off, L, n):
    """Per pair, w[i] = the 16 bases from base i, MSB first, as int64
    [B, L+1] (bases past the sequence read as 0)."""
    dev = seq.device
    B = off.shape[0]
    pos = torch.arange(L + 16, device=dev)
    word = (off[:, None] + (pos >> 5)[None, :]).clamp(max=seq.shape[0] - 1)
    sh = (62 - 2 * (pos & 31))[None, :]
    codes = (seq[word] >> sh) & 3  # arithmetic shifts keep the low bits
    codes = torch.where(pos[None, :] < n[:, None], codes, 0)
    acc = torch.zeros((B, L + 1), dtype=torch.int64, device=dev)
    for z in range(16):
        acc |= codes[:, z: z + L + 1] << (30 - 2 * z)
    return acc


def _extend(f, ks, qw, tw, n, m, live):
    """Greedy match extension of offsets f [B, W] on diagonals ks where
    `live`, 16 bases a step."""
    n, m = n[:, None], m[:, None]
    active = live & (f < m) & (f - ks < n)
    while bool(active.any()):
        i = torch.where(active, f - ks, 0)
        j = torch.where(active, f, 0)
        xw = qw.gather(1, i) ^ tw.gather(1, j)
        lead = torch.where(xw != 0, (32 - bit_length(xw)) >> 1, 16)
        rem = torch.minimum(n - i, m - j)
        ext = torch.where(active, torch.minimum(lead, rem), 0)
        f = f + ext
        active = active & (lead >= 16) & (rem > 16)
    return f


def _forward(seq, q_off, t_off, n, m, S, W, x, o, e, min_wf_len, max_dist_diff, work=None):
    """The forward pass for all pairs in lockstep, one score at a time,
    vectorised over pairs x diagonals.  Returns (hist int16 [B, S, 3, W],
    lo int32 [B, S], done_s int32 [B], cells int64 [B]): `cells` is the
    int16 history cells the card's write pass writes for each pair (three
    a diagonal of every computed span, with score 0's one), 0 for a pair
    it flags; `work` (a dict) gains the cells the rows span (the native's
    row widths), the rows computed and the bases the extension advances."""
    dev = seq.device
    B = n.shape[0]
    nl, ml = n.to(torch.int64), m.to(torch.int64)
    L = int(torch.maximum(nl, ml).max())
    qw = _sliding_words(seq, q_off, L, nl)
    tw = _sliding_words(seq, t_off, L, ml)
    k_end = ml - nl
    lane = torch.arange(W, device=dev)
    rows = torch.arange(B, device=dev)
    hist = torch.full((B, S, 3, W), NEG, dtype=torch.int16, device=dev)
    lo = torch.full((B, S), BIG, dtype=torch.int64, device=dev)
    tlo = torch.full((B, S), BIG, dtype=torch.int64, device=dev)
    thi = torch.full((B, S), -BIG, dtype=torch.int64, device=dev)
    neg = torch.tensor(NEG, dtype=torch.int64, device=dev)

    m0 = _extend(torch.zeros((B, 1), dtype=torch.int64, device=dev),
                 torch.zeros((B, 1), dtype=torch.int64, device=dev), qw, tw, nl, ml,
                 torch.ones((B, 1), dtype=torch.bool, device=dev))[:, 0]
    hist[:, 0, 0, 0] = m0.to(torch.int16)
    lo[:, 0] = 0
    tlo[:, 0] = 0
    thi[:, 0] = 0
    done = (k_end == 0) & (m0 >= ml)
    done_s = torch.where(done, 0, -1)
    running = ~done
    cum = torch.ones(B, dtype=torch.int64, device=dev)  # cells a kind, score 0's one

    def get(src, which, kk):
        if src < 0:
            return neg.expand(kk.shape)
        idx = kk - lo[:, src: src + 1]
        ok = (idx >= 0) & (idx < W)
        vals = hist[:, src, which, :].gather(1, idx.clamp(0, W - 1)).to(torch.int64)
        return torch.where(ok, vals, neg)

    for s in range(1, S):
        if not bool(running.any()):
            break
        kmin = torch.full((B,), BIG, dtype=torch.int64, device=dev)
        kmax = torch.full((B,), -BIG, dtype=torch.int64, device=dev)
        for src, dk in ((s - x, 0), (s - o - e, 1), (s - e, 1)):
            if src < 0:
                continue
            alive = tlo[:, src] <= thi[:, src]
            kmin = torch.where(alive, torch.minimum(kmin, tlo[:, src] - dk), kmin)
            kmax = torch.where(alive, torch.maximum(kmax, thi[:, src] + dk), kmax)
        has_src = kmin <= kmax
        over = running & has_src & (kmax - kmin + 1 > W)
        running = running & ~over
        act = running & has_src
        cum += torch.where(act, kmax - kmin + 1, 0)
        row_lo = torch.where(act, kmin, BIG)
        ks = row_lo[:, None] + lane[None, :]
        D = torch.maximum(get(s - o - e, 0, ks - 1), get(s - e, 2, ks - 1))
        D = torch.where(D > NEG, D + 1, neg)
        I = torch.maximum(get(s - o - e, 0, ks + 1), get(s - e, 1, ks + 1))
        mis = get(s - x, 0, ks)
        mis = torch.where(mis > NEG, mis + 1, neg)
        M = torch.maximum(torch.maximum(mis, I), D)

        def valid(v):
            return (v > NEG) & (v <= ml[:, None]) & (v - ks >= 0) & (v - ks <= nl[:, None])

        M = torch.where(valid(M) & act[:, None], M, neg)
        I = torch.where(valid(I) & act[:, None], I, neg)
        D = torch.where(valid(D) & act[:, None], D, neg)
        has = M > NEG
        M0 = M
        M = torch.where(has, _extend(M, ks, qw, tw, nl, ml, has), neg)
        if work is not None:
            work["cells"] = work.get("cells", 0) + int(torch.where(act, kmax - kmin + 1, 0).sum())
            work["rows"] = work.get("rows", 0) + int(act.sum())
            work["ext_bases"] = work.get("ext_bases", 0) + int(torch.where(has, M - M0, 0).sum())
            work["extended"] = work.get("extended", 0) + int(has.sum())
        # adaptive reduction
        dist = torch.where(has, (ml[:, None] - M) + (nl[:, None] - (M - ks)), BIG)
        dmin = dist.min(1, keepdim=True).values
        cnt = has.sum(1, keepdim=True)
        prune = (cnt >= min_wf_len) & has & (dist - dmin > max_dist_diff)
        M = torch.where(prune, neg, M)
        I = torch.where(prune, neg, I)
        D = torch.where(prune, neg, D)
        hist[:, s] = torch.stack([M, I, D], 1).to(torch.int16)
        lo[:, s] = row_lo
        live = (M > NEG) | (I > NEG) | (D > NEG)
        tlo[:, s] = torch.where(live, ks, BIG).min(1).values
        thi[:, s] = torch.where(live, ks, -BIG).max(1).values
        at = (k_end - row_lo).clamp(0, W - 1)
        hit = act & (k_end >= row_lo) & (k_end < row_lo + W) & (M[rows, at] >= ml)
        done_s = torch.where(hit, s, done_s)
        running = running & ~hit
    cells = torch.where(done_s >= 0, 3 * cum, 0)
    return hist, lo.to(torch.int32), done_s.to(torch.int32), cells


def _traceback(hist, lo, done_s, n, m, CAP, x, o, e, work=None):
    """The traceback of every pair in lockstep, one transition a step.
    Returns (ops int8 [B, CAP], cnts int32 [B, CAP], nops int32 [B]);
    `work` (a dict) gains the history cells and row starts the path reads
    (an M step three cells, a gap step two, each two row starts)."""
    dev = hist.device
    B, S, _, W = hist.shape
    flat = hist.reshape(B, -1)
    lo64 = lo.to(torch.int64)
    rows = torch.arange(B, device=dev)
    ops = torch.zeros((B, CAP), dtype=torch.int64, device=dev)
    cnts = torch.zeros((B, CAP), dtype=torch.int64, device=dev)
    w = torch.zeros(B, dtype=torch.int64, device=dev)
    s = done_s.to(torch.int64)
    k = (m - n).to(torch.int64)
    f = m.to(torch.int64)
    state = torch.zeros(B, dtype=torch.int64, device=dev)  # 0 M, 1 I, 2 D
    ok = s >= 0
    run = ok.clone()

    def get(ss, which, kk):
        sc = ss.clamp(0, S - 1)
        idx = kk - lo64[rows, sc]
        good = (ss >= 0) & (idx >= 0) & (idx < W)
        v = flat[rows, (sc * 3 + which) * W + idx.clamp(0, W - 1)].to(torch.int64)
        return torch.where(good, v, NEG)

    def emit(code, c, where):
        nonlocal ops, cnts, w, ok
        where = where & (c > 0)
        prev_op = ops[rows, (w - 1).clamp(min=0)]
        merge = where & (w > 0) & (prev_op == code)
        cnts[rows, (w - 1).clamp(min=0)] += torch.where(merge, c, 0)
        new = where & ~merge
        full = new & (w >= CAP)
        ok = ok & ~full
        new = new & ~full
        at = w.clamp(max=CAP - 1)
        ops[rows, at] = torch.where(new, code, ops[rows, at])
        cnts[rows, at] = torch.where(new, c, cnts[rows, at])
        w = w + new.to(torch.int64)

    while bool(run.any()):
        # M state
        in_m = run & (state == 0)
        at0 = in_m & (s == 0)
        emit(0, f, at0)
        step = in_m & (s > 0)
        mis = get(s - x, 0, k)
        mis = torch.where(mis > NEG, mis + 1, NEG)
        ins, dele = get(s, 1, k), get(s, 2, k)
        fp = torch.maximum(torch.maximum(mis, ins), dele)
        fail = step & (fp <= NEG + 2)
        ok = ok & ~fail
        step = step & ~fail
        emit(0, f - fp, step)
        is_x = step & (mis == fp)
        is_d = step & ~is_x & (dele == fp)
        is_i = step & ~is_x & ~is_d
        emit(1, torch.ones_like(f), is_x)
        f_m = torch.where(is_x, fp - 1, fp)
        s_m = torch.where(is_x, s - x, s)
        state_m = torch.where(is_d, 2, torch.where(is_i, 1, 0))
        # I state: from k+1, f unchanged
        in_i = run & (state == 1)
        ov, ev = get(s - o - e, 0, k + 1), get(s - e, 1, k + 1)
        emit(2, torch.ones_like(f), in_i)
        i_open, i_ext = in_i & (ov == f), in_i & (ov != f) & (ev == f)
        ok = ok & ~(in_i & ~i_open & ~i_ext)
        # D state: from k-1, f -> f-1
        in_d = run & (state == 2)
        if work is not None:
            mst, gap = int((in_m & (s > 0)).sum()), int((in_i | in_d).sum())
            work["tb_cells"] = work.get("tb_cells", 0) + 3 * mst + 2 * gap
            work["tb_rows"] = work.get("tb_rows", 0) + 2 * (mst + gap)
        ov, ev = get(s - o - e, 0, k - 1), get(s - e, 2, k - 1)
        emit(3, torch.ones_like(f), in_d)
        d_open, d_ext = in_d & (ov == f - 1), in_d & (ov != f - 1) & (ev == f - 1)
        ok = ok & ~(in_d & ~d_open & ~d_ext)
        gap_s = torch.where(i_open | d_open, s - o - e, s - e)
        s = torch.where(step, s_m, torch.where(in_i | in_d, gap_s, s))
        f = torch.where(step, f_m, torch.where(in_d, f - 1, f))
        k = torch.where(in_i, k + 1, torch.where(in_d, k - 1, k))
        state = torch.where(step, state_m, torch.where(i_open | d_open, 0, state))
        run = run & ok & ~at0
    nops = torch.where(ok, w, -1).to(torch.int32)
    return ops.to(torch.int8), cnts.to(torch.int32), nops


def wfa_plain(seq, q_off, t_off, n, m, S, W, CAP, x=4, o=6, e=2, min_wf_len=10,
              max_dist_diff=50, work=None):
    """The forward pass vectorised over pairs x diagonals per score (the
    JAX program's shape), then the traceback vectorised over pairs.  Same
    arguments and outputs as `wfa_batch`; runs past nops are 0.  `work`,
    when given, is a dict that gains the counts of _forward and _traceback
    (the data's own work, for a bound)."""
    hist, lo, done_s, _ = _forward(seq, q_off, t_off, n, m, S, W, x, o, e, min_wf_len,
                                   max_dist_diff, work)
    return _traceback(hist, lo, done_s, n, m, CAP, x, o, e, work)


# ---------------------------------------------------------------------------
# wrapper


LIB = Library("wfa", {
    "wfa_size_batch": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3,
                       ctypes.c_int),
    "wfa_align_batch": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 8,
                        ctypes.c_int),
})


def check_pairs(NW, q_off, t_off, n, m):
    """The value checks of a batch: lengths in [1, L_MAX] and every
    sequence's words inside the buffer of NW words (host arrays with no
    wait, card tensors with one read)."""
    if not len(n):
        return
    if isinstance(n, torch.Tensor):
        vals = fetch_numpy("device WFA", torch.stack([
            torch.minimum(q_off.min(), t_off.min()),
            torch.maximum((q_off + n // 32).max(), (t_off + m // 32).max()),
            torch.minimum(n.min(), m.min()).to(torch.int64),
            torch.maximum(n.max(), m.max()).to(torch.int64)]))[0]
    else:
        vals = [min(q_off.min(), t_off.min()), max((q_off + n // 32).max(), (t_off + m // 32).max()),
                min(n.min(), m.min()), max(n.max(), m.max())]
    first, last, shortest, longest = (int(v) for v in vals)
    if shortest < 1 or longest > L_MAX:
        raise ValueError(f"sequence lengths must be in [1, {L_MAX}]")
    if first < 0 or last + 2 > NW:
        raise ValueError("a sequence's words pass the end of seq")


def _arena_cells(off, B, S, scratch):
    """The arena's cells, off[B], read back (the launch's one wait before
    its outputs); its history_bytes_packed added to scratch["hist_bytes"]
    where scratch is a dict."""
    cells = int(fetch_numpy(SIZE_LABEL, off[B:])[0][0])
    if scratch is not None:
        scratch["hist_bytes"] = scratch.get("hist_bytes", 0) + history_bytes_packed(cells, B, S)
    return cells


def wfa_batch(seq, q_off, t_off, n, m, S, W, CAP, x=4, o=6, e=2, min_wf_len=10,
              max_dist_diff=50, checked=False, scratch=None):
    """Align every pair of a batch (see the module docstring for the
    layout): W diagonals a window (a multiple of 32, at most 256), S
    scores, CAP runs a pair.  `checked` says the caller has run
    check_pairs on the batch's host copy; `scratch`, a dict, gains under
    "hist_bytes" the history bytes the call took (history_bytes_packed of
    the sized arena).  Returns (ops int8 [B, CAP], cnts int32 [B, CAP],
    nops int32 [B]).  CUDA tensors launch the kernels (`launches` counts
    the calls that launch them); CPU tensors run the plain version, which
    sizes the arena as the card does."""
    dev = seq.device
    require("seq", seq, torch.int64, dev)
    if seq.dim() != 1 or seq.shape[0] == 0:
        raise ValueError("seq must be a non-empty 1-D tensor")
    B = n.shape[0]
    for name, t in (("q_off", q_off), ("t_off", t_off)):
        require(name, t, torch.int64, dev, (B,))
    for name, t in (("n", n), ("m", m)):
        require(name, t, torch.int32, dev, (B,))
    if W % 32 or not 32 <= W <= 256 or S < 1 or CAP < 1 or S * W >= 1 << 22:
        raise ValueError(f"unsupported window: W={W} (a multiple of 32, <= 256), S={S} "
                         f"(S * W < 2**22), CAP={CAP}")
    if x < 1 or e < 1 or o < 0:
        raise ValueError("penalties must have x >= 1, e >= 1, o >= 0")
    if not checked:
        check_pairs(seq.shape[0], q_off, t_off, n, m)
    if dev.type == "cpu":
        hist, lo, done_s, cells = _forward(seq, q_off, t_off, n, m, S, W, x, o, e, min_wf_len,
                                           max_dist_diff)
        _arena_cells(packed_offsets(cells), B, S, scratch)
        return _traceback(hist, lo, done_s, n, m, CAP, x, o, e)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(B * (4 + 5 * CAP), dtype=torch.uint8, device=dev)
    nops = out[: 4 * B].view(torch.int32)
    cnts = out[4 * B: 4 * B * (1 + CAP)].view(torch.int32).view(B, CAP)
    ops = out[4 * B * (1 + CAP):].view(torch.int8).view(B, CAP)
    if B == 0:
        return ops, cnts, nops
    pairs = (seq.data_ptr(), q_off.data_ptr(), t_off.data_ptr(), n.data_ptr(), m.data_ptr(),
             B, S, W)
    sized = torch.empty(12 * B + 8, dtype=torch.uint8, device=dev)
    off = sized[: 8 * (B + 1)].view(torch.int64)
    done_s = sized[8 * (B + 1):].view(torch.int32)
    LIB.launch("wfa_size_batch", dev, *pairs, x, o, e, min_wf_len, max_dist_diff,
               off.data_ptr(), done_s.data_ptr())
    cells = _arena_cells(off, B, S, scratch)
    arena = torch.empty(2 * cells + 8 * B * S, dtype=torch.uint8, device=dev)
    LIB.launch("wfa_align_batch", dev, *pairs, CAP, x, o, e, min_wf_len, max_dist_diff,
               off.data_ptr(), arena.data_ptr(), arena.data_ptr() + 2 * cells, done_s.data_ptr(),
               ops.data_ptr(), cnts.data_ptr(), nops.data_ptr())
    with _count_lock:
        wfa_batch.launches += 1
    return ops, cnts, nops


wfa_batch.launches = 0


def decode_ops(ops, cnts, nops):
    """Host arrays of a batch's runs -> per pair its op list [(op, count),
    ...] in alignment order (None where nops < 0)."""
    out = []
    for r, w in enumerate(nops.tolist()):
        if w < 0:
            out.append(None)
            continue
        codes = ops[r, :w][::-1].tolist()
        counts = cnts[r, :w][::-1].tolist()
        out.append([(OPS[c], k) for c, k in zip(codes, counts)])
    return out
