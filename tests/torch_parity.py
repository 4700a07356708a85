"""Shared fixtures of the port's parity tests (tests/test_torch_*.py):
the synthetic 3-genome / 512-mask db of tests/test_device_search.py, query
makers, a host-bisection oracle, the seed kernels' test tables and a small
phase-4 batch.  Inputs come from numpy seeds and are handed to the JAX
package and the port alike; nothing here imports JAX, so the card's tests
(tests/test_torch_cuda.py) use it too."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lexicmap_tpu_torch.kernels import seed_locate as SL
from lexicmap_tpu_torch.kernels.seed_match import MATCH_RUN, bit_length


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Import into a test module to run it with one PyTorch intra-op
    thread: the test workers share the machine's cores, and the many small
    ops of the plain versions' loops otherwise keep every worker's thread
    pool spinning on all of them.  Restores the count afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_genomes(d, n=3, length=50000, seed=13):
    rng = np.random.default_rng(seed)
    files, seqs = [], {}
    for i in range(n):
        name = f"D{i}"
        seq = bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=length))
        seqs[name] = seq
        p = d / f"{name}.fasta"
        with open(p, "wb") as fh:
            fh.write(b">c0\n" + seq + b"\n")
        files.append(str(p))
    return files, seqs


def mutated_queries(seqs, names, start, length, n_mut, seed):
    rng = np.random.default_rng(seed)
    out = []
    for name in names:
        base = bytearray(seqs[name][start : start + length])
        for _ in range(n_mut):
            p = int(rng.integers(0, len(base)))
            base[p] = ord("ACGT"[int(rng.integers(0, 4))])
        out.append(bytes(base))
    return out


def host_triples(searcher, kmers: np.ndarray, p: int):
    """(mask, e0, n_hits) of every mask whose sorted entries hold a k-mer
    sharing >= p leading bases with the query's k-mer: plain bisection over
    the columnar store (the host engine's semantics)."""
    k = searcher.k
    suf = np.uint64((1 << (2 * (k - p))) - 1)
    hm, e0, nh = [], [], []
    for rdr in searcher.chunks:
        off = np.asarray(rdr.mask_offsets)
        ent = np.asarray(rdr.kmers)
        for mi in range(rdr.mask_begin, rdr.mask_end):
            q = kmers[mi]
            if q == 0:
                continue
            row = ent[off[mi - rdr.mask_begin] : off[mi - rdr.mask_begin + 1]]
            lo = int(np.searchsorted(row, q & ~suf, "left"))
            hi = int(np.searchsorted(row, q | suf, "right"))
            if hi > lo:
                hm.append(mi)
                e0.append(lo)
                nh.append(hi - lo)
    return (np.array(hm, dtype=np.int64), np.array(e0, dtype=np.int64),
            np.array(nh, dtype=np.int64))


def rows_of(results, qid="q"):
    from lexicmap_tpu_torch.cli import format_hit_rows

    return list(format_hit_rows(qid, 0, results))


K = 31
POLY_T16 = np.uint64(0xFFFFFFFF) << np.uint64(2 * K - 32)  # 16 T's + zeros
POLY_T15 = np.uint64(0x3FFFFFFF) << np.uint64(2 * K - 30)  # 15 T's then A's


def make_case(p, B, M=64, E=128, seed=0):
    """Random sorted rows (some empty, some partly padded), queries drawn
    half from row entries with mutated suffixes, and the two poly-T rows of
    tests/test_pallas.py:79-124.  Returns numpy (hi u32 [M,E], cnt i32 [M],
    qh u32 [B,M], qv bool [B,M])."""
    rng = np.random.default_rng(seed * 1000 + p * 10 + B)
    cnt = rng.integers(0, E + 1, size=M).astype(np.int32)
    cnt[2:6] = 0  # empty rows
    cnt[6] = E  # a full row
    table = np.zeros((M, E), dtype=np.uint64)
    for m in range(M):
        # few distinct prefixes so that ranges hold several entries
        pref = rng.integers(0, 1 << 8, size=cnt[m], dtype=np.uint64) << np.uint64(54)
        table[m, : cnt[m]] = np.sort(pref | rng.integers(0, 1 << 54, size=cnt[m], dtype=np.uint64))
    queries = rng.integers(0, 1 << 62, size=(B, M), dtype=np.uint64)
    for b in range(B):
        for m in range(M):
            if cnt[m] and rng.random() < 0.5:
                e = table[m, rng.integers(0, cnt[m])]
                queries[b, m] = e ^ (rng.integers(0, 1 << 20, dtype=np.uint64))
    # row 0: poly-T query, 3 real entries sharing its prefix
    table[0, :3] = np.sort([POLY_T16 | np.uint64(1), POLY_T16 | np.uint64(0x100), POLY_T16])
    cnt[0] = 3
    queries[:, 0] = POLY_T16 | np.uint64(0x123)
    # row 1: 15 leading T's (rb saturates), 2 real entries, the rest padding
    table[1, :2] = [POLY_T15 | np.uint64(3), POLY_T15 | np.uint64(9)]
    cnt[1] = 2
    queries[:, 1] = POLY_T15 | np.uint64(7)
    qv = rng.random((B, M)) < 0.85
    qv[:, :2] = True
    hi = np.full((M, E), SL.PAD_HI, dtype=np.uint32)
    for m in range(M):
        hi[m, : cnt[m]] = SL.split_kmers_hi_lo(table[m, : cnt[m]], K)[0]
    qh = np.where(qv, SL.split_kmers_hi_lo(queries.ravel(), K)[0].reshape(B, M), 0).astype(np.uint32)
    return hi, cnt, qh, qv


def to_torch(hi, cnt, qh, qv, device="cpu"):
    return (torch.from_numpy(hi.view(np.int32).copy()).to(device),
            torch.from_numpy(cnt.copy()).to(device),
            torch.from_numpy(qh.view(np.int32).copy()).to(device),
            torch.from_numpy(qv.copy()).to(device))


def make_edge_case(p, B, E, M=64, seed=0):
    """make_case's rows with the seed-locate kernels' edge rows: counts 0,
    1, SAMPLE - 1, SAMPLE, SAMPLE + 1 and E (rows 6-11, clamped to E), a
    full row of long runs of equal words (row 12), queries drawn from those
    rows (every other one with a mutated last base), and random non-PAD
    words past cnt in every row.  Returns numpy (hi, cnt, qh, qv) as
    make_case."""
    hi, cnt, qh, qv = make_case(p, B, M=M, E=E, seed=seed)
    rng = np.random.default_rng(seed * 7919 + E * 37 + B)
    runs = np.repeat(np.sort(rng.integers(0, 1 << 32, size=-(-E // 100), dtype=np.uint64)), 100)
    S = SL.SAMPLE
    rows = [np.sort(rng.integers(0, 1 << 32, size=min(c, E), dtype=np.uint64))
            for c in (0, 1, S - 1, S, S + 1, E)] + [runs[:E]]
    for m, vals in enumerate(rows, start=6):
        c = vals.shape[0]
        hi[m, :c] = vals.astype(np.uint32)
        cnt[m] = c
        if c:
            flip = rng.integers(0, 4, size=B, dtype=np.uint64) * (np.arange(B) % 2 == 1)
            drawn = vals[rng.integers(0, c, size=B)] ^ flip.astype(np.uint64)
            qh[:, m] = np.where(qv[:, m], drawn, 0).astype(np.uint32)
    for m in range(M):
        hi[m, cnt[m]:] = rng.integers(0, 0xFFFFFFFF, size=E - cnt[m], dtype=np.uint64)
    return hi, cnt, qh, qv


# --------------------------------------------------------------------------
# torch replays of csrc/seed_locate.cu's and seed_match.cu's searches: the
# same index arithmetic on tensors, returning the outputs and the distinct
# 32-byte table sectors each kernel reads (chip_smoke.py counts the design's
# bytes with them)

_U32 = 0xFFFFFFFF


def _bounds(qh, qv, p):
    """The valid (b, m) pairs and their lb, rb as int64."""
    suf = SL.suffix_mask(p)
    b_idx, m_idx = qv.nonzero(as_tuple=True)
    x = qh[b_idx, m_idx].to(torch.int64) & _U32
    return b_idx, m_idx, x & (_U32 ^ suf), x | suf


def _bisect(flat, base, lo, hi, x, le, touched=None, stride=1):
    """Vectorized lower bound of x (le: of the first entry > x) over
    flat[base + i * stride], i in [lo, hi); the sector ids of its probes go
    to `touched`."""
    while True:
        act = lo < hi
        if not bool(act.any()):
            return lo
        mid = (lo + hi) >> 1
        at = base + torch.where(act, mid, 0) * stride
        if touched is not None:
            touched.append(at[act] // 8)
        v = flat[at]
        right = (v <= x) if le else (v < x)
        lo = torch.where(act & right, mid + 1, lo)
        hi = torch.where(act & ~right, mid, hi)


def _outputs(B, Mb, b_idx, m_idx, e0, end, dev):
    nh = torch.zeros((B, Mb), dtype=torch.int32, device=dev)
    e0_out = torch.zeros((B, Mb), dtype=torch.int32, device=dev)
    nh[b_idx, m_idx] = (end - e0).to(torch.int32)
    e0_out[b_idx, m_idx] = e0.to(torch.int32)
    return nh, e0_out


def locate_batch_replay(hi, cnt, qh, qv, p):
    """seed_locate_batch's search on int32-bit tensors (hi [Mb, E], cnt
    [Mb], qh [B, Mb], qv [B, Mb]).  Rows of E <= SMALL_MAX_E: [0, cnt)
    staged whole (16-byte loads when E % 4 == 0), the searches in it.
    Larger rows: the sampled search (_sampled_search).  Returns (n_hits,
    e0, sectors): the distinct table sector ids read, for a 32-byte-aligned
    table."""
    Mb, E = hi.shape
    B, dev = qh.shape[0], hi.device
    flat = hi.reshape(-1).to(torch.int64) & _U32
    n = cnt.to(torch.int64).clamp(0, E)
    b_idx, m_idx, lb, rb = _bounds(qh, qv, p)
    if E <= SL.SMALL_MAX_E:
        base, nm = m_idx * E, n[m_idx]
        rows = torch.arange(Mb, device=dev)
        words = (n + 3) // 4 * 4 if E % 4 == 0 else n
        w = int(words.max()) if Mb else 0
        i = torch.arange(w, device=dev)
        sectors = ((rows[:, None] * E + i[None, :])[i[None, :] < words[:, None]]) // 8
        e0 = _bisect(flat, base, torch.zeros_like(nm), nm, lb, False)
        end = _bisect(flat, base, torch.zeros_like(nm), nm, rb, True)
        return (*_outputs(B, Mb, b_idx, m_idx, e0, end, dev), torch.unique(sectors))
    e0, end, touched = _sampled_search(flat, n, b_idx, m_idx, lb, rb, B, E)
    return (*_outputs(B, Mb, b_idx, m_idx, e0, end, dev), torch.unique(torch.cat(touched)))


def _sampled_search(flat, n, b_idx, m_idx, lb, rb, B, E):
    """seed_search.cuh's `stage_sample` and `sampled_bounds` over the rows
    of `flat` (int64 words, rows of E), sorted over [0, n[m]): pivots
    row[j*s], s = ceil(n/SAMPLE) (1 if n <= SAMPLE); c pivots on the left of
    a bound leave [(c-1)*s + 1, min(c*s, n)) to bisect.  lb's and rb's
    bisections probe the same entry while their intervals are one, so the
    union of their probes is what the kernel reads.  Returns (e0, end) of
    the (b_idx, m_idx) pairs and the list of sector-id tensors read."""
    S = SL.SAMPLE
    Mb, dev = n.shape[0], flat.device
    rows = torch.arange(Mb, device=dev)
    base, nm = m_idx * E, n[m_idx]
    s = torch.where(n > S, (n + S - 1) // S, 1)
    P = (n + s - 1) // s
    j = torch.arange(S, device=dev)
    real = j[None, :] < P[:, None]
    pos = rows[:, None] * E + torch.where(real, j[None, :] * s[:, None], 0)
    piv = torch.where(real, flat[pos], 1 << 32)  # sorted; past P above every bound
    touched = [pos[real] // 8]

    def finish(bound, le):
        """Pivots on the left of the bound, then the bisection of the
        interval they leave."""
        full = torch.zeros((Mb, B), dtype=torch.int64, device=dev)
        full[m_idx, b_idx] = bound
        c = torch.searchsorted(piv, full, right=le)[m_idx, b_idx]
        sm = s[m_idx]
        lo = torch.where(c > 0, (c - 1) * sm + 1, 0)
        hi_ = torch.where(c > 0, torch.minimum(c * sm, nm), 0)
        return _bisect(flat, base, lo, hi_, bound, le, touched)

    return finish(lb, False), finish(rb, True), touched


def shard_match_replay(seeds, queries, p):
    """match_shard's search (csrc/sharded.cu) on one shard's int32-bit
    tensors (seeds [M, E], queries [B, M]): B1's sampled search over the
    whole padded row (cnt = E) for every query != 0, then row[e0] of each
    hit for its LCP.  Returns (n_hits, e0, sectors): the distinct table
    sector ids read, for a 32-byte-aligned table."""
    M, E = seeds.shape
    B, dev = queries.shape[0], seeds.device
    flat = seeds.reshape(-1).to(torch.int64) & _U32
    n = torch.full((M,), E, dtype=torch.int64, device=dev)
    b_idx, m_idx, lb, rb = _bounds(queries, queries != 0, p)
    e0, end, touched = _sampled_search(flat, n, b_idx, m_idx, lb, rb, B, E)
    hit = end > e0
    touched.append((m_idx[hit] * E + e0[hit]) // 8)
    return (*_outputs(B, M, b_idx, m_idx, e0, end, dev), torch.unique(torch.cat(touched)))


def _single_runs(hi, cnt, qh, qv, p, touched, run):
    """seed_locate's single-query search (seed_search.cuh `locate_runs`)
    over the heads row[j*RUN], RUN = `run`, j < ceil(cnt/RUN), of the
    rows of valid queries (qh, qv [Mb]).  Every row's top head, H//2 of H =
    ceil(E/RUN), is read whatever its query and settles the top level (a
    top head at or past cnt counts as above every bound); a bisection of
    the heads left follows.  c heads on the left of a bound then leave the
    run row[(c-1)*RUN, c*RUN), read whole (all RUN words when E % RUN == 0,
    else those below cnt) and counted.  The table sector ids read go to
    `touched`.  Returns per valid row (rows, base, cnt, c0, e0, c1, end) as
    int64 [V], E > 0."""
    Mb, E = hi.shape
    dev = hi.device
    flat = hi.reshape(-1).to(torch.int64) & _U32
    _, m_idx, lb, rb = _bounds(qh[None], qv[None], p)
    base, nm = m_idx * E, cnt.to(torch.int64).clamp(0, E)[m_idx]
    half, n = -(-E // run) // 2, (nm + run - 1) // run
    touched.append((torch.arange(Mb, device=dev) * E + half * run) // 8)
    top = flat[base + half * run]

    def search(x, le):
        left = ((top <= x) if le else (top < x)) & (half < n)
        c = torch.where(left, half + 1, 0)
        c = _bisect(flat, base, c, torch.where(left, n, n.clamp(max=half)), x, le, touched,
                    stride=run)
        b = (c - 1).clamp(min=0) * run
        at = b[:, None] + torch.arange(run, device=dev)[None, :]
        inside = at < nm[:, None]
        read = (c > 0)[:, None] & (inside | (E % run == 0))
        touched.append((base[:, None] + at)[read] // 8)
        v = flat[base[:, None] + torch.where(inside, at, 0)]
        left = ((v <= x[:, None]) if le else (v < x[:, None])) & inside
        return c, torch.where(c > 0, b + left.sum(1), 0)

    (c0, e0), (c1, end) = search(lb, False), search(rb, True)
    return m_idx, base, nm, c0, e0, c1, end


def locate_single_replay(hi, cnt, qh, qv, p):
    """seed_locate's search (qh, qv [Mb]; `_single_runs` with RUN =
    SINGLE_RUN).  Returns (n_hits, e0, sectors) as locate_batch_replay."""
    Mb, E = hi.shape
    dev = hi.device
    if E == 0:
        zero = torch.zeros(Mb, dtype=torch.int32, device=dev)
        return zero, zero.clone(), torch.zeros(0, dtype=torch.int64, device=dev)
    touched = []
    m_idx, _, _, _, e0, _, end = _single_runs(hi, cnt, qh, qv, p, touched, SL.SINGLE_RUN)
    nh, e0_out = _outputs(1, Mb, torch.zeros_like(m_idx), m_idx, e0, end, dev)
    return nh[0], e0_out[0], torch.unique(torch.cat(touched))


def seed_match_replay(hi, lo, cnt, qh, ql, qv, p, k=K):
    """seed_match's search (csrc/seed_match.cu) on int32-bit tensors (hi, lo
    [Mb, E], cnt, qh, ql, qv [Mb]): `_single_runs` with RUN = MATCH_RUN
    over the hi words gives the slice [e0, end) of in-range entries and c0,
    c1 heads below lb and at or below rb.  Rows with an empty slice read no
    lo word.  Where c1 - c0 <= 1 the slice lies in the runs of heads c0 - 1
    and c1 - 1, whose
    hi words are held: those runs' lo words are read where the slice meets
    them (a run as the hi runs are read: whole when E % RUN == 0, else its
    words below cnt), and every in-range entry's LCP taken.  Longer slices
    bisect heads [c0, c1) on the full (hi, lo) key (each probe reads both
    words); the first head a with a key >= q gives the run of head a - 1,
    read in hi (unless it is one of the two held) and in lo where it meets
    the slice; the best LCP is over its in-range entries and head a's key.
    Assumes 32-byte-aligned tables.
    Returns (n_hits, e0, best_lcp, hi_sectors, lo_sectors)."""
    run = MATCH_RUN
    Mb, E = hi.shape
    dev = hi.device
    zero = torch.zeros(Mb, dtype=torch.int32, device=dev)
    if E == 0:
        none = torch.zeros(0, dtype=torch.int64, device=dev)
        return zero, zero.clone(), zero.clone(), none, none
    hi_touched, lo_touched = [], []
    m_idx, base, nm, c0, e0, c1, end = _single_runs(hi, cnt, qh, qv, p, hi_touched, run)
    fh = hi.reshape(-1).to(torch.int64) & _U32
    fl = lo.reshape(-1).to(torch.int64) & _U32
    qhi = (qh[m_idx].to(torch.int64) & _U32)[:, None]
    qlo = (ql[m_idx].to(torch.int64) & _U32)[:, None]
    lane = torch.arange(run, device=dev)[None, :]

    def lcp(pos):  # LCP of the entries at flat positions pos [V, w] with the queries
        xh, xl = fh[pos] ^ qhi, fl[pos] ^ qlo
        bits = torch.where(xh != 0, 32 - bit_length(xh), 64 - bit_length(xl))
        return torch.clamp(bits >> 1, max=k)

    def read_run(touched, b, use):  # run_load of the run at b, rows where `use`
        at = b[:, None] + lane
        touched.append((base[:, None] + at)[use[:, None] & ((at < nm[:, None]) | vec)] // 8)

    def run_best(b, use):
        """The lo words of the run at b read where it meets the slice (rows
        where `use`); the best LCP over its in-range entries."""
        use = use & (b + run > e0)
        read_run(lo_touched, b, use)
        at = b[:, None] + lane
        inr = use[:, None] & (at >= e0[:, None]) & (at < end[:, None])
        pos = base[:, None] + torch.where(inr, at, 0)
        return torch.where(inr, lcp(pos), 0).max(1).values

    vec = E % run == 0
    hit = end > e0
    short = hit & (c1 - c0 <= 1)
    best = torch.maximum(run_best((c0 - 1) * run, short & (c0 > 0)),
                         run_best((c1 - 1) * run, short & (c1 != c0)))
    long_ = hit & (c1 - c0 > 1)
    a, b = torch.where(long_, c0, 0), torch.where(long_, c1, 0)
    while True:
        act = a < b
        if not bool(act.any()):
            break
        mid = (a + b) >> 1
        pos = base + torch.where(act, mid, 0) * run
        hi_touched.append(pos[act] // 8)
        lo_touched.append(pos[act] // 8)
        less = (fh[pos] < qhi[:, 0]) | ((fh[pos] == qhi[:, 0]) & (fl[pos] < qlo[:, 0]))
        a = torch.where(act & less, mid + 1, a)
        b = torch.where(act & ~less, mid, b)
    head = long_ & (a < c1)
    best = torch.maximum(best, torch.where(
        head, lcp((base + torch.where(head, a, 0) * run)[:, None])[:, 0], 0))
    R = (a - 1) * run
    use = long_ & (R + run > e0)
    read_run(hi_touched, R, use & (a != c0) & (a != c1))
    best = torch.maximum(best, run_best(R, use))
    nh = zero.clone()
    nh[m_idx] = (end - e0).to(torch.int32)
    e0_out = zero.clone()
    e0_out[m_idx] = e0.to(torch.int32)
    lcp_out = zero.clone()
    lcp_out[m_idx] = best.to(torch.int32)
    return (nh, e0_out, lcp_out, torch.unique(torch.cat(hi_touched)),
            torch.unique(torch.cat(lo_touched)))


def seed_match_case(seed=1, M=256, E=128, dup=False):
    """The construction of tests/test_pallas.py:26-76 (rows of random sorted
    31-mers, 80% of queries drawn from their row).  dup=True gives every
    row runs of entries that share their hi word and differ in lo."""
    rng = np.random.default_rng(seed)
    n = E - 16
    if dup:
        his = rng.integers(0, 1 << 62, size=(M, n // 4), dtype=np.uint64) >> np.uint64(30)
        his = np.repeat(his, 4, axis=1) << np.uint64(30)
        table = np.sort(his | rng.integers(0, 1 << 30, size=(M, n), dtype=np.uint64), axis=1)
    else:
        table = np.sort(rng.integers(0, 1 << 62, size=(M, n), dtype=np.uint64), axis=1)
    queries = np.zeros(M, dtype=np.uint64)
    has = rng.random(M) < 0.8
    pick = rng.integers(0, n, size=M)
    queries[has] = table[np.arange(M), pick][has]
    # a quarter of the queries mutated in their last bases (best LCP < k)
    mut = rng.random(M) < 0.25
    queries[mut] ^= rng.integers(1, 1 << 12, size=int(mut.sum()), dtype=np.uint64)
    hi = np.full((M, E), SL.PAD_HI, dtype=np.uint32)
    lo = np.full((M, E), SL.PAD_HI, dtype=np.uint32)
    th, tl = SL.split_kmers_hi_lo(table.ravel(), K)
    hi[:, :n] = th.reshape(M, n)
    lo[:, :n] = tl.reshape(M, n)
    cnt = np.full(M, n, dtype=np.int32)
    cnt[3:7] = rng.integers(0, n, size=4)  # partly padded rows
    qh2, ql2 = SL.split_kmers_hi_lo(queries, K)
    qh = np.where(has, qh2, 0).astype(np.uint32)
    ql = np.where(has, ql2, 0).astype(np.uint32)
    return hi, lo, cnt, qh, ql, has


def make_match_edge_case(p, E, M=64, seed=0, dup=False):
    """seed_match's edge rows over sorted 31-mer rows: random rows (dup:
    hi words shared by runs of 4 entries) with queries drawn from them
    (exact, last bases mutated, or a low hi bit flipped) or random; the
    poly-T and saturated-rb rows (0, 1); counts 0, 1, R - 1, R, R + 1 and
    2 R + 1 for R = MATCH_RUN and SINGLE_RUN, and E (rows 2-11, clamped to
    E); a row of three long runs of equal hi words queried near the middle
    of the second (row 12: a slice of several runs, the best entry in a
    middle one), below and above every entry sharing that hi word (rows 13,
    14), and queries below and above every entry of their row (rows 15,
    16).  Random hi and lo words past cnt in every row.  Returns numpy (hi
    u32 [M, E], lo u32 [M, E], cnt i32 [M], qh u32 [M], ql u32 [M], qv bool
    [M])."""
    rng = np.random.default_rng(seed * 7919 + E * 37 + p * 3 + dup)
    top = np.uint64(1 << 62)
    cnt = rng.integers(0, E + 1, size=M)
    edges = sorted({0, 1, E} | {c for r in (MATCH_RUN, SL.SINGLE_RUN)
                                for c in (r - 1, r, r + 1, 2 * r + 1)})
    cnt[2:12] = np.minimum(edges, E)
    cnt[12:17] = E
    table = np.zeros((M, E), dtype=np.uint64)
    for m in range(M):
        c = int(cnt[m])
        if dup:
            his = np.repeat(rng.integers(0, 1 << 32, size=-(-c // 4), dtype=np.uint64), 4)[:c]
            row = (his << np.uint64(30)) | rng.integers(0, 1 << 30, size=c, dtype=np.uint64)
        else:
            row = rng.integers(0, top, size=c, dtype=np.uint64)
        table[m, :c] = np.sort(row)
    queries = rng.integers(0, top, size=M, dtype=np.uint64)
    for m in np.nonzero(cnt)[0]:
        if rng.random() < 0.6:
            e = table[m, rng.integers(0, cnt[m])]
            kind = rng.integers(0, 3)
            flip = (np.uint64(0), rng.integers(1, 1 << 12, dtype=np.uint64),
                    np.uint64(1) << np.uint64(30 + 2 * (16 - p) + 1) if p < 16 else np.uint64(1))
            queries[m] = e ^ flip[kind]
    # three runs of equal hi words (E // 3 entries each)
    his = np.sort(rng.choice(1 << 32, size=3, replace=False).astype(np.uint64))
    row = np.sort((np.repeat(his, -(-E // 3))[:E] << np.uint64(30))
                  | rng.integers(1, (1 << 30) - 1, size=E, dtype=np.uint64))
    table[12:15, :] = row
    mid = E // 3 + E // 6 if E >= 3 else 0
    queries[12] = row[mid] ^ rng.integers(1, 1 << 10, dtype=np.uint64)
    queries[13] = row[mid] >> np.uint64(30) << np.uint64(30)
    queries[14] = queries[13] | np.uint64((1 << 30) - 1)
    queries[15] = table[15, 0] - np.uint64(1) if table[15, 0] else np.uint64(0)
    queries[16] = min(table[16, E - 1] + np.uint64(1), top - np.uint64(1)) if E else np.uint64(0)
    # row 0: poly-T query, 3 real entries sharing its prefix; row 1: 15 T's
    # (rb saturates at p = 15), 2 real entries
    table[0, :3] = np.sort([POLY_T16 | np.uint64(1), POLY_T16 | np.uint64(0x100), POLY_T16])
    table[1, :2] = [POLY_T15 | np.uint64(3), POLY_T15 | np.uint64(9)]
    cnt[0], cnt[1] = min(3, E), min(2, E)
    queries[0], queries[1] = POLY_T16 | np.uint64(0x123), POLY_T15 | np.uint64(7)
    qv = rng.random(M) < 0.85
    qv[:2] = True
    qv[12:17] = True
    hi = rng.integers(0, 1 << 32, size=(M, E), dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, size=(M, E), dtype=np.uint64).astype(np.uint32)
    for m in range(M):
        c = int(cnt[m])
        hi[m, :c], lo[m, :c] = SL.split_kmers_hi_lo(table[m, :c], K)
    qh, ql = SL.split_kmers_hi_lo(queries, K)
    return (hi, lo, cnt.astype(np.int32), np.where(qv, qh, 0).astype(np.uint32),
            np.where(qv, ql, 0).astype(np.uint32), qv)


def seed_match_torch(hi, lo, cnt, qh, ql, has, device="cpu"):
    i32 = lambda a: torch.from_numpy(a.view(np.int32).copy()).to(device)  # noqa: E731
    return (i32(hi), i32(lo), torch.from_numpy(cnt.copy()).to(device), i32(qh), i32(ql),
            torch.from_numpy(has.copy()).to(device))


def phase4_tensors(device, seed=3, n_sites=24):
    """A small phase-4 batch from chip_smoke.phase4_case: the resident blob,
    the window table (both strands) and the query tables on `device`, plus
    (windows, queries-as-SeqComparators) for the host oracle."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import genome_codes, phase4_case

    from lexicmap_tpu_torch.index.search import SearchOptions
    from lexicmap_tpu_torch.ops.seqcompare import SeqComparator
    from lexicmap_tpu_torch.parallel.pseudo_device import WORDS_OUT, query_tables
    from lexicmap_tpu_torch.parallel.resident import DeviceGenomeBlob

    stores, qcodes, wins = phase4_case(2, 3, 1 << 16, 4, n_sites, seed)
    blob = DeviceGenomeBlob(stores, device=device)
    cprs = []
    for q in qcodes:
        cpr = SeqComparator(SearchOptions().seqcompare_options())
        cpr.index(q)
        cprs.append(cpr)
    win = np.zeros((len(wins), 8), dtype=np.int64)
    windows = []
    for i, (qi, st, g, a, b, rc) in enumerate(wins):
        wb, ph, L = blob.geometry(st, g, a, b, rc, WORDS_OUT)
        win[i] = (wb, ph, L, int(rc), qi, 0, qcodes[qi].shape[0] - 1, 11)
        codes = genome_codes(stores[st], g, a, b)
        windows.append((qi, np.ascontiguousarray((3 - codes)[::-1] if rc else codes), 0,
                        qcodes[qi].shape[0] - 1))
    tables, _ok = query_tables([(c.qk, c.qv) for c in cprs], torch.device(device))
    return blob, torch.from_numpy(win).to(device), tables, windows, cprs


#: pseudo_chain parameter sets of the chain stress windows, as (band_base,
#: band_count, max_gap, min_score, min_align_len, heur): the search
#: defaults; a tight band, so that the band rules break on every lane of a
#: 32-lane chunk; band_count 0, so that a break can fall on the very first
#: predecessor visited
CHAIN_PARAMS = (
    (100, 50, 20, 35.0, 50, 15.0),
    (12, 5, 8, 20.0, 25, 15.0),
    (6, 0, 8, 20.0, 25, 15.0),
)


def _sorted_anchors(qb, tb, ln):
    """Anchors in the probe's output order (qb asc, qe desc, tb asc)."""
    o = np.lexsort((tb, -(qb + ln), qb))
    return qb[o].astype(np.int64), tb[o].astype(np.int64), ln[o].astype(np.int64)


def _noisy_diagonal(rng, n, max_step=3, jitter=4, p_jump=0.05):
    """n anchors along a diagonal: qb steps of 0..max_step (0 gives equal
    qb), tb off the diagonal by up to `jitter`, and a share p_jump of
    anchors thrown far off it (tb above every later anchor's: bt > at)."""
    qb = 50 + np.cumsum(rng.integers(0, max_step + 1, n))
    tb = qb + rng.integers(-jitter, jitter + 1, n) + 40
    jump = rng.random(n) < p_jump
    tb[jump] += rng.integers(200, 5000, int(jump.sum()))
    return _sorted_anchors(qb, tb, rng.integers(11, 32, n))


def _tie_across_chunks():
    """Anchor 40's two best predecessors score equal at j = 8 (the last lane
    of its first 32-lane chunk) and j = 7 (the first lane of the next);
    every other anchor sits above it in t (bt > at).  The host loop keeps
    the smaller j."""
    qb = np.concatenate([10 * np.arange(1, 8), [100, 101], 110 + 2 * np.arange(31), [200]])
    tb = np.full(41, 1000)
    ln = np.full(41, 25)
    tb[7], ln[7] = 100, 20  # s = 2 * 20 - 0
    tb[8], ln[8] = 95, 23  # s = 2 * 23 - 6
    tb[40], ln[40] = 200, 20
    return qb.astype(np.int64), tb.astype(np.int64), ln.astype(np.int64)


def _ln_ties(n=96):
    """Anchors one base apart on one target row, ln 1: every predecessor's
    best score equals the anchor's own ln (a tie with the DP's start)."""
    qb = np.arange(n, dtype=np.int64) + 5
    return qb, np.zeros(n, dtype=np.int64), np.ones(n, dtype=np.int64)


def chain_stress_windows(seed=0, a_cap=8192):
    """The chain stress fixtures: anchor windows (qb, tb, ln int64, in the
    probe's order) for pseudo_chain's warp DP and backtrack.  Counts 1, 2,
    32, 33, 1,600 and a_cap; noisy diagonals whose band rules break on
    every lane (under CHAIN_PARAMS[1:]), equal qb and bt > at skips; a tie
    on both sides of a chunk boundary; ties with the DP's ln start; dense
    windows with many chains."""
    rng = np.random.default_rng(seed)
    wins = [_noisy_diagonal(rng, n) for n in (1, 2, 32, 33)]
    wins += [_tie_across_chunks(), _ln_ties()]
    wins += [_noisy_diagonal(rng, n, max_step=s, jitter=j, p_jump=p)
             for n, s, j, p in ((300, 1, 2, 0.1), (500, 3, 12, 0.02), (700, 6, 30, 0.2))]
    segs = []  # many short diagonal runs: many chains and regions
    for k in range(40):
        q0, t0 = 400 * k, int(rng.integers(0, 16000))
        m = int(rng.integers(3, 9))
        segs.append((q0 + 5 * np.arange(m), t0 + 5 * np.arange(m), np.full(m, 31)))
    wins.append(_sorted_anchors(*(np.concatenate(c) for c in zip(*segs))))
    wins += [_noisy_diagonal(rng, 1600), _noisy_diagonal(rng, a_cap, max_step=2)]
    return wins


def chain_tensors(windows, device="cpu", flagged=()):
    """pseudo_chain's inputs (qb, tb, ln int32 [W, A_CAP], counts, flags)
    for anchor windows; the windows listed in `flagged` carry a probe flag
    (the chain must skip them)."""
    from lexicmap_tpu_torch.kernels.pseudo_align import A_CAP, F_ANCHOR_OVERFLOW

    W = len(windows)
    cols = [torch.zeros((W, A_CAP), dtype=torch.int32) for _ in range(3)]
    for w, win in enumerate(windows):
        for col, a in zip(cols, win):
            col[w, : a.shape[0]] = torch.from_numpy(a.astype(np.int32))
    counts = torch.tensor([w[0].shape[0] for w in windows], dtype=torch.int32)
    flags = torch.zeros(W, dtype=torch.int32)
    flags[list(flagged)] = F_ANCHOR_OVERFLOW
    return [t.to(device) for t in (*cols, counts, flags)]


# ---------------------------------------------------------------------------
# chain1 forward DP (B9)

#: (max_gap, min_score, max_dist) of tests/test_device_search.py's chainer
#: differential
CHAIN1_PARAMS = (50.0, 40.0, 1000)


def _diag_set(rng, n, span, jitter, rc=False):
    qb = np.sort(rng.integers(0, span, n)).astype(np.int32)
    tb = (qb + rng.integers(-jitter, jitter, n)).astype(np.int32)
    if rc:  # reverse strand: tb falls as qb rises (the direction -1 gap)
        tb = (200_000 - tb).astype(np.int32)
    return qb, tb, rng.integers(15, 32, n).astype(np.int32)


def chain1_sets(seed=5, big=9000):
    """Anchor sets (qb, tb, ln int32, sorted by qb) drawn like
    tests/test_device_search.py:207-249: n = 2-700 along a jittered
    diagonal, a dense repeat-like set of 1,500 anchors in 900 bp (whose
    predecessors pass the JAX package's 512-anchor window), a reverse-strand
    set, and one of `big` anchors (past its largest bucket of 8,192; none
    when 0)."""
    rng = np.random.default_rng(seed)
    sets = [_diag_set(rng, n, 2500, 40) for n in (2, 7, 40, 127, 128, 300, 700)]
    sets.append(_diag_set(rng, 1500, 900, 30))
    sets.append(_diag_set(rng, 400, 3000, 40, rc=True))
    if big:
        sets.append(_diag_set(rng, big, 10 * big, 60))
    return sets


def chain1_csr(sets, device="cpu"):
    """chain1_forward's ragged inputs (qb, tb, ln int32 [N], off int64
    [G+1]) for anchor sets."""
    from lexicmap_tpu_torch.kernels.chain1 import pack_sets

    cols, off = pack_sets(sets)
    return [torch.from_numpy(a).to(device) for a in (*cols, off)]


def chain1_replay(qb, tb, ln, gtab, max_gap, min_score, max_dist, warps=1):
    """The chain1 kernel's scan of one genome in numpy, on its warp path
    (warps=1: one warp takes the chunks j = i-1-lane, i-33-lane, ..., two
    an iteration) or its block path (warps=4: warp w takes chunks w, w+4,
    ... in rounds).  The breaks of an iteration's or a round's chunks are
    balloted first (qb only), and no chunk past the first break is
    scanned; in a scanned chunk the lanes before the first breaking one
    count.  Each lane keeps its best by strict improvement; the maximum
    over (score, j) takes the larger j on equal scores.  Returns (ms f32,
    prev i64, dirs i8, flag, counts) with counts {visits: the predecessors
    the native scan reads, up to its break; chunks: the 32-lane chunks
    scanned; rounds: the steps' iterations (warp path) or rounds (block
    path); past_ring: predecessors read from global memory, older than
    the path's ring of 512 or 2,048}."""
    f32 = np.float32
    n = qb.shape[0]
    q, t, l = (a.astype(np.int64) for a in (qb, tb, ln))
    ring = 512 if warps == 1 else 512 * warps

    def sw(x):
        return (f32(0.1) * x.astype(f32)) * x.astype(f32)

    ms = np.zeros(n, f32)
    prev = np.zeros(n, np.int64)
    dirs = np.zeros(n, np.int8)
    if n:
        ms[0] = sw(l[:1])[0]
    lanes = np.arange(32)
    flag = 0
    counts = {"visits": 0, "chunks": 0, "rounds": 0, "past_ring": 0}

    def chunk(i, c):
        """Chunk c of step i: (best score [32] or -inf, key j << 1 | fwd,
        whether it breaks, the flag)."""
        aq, at, al = q[i], t[i], l[i]
        m0 = sw(l[i: i + 1])[0]
        j = i - 1 - 32 * c - lanes
        inn = j >= 0
        jj = np.where(inn, j, 0)
        bq, bt, bl = q[jj], t[jj], l[jj]
        qd = aq - bq
        brk = inn & (qd > max_dist)
        first = int(np.argmax(brk)) if brk.any() else 32
        live = inn & (lanes < first)
        counts["chunks"] += 1
        counts["past_ring"] += int((inn & (j < i - ring)).sum())
        td = at - bt
        atd = np.abs(td)
        cand = live & (qd != 0) & (atd <= max_dist) & (td != 0)
        g = np.abs(np.where(at >= bt, np.abs(qd) - atd,
                            np.abs(qd) - np.abs((at + al) - (bt + bl))))
        cand &= g.astype(f32) <= f32(max_gap)
        over = cand & (g >= gtab.shape[0])
        cand &= ~over
        bqe = bq + bl
        sw_len = sw(np.where(aq > bqe, al, np.where(g == 0, aq + al - bq, aq + al - bqe)))
        sw_bl = sw(bl)
        w = np.where((aq > bqe) | (g != 0), sw_len, -sw_bl + sw_len)
        d = np.where(at >= bt, 1, -1)
        base = np.where((dirs[jj] == 0) | (dirs[jj] == d), ms[jj], sw_bl)
        sc = (base + w) - gtab[np.clip(g, 0, gtab.shape[0] - 1)]
        ok = cand & (sc >= f32(min_score)) & (sc > m0)
        visits = int(live.sum()) + int(brk.any())
        return (np.where(ok, sc, f32(-np.inf)), np.where(ok, (j << 1) | (d > 0), -1),
                bool(brk.any()), int(over.any()), visits)

    def breaks(i, c):
        j = i - 1 - 32 * c - lanes
        return bool(((j >= 0) & (q[i] - q[np.maximum(j, 0)] > max_dist)).any())

    per = 2 if warps == 1 else warps  # chunks an iteration or a round
    for i in range(1, n):
        best = np.full((warps, 32), -np.inf, f32)
        key = np.full((warps, 32), -1, np.int64)
        nchunks = -(-i // 32)
        for r in range(-(-nchunks // per)):
            counts["rounds"] += 1
            cs = list(range(r * per, min(r * per + per, nchunks)))
            brk = [z for z, c in enumerate(cs) if breaks(i, c)]
            for z, c in enumerate(cs[: brk[0] + 1] if brk else cs):  # none past a break
                w = 0 if warps == 1 else z
                sc, k, _, over, visits = chunk(i, c)
                flag |= over
                counts["visits"] += visits
                take = sc > best[w]  # lane-local strict improvement, j descending
                best[w], key[w] = np.where(take, sc, best[w]), np.where(take, k, key[w])
            if brk:
                break
        found = key >= 0
        m0 = sw(l[i: i + 1])[0]
        if found.any():
            top = best[found].max()
            k = key[found & (best == top)].max()
            ms[i], prev[i], dirs[i] = top, k >> 1, 1 if k & 1 else -1
        else:
            ms[i], prev[i], dirs[i] = m0, i, 0
    return ms, prev, dirs, flag, counts


# ---------------------------------------------------------------------------
# WFA (B8)


def mutate_pair(rng, n, sub_rate, indel_rate, max_indel=8):
    """A random query of n bases and a target from it with substitutions
    and indels of up to max_indel bases (tests/test_wfa_device.py's
    generator)."""
    q = rng.integers(0, 4, size=n).astype(np.uint8)
    t = []
    i = 0
    while i < n:
        r = rng.random()
        if r < indel_rate:
            ln = int(rng.integers(1, max_indel + 1))
            if rng.random() < 0.5:
                t.extend(rng.integers(0, 4, size=ln))  # insertion in t
            else:
                i += ln  # deletion from q
            continue
        if r < indel_rate + sub_rate:
            t.append((int(q[i]) + int(rng.integers(1, 4))) % 4)
        else:
            t.append(int(q[i]))
        i += 1
    return q, np.array(t, dtype=np.uint8)


#: (length, substitution rate, indel rate) of tests/test_wfa_device.py
WFA_CASES = (
    (40, 0.0, 0.0),
    (64, 0.05, 0.0),
    (120, 0.02, 0.01),
    (300, 0.05, 0.01),
    (500, 0.10, 0.02),
    (1500, 0.02, 0.005),
    (1500, 0.08, 0.01),
)


def wfa_pairs(seed=42, per_case=3):
    """WFA_CASES pairs, pure-indel pairs (a deletion of 10, an insertion of
    12, at the start and the end too), identical pairs, and last one pair of
    unrelated 1,500-base sequences, whose cost overflows the 1,024 scores of
    its bucket (the host's)."""
    rng = np.random.default_rng(seed)
    pairs = [mutate_pair(rng, n, sub, ind) for n, sub, ind in WFA_CASES for _ in range(per_case)]
    q = rng.integers(0, 4, size=100).astype(np.uint8)
    ins = rng.integers(0, 4, 12).astype(np.uint8)
    pairs += [(q, np.concatenate([q[:50], q[60:]])), (q, np.concatenate([q[:50], ins, q[50:]])),
              (q, q[10:].copy()), (q, np.concatenate([q, ins])), (q, q.copy()),
              (rng.integers(0, 4, 777).astype(np.uint8),) * 2]
    pairs.append((rng.integers(0, 4, 1500).astype(np.uint8),
                  rng.integers(0, 4, 1500).astype(np.uint8)))
    return pairs


def wfa_tensors(pairs, device="cpu"):
    """wfa_batch's inputs (seq, q_off, t_off, n, m) for pairs."""
    from lexicmap_tpu_torch.kernels.wfa import pack_pairs

    return [torch.from_numpy(a).to(device) for a in pack_pairs(pairs)]


def wfa_span_replay(hist, lo, done_s, x=4, o=6, e=2):
    """The WFA forward kernel's schedule replayed from the plain pass's
    history (`kernels/wfa.py::_forward`): per pair, each score's span
    [min(source tlo - dk), max(source thi + dk)] over the live spans of its
    source rows s-x (dk 0), s-o-e and s-e (dk 1), as the kernel computes it
    one warp a pair, 32 diagonals a pass.  Returns one dict a pair: `spans`
    (the widths of the scores it computes, up to its end or the score
    whose span overflows), `max_span` (that score's too), `cells` (their
    sum: the native row widths), `passes`, `dead` (scores with no live
    source), and `hist_cells`, the int16 history cells the kernel writes
    (three a diagonal of each computed span, and the three of score 0)."""
    from lexicmap_tpu_torch.kernels.wfa import BIG, NEG

    h, lo = hist.numpy(), lo.numpy()
    B, S = lo.shape
    out = []
    for b in range(B):
        tlo = np.full(S, BIG, np.int64)
        thi = np.full(S, -BIG, np.int64)
        last = int(done_s[b]) if int(done_s[b]) >= 0 else S - 1
        spans, dead, max_span = [], 0, 1
        tlo[0] = thi[0] = 0
        for s in range(1, last + 1):
            kmin, kmax = BIG, -BIG
            for src, dk in ((s - x, 0), (s - o - e, 1), (s - e, 1)):
                if src >= 0 and tlo[src] <= thi[src]:
                    kmin, kmax = min(kmin, tlo[src] - dk), max(kmax, thi[src] + dk)
            if kmin > kmax:
                dead += 1
                continue
            width = kmax - kmin + 1
            max_span = max(max_span, width)
            if lo[b, s] == BIG:  # the plain pass stopped here: the span overflowed
                break
            assert lo[b, s] == kmin
            spans.append(width)
            live = np.nonzero((h[b, s] > NEG).any(0))[0]
            if live.size:
                tlo[s], thi[s] = kmin + live[0], kmin + live[-1]
        out.append({"spans": spans, "max_span": int(max_span), "cells": int(sum(spans)),
                    "passes": sum(-(-w // 32) for w in spans), "dead": dead,
                    "hist_cells": 3 * (1 + int(sum(spans)))})
    return out


#: pairs whose largest WFA span (wfa_span_replay's max_span under the
#: default penalties) is exactly the key: ("mutated", seed, index) is the
#: index-th mutate_pair of 200-1,200 bases at 5-25% substitutions and 0-6%
#: indels drawn from default_rng(seed); ("divergent", seed, r) shares 150
#: bases on each side of r unrelated ones
WFA_SPAN_PAIRS = {32: ("mutated", 1021, 34), 33: ("divergent", 1, 11),
                  128: ("mutated", 1017, 29), 129: ("divergent", 3, 50)}


def wfa_span_pair(span):
    """The pair of WFA_SPAN_PAIRS whose largest span is `span`."""
    kind, seed, arg = WFA_SPAN_PAIRS[span]
    rng = np.random.default_rng(seed)
    if kind == "mutated":
        for _ in range(arg + 1):
            pair = mutate_pair(rng, int(rng.integers(200, 1200)), float(rng.uniform(0.05, 0.25)),
                               float(rng.uniform(0.0, 0.06)))
        return pair
    p, s = rng.integers(0, 4, 150), rng.integers(0, 4, 150)
    q = np.concatenate([p, rng.integers(0, 4, arg), s]).astype(np.uint8)
    t = np.concatenate([p, rng.integers(0, 4, arg), s]).astype(np.uint8)
    return q, t


def wfa_edge_cases():
    """WFA batches at the kernels' boundaries, as (name, pairs, S, W, CAP,
    answered): largest spans of 32 and 33 diagonals (one pass or two) and
    of W and W+1 (answered or flagged); a pair whose end is score S-1 and
    the same with one score fewer; a pair of exactly CAP runs and the same
    with one run fewer."""
    from lexicmap_tpu_torch.kernels.wfa import _forward, wfa_plain

    out = [(f"span {span}, W {W}", [wfa_span_pair(span)], S, W, S + 8, ok)
           for span, W, S, ok in ((32, 32, 1024, True), (33, 32, 1024, False),
                                  (33, 64, 1024, True), (128, 128, 2048, True),
                                  (129, 128, 1024, False), (129, 160, 1024, True))]
    pair = wfa_pairs()[12]  # 500 bases at 10% substitutions, 2% indels
    args = wfa_tensors([pair])
    d = int(_forward(*args, 1024, 128, 4, 6, 2, 10, 50)[2][0])
    r = int(wfa_plain(*args, 1024, 128, 1032)[2][0])
    out += [("end at score S-1", [pair], d + 1, 128, d + 9, True),
            ("end needs score S", [pair], d, 128, d + 8, False),
            ("CAP runs", [pair], 1024, 128, r, True),
            ("CAP - 1 runs", [pair], 1024, 128, r - 1, False)]
    return out


def tree_bytes(root):
    """{path relative to root: bytes} of every file under an index tree."""
    import os

    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def mask_kmer_codes(mask, k):
    """The k bases whose forward k-mer is `mask`."""
    return np.array([(int(mask) >> (2 * (k - 1 - t))) & 3 for t in range(k)], dtype=np.uint8)


def capture_cases(seed=50):
    """Capture inputs at small size, as (name, masks uint64, k, codes,
    exclude): a random genome; exclusions at both ends; k = 21 and 32; a
    mask's own k-mer as a tandem repeat 20,000 times (more than two of the
    kernel's SORT_CAP runs, so its slice is merged); a homopolymer, whose
    k-mer wins at every position; a distinct prefix of 14 bases (the
    bucket table's bisection); a genome of exactly k bases; every position
    excluded."""
    from lexicmap_tpu_torch.masks import MaskSet

    rng = np.random.default_rng(seed)

    def codes(n):
        return rng.integers(0, 4, size=n, dtype=np.uint8)

    m31 = MaskSet.generate(31, 512, 1).masks
    out = [("random", m31, 31, codes(200_000), None)]
    c = codes(150_000)
    ex = np.zeros(c.shape[0] - 30, dtype=bool)
    ex[:77] = ex[50_000:52_000] = ex[-5:] = True
    c[90_000:91_000] = c[10_000:11_000]
    out.append(("exclusions and a repeat", m31, 31, c, ex))
    for k in (21, 32):
        out.append((f"k={k}", MaskSet.generate(k, 256, 7).masks, k, codes(120_000), None))
    c = codes(700_000)
    c[20_000: 20_000 + 20_000 * 31] = np.tile(mask_kmer_codes(m31[5], 31), 20_000)
    out.append(("tandem repeat of a mask's k-mer", m31, 31, c, None))
    p = MaskSet(m31, 31).distinct_prefix_len
    homo = next(b for b in range(4)  # a base whose homopolymer k-mer has a mask's bucket
                if ((m31 >> np.uint64(2 * (31 - p))) == np.uint64(int(str(b) * p, 4))).any())
    out.append(("homopolymer", m31, 31, np.full(300_000, homo, dtype=np.uint8), None))
    sparse = rng.integers(0, 1 << 62, size=64, dtype=np.uint64)
    sparse[1] = sparse[0] ^ np.uint64(1 << (2 * (31 - 13) - 1))
    c = codes(80_000)
    for i, mk in enumerate(np.sort(sparse)[:8]):
        c[1_000 + 100 * i: 1_031 + 100 * i] = mask_kmer_codes(mk, 31)
    out.append(("distinct prefix of 14", sparse, 31, c, None))
    out.append(("exactly k bases", m31, 31, codes(31), None))
    c = codes(5_000)
    out.append(("all excluded", m31, 31, c, np.ones(c.shape[0] - 30, dtype=bool)))
    return out


# ---------------------------------------------------------------------------
# the sharded matcher's cases (tests/test_torch_sharded.py,
# tests/test_torch_multiproc.py, tests/test_torch_cuda.py)


def sharded_db(d):
    """The 4-genome (40 kb), 512-mask index of
    tests/test_parallel.py::test_sharded_full_pipeline_tsv_identical, built
    with the port's `build_index` under `d`, and its four queries (two
    exact windows, a mutated one, a chimera).  Returns (db, seqs, queries)."""
    from lexicmap_tpu_torch.index.build import BuildOptions, build_index

    rng = np.random.default_rng(11)
    files, seqs = [], {}
    for i in range(4):
        seq = bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=40000))
        path = d / f"G{i}.fasta"
        with open(path, "wb") as fh:
            fh.write(b">c0\n" + seq + b"\n")
        seqs[f"G{i}"] = seq
        files.append(str(path))
    db = str(d / "g.lmt")
    build_index(db, files, BuildOptions(k=31, n_masks=512, chunks=2))
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    q3 = bytearray(seqs["G1"][2000:4000])
    for pos in rng.integers(0, len(q3), size=20):
        q3[pos] = alphabet[rng.integers(0, 4)]
    queries = [seqs["G0"][5000:7000], seqs["G2"][10000:11500], bytes(q3),
               seqs["G3"][1000:2200] + seqs["G0"][30000:31000]]
    return db, seqs, queries


def screening_case(d):
    """The hi-word table (256 masks, sorted rows padded with 0xFFFFFFFF) and
    the 8 queries (two windows, four times) of
    tests/test_parallel.py::test_sharded_screening_real_index, the index
    built with the port's `build_index` under `d`.  Returns (table u32
    [256, E], queries u32 [8, 256])."""
    from lexicmap_tpu_torch.index.build import BuildOptions, build_index
    from lexicmap_tpu_torch.index.search import IndexSearcher, SearchOptions
    from lexicmap_tpu_torch.utils.kmers import seq_to_codes

    rng = np.random.default_rng(9)
    files, seqs = [], {}
    for i in range(3):
        seq = bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=30000))
        path = d / f"S{i}.fasta"
        with open(path, "wb") as fh:
            fh.write(b">c0\n" + seq + b"\n")
        seqs[f"S{i}"] = seq
        files.append(str(path))
    db = str(d / "s.lmt")
    build_index(db, files, BuildOptions(k=31, n_masks=256, chunks=2))
    idx = IndexSearcher(db, SearchOptions())
    per_mask = []
    for rdr in idx.chunks:
        km = np.asarray(rdr.kmers)
        off = np.asarray(rdr.mask_offsets)
        for mi in range(rdr.mask_end - rdr.mask_begin):
            per_mask.append(np.sort(SL.split_kmers_hi_lo(km[off[mi]: off[mi + 1]], 31)[0]))
    E = max(((max(len(a) for a in per_mask) + 7) // 8) * 8, 8)
    table = np.full((256, E), np.uint32(0xFFFFFFFF), dtype=np.uint32)
    for i, a in enumerate(per_mask):
        table[i, : a.shape[0]] = a
    queries = []
    for name in ["S0", "S2"]:
        kmers, _ = idx._mask_query(seq_to_codes(seqs[name][4000:6000]))
        h = SL.split_kmers_hi_lo(kmers, 31)[0]
        h[kmers == 0] = 0
        queries.append(h)
    return table, np.stack(queries * 4)


SHARD_CASES = ("random", "pad_all_T", "zero_queries", "E1", "e0_is_E", "k12")


def shard_kernel_case(name, seed=0):
    """Inputs of seed_match_shard (B11): (seeds u32 [M, E], rows sorted
    over all E words; queries u32 [B, M]; k; p).
      random: JAX's test (64 x 32, 4 queries drawn from the rows), with
        mutated suffixes and empty lanes;
      pad_all_T: rows padded with 0xFFFFFFFF and holding all-T prefixes,
        queries whose range reaches 0xFFFFFFFF (the pad words count);
      zero_queries: no query k-mer;
      E1: rows of one word;
      e0_is_E: full rows, queries above every word of their row;
      k12: k = 12, p = 8 (the LCP's k - 16 term is negative)."""
    rng = np.random.default_rng(seed)
    k, p = (12, 8) if name == "k12" else (16, 12)
    M, E, B = {"E1": (48, 1, 5), "pad_all_T": (40, 24, 6)}.get(name, (64, 32, 4))
    top = 1 << 31 if name == "e0_is_E" else 1 << (2 * k)  # e0_is_E: room above the rows
    seeds = np.sort(rng.integers(1, top, size=(M, E), dtype=np.uint32), axis=1)
    queries = seeds[np.arange(M)[None, :], rng.integers(0, E, size=(B, M))]
    queries ^= rng.integers(0, 1 << (2 * (k - p)), size=(B, M), dtype=np.uint32)
    queries[rng.random((B, M)) < 0.15] = 0
    if name == "pad_all_T":
        cnt = rng.integers(0, E, size=M)
        tail = np.uint32(0xFFFFFF00) + rng.integers(0, 0x100, size=(M, E), dtype=np.uint32)
        seeds[:, E // 2:] = tail[:, E // 2:]
        seeds = np.sort(seeds, axis=1)
        seeds[np.arange(E)[None, :] >= cnt[:, None]] = 0xFFFFFFFF
        queries[: B // 2] = np.uint32(0xFFFFFF00) + rng.integers(
            0, 0x100, size=(B // 2, M), dtype=np.uint32)
        queries[0, 0] = 0xFFFFFFFF
    elif name == "zero_queries":
        queries[:] = 0
    elif name == "e0_is_E":
        above = seeds[:, -1] | np.uint32((1 << (2 * (k - p))) - 1)  # q & ~suf above the row
        queries[: B // 2] = above[None, :] + 1 + rng.integers(
            0, 1000, size=(B // 2, M), dtype=np.uint32)
    return seeds, queries, k, p


SHARD_STACK_KINDS = ("random", "pad_rows", "all_T", "zero_queries")


def shard_stack_case(L, B, M, E, kind="random", seed=0, k=16, p=15):
    """Inputs of seed_match_shard over a rank's L shards, as shard_arrays
    lays them out: (seeds u32 [L, M, E], rows sorted over all E words;
    queries u32 [L, B, M]; k; p).
      random: random rows, queries drawn from them with mutated suffixes,
        a fifth of them 0;
      pad_rows: every third row all pad words (0xFFFFFFFF), the others
        padded after a random count;
      all_T: rows of all-T prefixes (0xFFFFFFxx) then pad words, and
        all-T queries, whose ranges reach the pad words;
      zero_queries: no query k-mer."""
    rng = np.random.default_rng(seed * 7 + L * 1000 + B * 10 + E)
    top = np.uint64(1) << np.uint64(2 * k)
    seeds = np.sort(rng.integers(1, top, size=(L, M, E), dtype=np.uint64), axis=2).astype(np.uint32)
    if kind in ("pad_rows", "all_T"):
        if kind == "all_T":
            seeds = np.sort(np.uint32(0xFFFFFF00) + rng.integers(
                0, 0xF0, size=(L, M, E), dtype=np.uint32), axis=2)
        cnt = rng.integers(0, E + 1, size=(L, M))
        cnt[:, ::3] = 0 if kind == "pad_rows" else cnt[:, ::3]
        seeds[np.arange(E)[None, None, :] >= cnt[:, :, None]] = 0xFFFFFFFF
    pick = rng.integers(0, E, size=(L, B, M))
    queries = np.take_along_axis(seeds, pick.transpose(0, 2, 1), axis=2).transpose(0, 2, 1)
    queries = queries ^ rng.integers(0, 1 << (2 * (k - p)), size=(L, B, M), dtype=np.uint32)
    if kind == "all_T":
        queries = np.uint32(0xFFFFFF00) + rng.integers(0, 0x100, size=(L, B, M), dtype=np.uint32)
    queries[rng.random((L, B, M)) < 0.2] = 0
    if kind == "zero_queries":
        queries[:] = 0
    return np.ascontiguousarray(seeds), np.ascontiguousarray(queries), k, p


def compact_case(B, mb, hit_rate, seed=0, n_pad=0):
    """Inputs of shard_compact: nh, e0 int32 [B, mb] (about `hit_rate` of
    the cells with hits; the last `n_pad` rows padding, never hit) and gids
    int32 [mb] rising with the row, -1 on the padding."""
    rng = np.random.default_rng(seed)
    nh = np.where(rng.random((B, mb)) < hit_rate, rng.integers(1, 50, size=(B, mb)), 0)
    nh[:, mb - n_pad:] = 0
    e0 = rng.integers(0, 1 << 20, size=(B, mb))
    gids = np.cumsum(rng.integers(1, 9, size=mb))
    gids[mb - n_pad:] = -1
    return tuple(torch.from_numpy(a.astype(np.int32)) for a in (nh, e0, gids))
