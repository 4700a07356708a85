"""Plain PyTorch reference of an HSP's alignment: global, gap-affine, banded.

Cost: a mismatch 4, a gap of n bases 6 + 2n, a match 0 (the penalties of
LexicMap's WFA).  Among the alignments of least cost it takes one with the
most matches, then the fewest mismatches, so the identity it reports is
the highest that an optimal alignment of the two stretches can have.
The three goals ride in one int64 per cell,

    value = cost * S1 - matches * S2 + mismatches,

so a plain min over the Gotoh recurrences is the lexicographic order, and
the counts are decoded from the final value without a traceback.  With
S2 = 2^18 and S1 = 2^36 that holds for stretches of up to MAX_LEN =
131,071 bases (cost * S1 stays under 2^58, below INF = 2^61); longer
ones raise.

All pairs run in one batch, row by row (the query's bases), each pair in
its own band of target columns, from W left of the diagonal j = i to W
right of j = i + m - n.  W is BAND = 64 where both stretches are under
LONG = 16,384 bases, and LONG_BAND = 256 for longer ones: 100 kb at 5%
substitutions and 0.5% indels of 1-3 bases drifts some tens of bases from
the straight path, and doubling either band changes no reading, at 16 kb,
on the port's rows of 20-100 kb queries and on those of the `plasmids`
mix (52.8 kb).  The band is a pair's own, not its batch's widest.  So
the row steps are about the longest stretch, not the number of pairs.
On a CUDA device blocks of BLOCK rows are replayed as one CUDA graph;
elsewhere the same rows run eagerly.
"""

from __future__ import annotations

import numpy as np
import torch

MISMATCH, GAP_OPEN, GAP_EXT = 4, 6, 2
S2 = 1 << 18  # above any mismatch count
S1 = 1 << 36  # above any matches * S2
INF = 1 << 61
MAX_LEN = (1 << 17) - 1
BAND, LONG, LONG_BAND = 64, 1 << 14, 256
BLOCK = 256  # rows one CUDA graph replays
Q_PAD, T_PAD = 255, 254


def _decode(v: np.ndarray, n: np.ndarray, m: np.ndarray):
    cost = (v + S1 // 2) // S1
    r = v - cost * S1
    matches = (-r + S2 - 1) // S2
    mism = r + matches * S2
    gap_bases = n + m - 2 * (matches + mism)
    alen = matches + mism + gap_bases
    return cost, matches, mism, gap_bases, alen


def align_batch(pairs: list[tuple[np.ndarray, np.ndarray]], band: int | None = None,
                device: str | torch.device = "cpu") -> list[dict]:
    """[(query codes, target codes)] -> [{cost, matches, mismatches, gaps,
    alen, pident}] in order.  `band` sets W for every pair (default: BAND
    where both stretches are under LONG bases, else LONG_BAND)."""
    if not pairs:
        return []
    n = np.array([p[0].shape[0] for p in pairs], dtype=np.int64)
    m = np.array([p[1].shape[0] for p in pairs], dtype=np.int64)
    if (n > MAX_LEN).any() or (m > MAX_LEN).any():
        raise ValueError(f"stretches over {MAX_LEN} bases are beyond the value encoding")
    res = _run(pairs, n, m, band, torch.device(device))
    cost, matches, mism, gaps, alen = _decode(res, n, m)
    return [
        {"cost": int(cost[b]), "matches": int(matches[b]), "mismatches": int(mism[b]),
         "gaps": int(gaps[b]), "alen": int(alen[b]),
         "pident": 100.0 * int(matches[b]) / int(alen[b]) if alen[b] else 0.0}
        for b in range(len(pairs))
    ]


def _run(pairs, n, m, band, dev) -> np.ndarray:
    B = len(pairs)
    if band is not None:
        W = np.full(B, band, dtype=np.int64)
    else:
        W = np.where(np.maximum(n, m) < LONG, BAND, LONG_BAND)
    dlo = np.minimum(0, m - n) - W  # band column k <-> target column j = i + dlo + k
    width = np.abs(m - n) + 2 * W + 1
    D = int(width.max())
    N = int(n.max())
    graph = dev.type == "cuda" and N > BLOCK
    rows = -(-N // BLOCK) * BLOCK if graph else N
    # tables along y = i + k: row i reads columns y = i .. i + D - 1
    P = np.full((B, rows + D), T_PAD, dtype=np.uint8)
    Q = np.full((B, max(rows, 1)), Q_PAD, dtype=np.uint8)
    for b, (qa, ta) in enumerate(pairs):
        s = 1 - int(dlo[b])  # y of target column j = 1
        P[b, s: s + ta.shape[0]] = ta
        Q[b, : qa.shape[0]] = qa
    P = torch.from_numpy(P).to(dev)
    Q = torch.from_numpy(Q).to(dev)
    X = torch.where(P == T_PAD, INF, MISMATCH * S1 + 1)  # a base's cost where no match
    k = torch.arange(D, dtype=torch.int64, device=dev)[None, :]
    in_band = k < torch.from_numpy(width).to(dev)[:, None]
    col = torch.from_numpy(m - n - dlo).to(dev)[:, None]  # j = m
    opn, ext = GAP_OPEN * S1, GAP_EXT * S1
    ke, oke = ext * k, opn + ext * k[:, 1:]
    neg_s2 = torch.tensor(-S2, dtype=torch.int64, device=dev)
    inf = torch.tensor(INF, dtype=torch.int64, device=dev)
    # double-buffered rows of H and F; column D stays INF (above the band)
    H = torch.full((2, B, D + 1), INF, dtype=torch.int64, device=dev)
    F = torch.full((2, B, D + 1), INF, dtype=torch.int64, device=dev)

    def run_rows(P, X, Q, count, R):
        """`count` rows from an even row i0 on: P, X, Q and R are the tables
        from i0 on (row i0 + r + 1 reads P and X at r + 1 .., Q at r and
        writes R[r]); H[0] and F[0] hold row i0."""
        for r in range(count):
            Hs, Fs, Hd, Fd = H[r % 2], F[r % 2], H[(r + 1) % 2], F[(r + 1) % 2]
            sub = torch.where(P[:, r + 1: r + 1 + D] == Q[:, r: r + 1], neg_s2,
                              X[:, r + 1: r + 1 + D])
            h = Hs[:, :D] + sub
            f = torch.minimum(Hs[:, 1:] + (opn + ext), Fs[:, 1:] + ext, out=Fd[:, :D])
            torch.minimum(h, f, out=h)
            # E, a run of target-only columns from (i, j') along the row:
            # min over k' < k of h[k'] + opn + ext * (k - k')
            run = torch.cummin(h - ke, dim=1).values
            torch.minimum(h[:, 1:], run[:, :-1] + oke, out=h[:, 1:])
            torch.where(in_band, h.clamp_max_(INF), inf, out=Hd[:, :D])
            torch.gather(Hd[:, :D], 1, col, out=R[r].view(-1, 1))

    j = torch.from_numpy(dlo).to(dev)[:, None] + k
    m_t = torch.from_numpy(m).to(dev)[:, None]
    h0 = torch.where(j == 0, 0, torch.where((j > 0) & (j <= m_t), opn + ext * j, INF))
    H[0, :, :D] = torch.where(in_band, h0, INF)
    row0 = torch.gather(H[0, :, :D], 1, col)[:, 0]
    if N == 0:
        return row0.cpu().numpy()
    R = torch.empty((rows, B), dtype=torch.int64, device=dev)  # H at j = m, a row each
    if not graph:
        run_rows(P, X, Q, N, R)
    else:
        # the first block eagerly (the kernels' first launches), the rest
        # replayed as one captured block over static copies of its tables
        run_rows(P, X, Q, BLOCK, R)
        if rows > BLOCK:
            Pk = torch.empty((B, BLOCK + D), dtype=P.dtype, device=dev)
            Xk = torch.empty((B, BLOCK + D), dtype=X.dtype, device=dev)
            Qk = torch.empty((B, BLOCK), dtype=Q.dtype, device=dev)
            Rk = torch.empty((BLOCK, B), dtype=torch.int64, device=dev)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                run_rows(Pk, Xk, Qk, BLOCK, Rk)
            for i0 in range(BLOCK, rows, BLOCK):
                Pk.copy_(P[:, i0: i0 + BLOCK + D])
                Xk.copy_(X[:, i0: i0 + BLOCK + D])
                Qk.copy_(Q[:, i0: i0 + BLOCK])
                g.replay()
                R[i0: i0 + BLOCK].copy_(Rk)
    nz = torch.from_numpy(n).to(dev)
    done = torch.gather(R, 0, (nz - 1).clamp_min(0)[None, :])[0]
    return torch.where(nz > 0, done, row0).cpu().numpy()
