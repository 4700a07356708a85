"""Plain NumPy reference of an HSP's alignment: global, gap-affine, banded.

Cost: a mismatch 4, a gap of n bases 6 + 2n, a match 0 (the penalties of
LexicMap's WFA).  Among the alignments of least cost it takes one with the
most matches, then the fewest mismatches, so the identity it reports is
the highest that an optimal alignment of the two stretches can have.
The three goals ride in one int64 per cell,

    value = cost * S1 - matches * S2 + mismatches,

so a plain min over the Gotoh recurrences is the lexicographic order, and
the counts are decoded from the final value without a traceback.
Many pairs run at once, row by row, in the band |j - i - drift| <= W.
"""

from __future__ import annotations

import numpy as np

MISMATCH, GAP_OPEN, GAP_EXT = 4, 6, 2
S2 = 1 << 14  # above any mismatch count
S1 = 1 << 29  # above any matches * S2 (stretches under 16 kb)
INF = np.int64(1 << 61)
BAND = 64


def _decode(v: np.ndarray, n: np.ndarray, m: np.ndarray):
    cost = (v + S1 // 2) // S1
    r = v - cost * S1
    matches = (-r + S2 - 1) // S2
    mism = r + matches * S2
    gap_bases = n + m - 2 * (matches + mism)
    alen = matches + mism + gap_bases
    return cost, matches, mism, gap_bases, alen


def align_batch(pairs: list[tuple[np.ndarray, np.ndarray]], band: int = BAND) -> list[dict]:
    """[(query codes, target codes)] -> [{cost, matches, mismatches, gaps,
    alen, pident}] in order."""
    out: list[dict | None] = [None] * len(pairs)
    order = sorted(range(len(pairs)), key=lambda i: pairs[i][0].shape[0])
    for c in range(0, len(order), 32):  # similar lengths together
        idx = order[c: c + 32]
        for i, r in zip(idx, _align_group([pairs[i] for i in idx], band)):
            out[i] = r
    return out


def _align_group(pairs, band):
    B = len(pairs)
    n = np.array([p[0].shape[0] for p in pairs], dtype=np.int64)
    m = np.array([p[1].shape[0] for p in pairs], dtype=np.int64)
    if (n >= S2).any() or (m >= S2).any():
        raise ValueError("stretches of 16 kb or more are beyond the value encoding")
    dlo = np.minimum(0, m - n) - band  # band column k <-> j = i + dlo + k
    D = int((np.abs(m - n) + 2 * band + 1).max())
    N = int(n.max())
    q = np.full((B, N + 1), 255, dtype=np.uint8)
    t = np.full((B, int(m.max()) + 1), 254, dtype=np.uint8)
    for b, (qa, ta) in enumerate(pairs):
        q[b, : qa.shape[0]] = qa
        t[b, : ta.shape[0]] = ta
    k = np.arange(D, dtype=np.int64)[None, :]
    ext = GAP_EXT * S1
    opn = GAP_OPEN * S1

    j = dlo[:, None] + k  # row 0
    H = np.where(j == 0, 0, np.where((j > 0) & (j <= m[:, None]), opn + ext * j, INF))
    F = np.full((B, D), INF, dtype=np.int64)
    res = np.zeros(B, dtype=np.int64)
    done0 = n == 0
    res[done0] = H[done0, (m - n - dlo)[done0]]
    for i in range(1, N + 1):
        j = i + dlo[:, None] + k
        valid = (j >= 0) & (j <= m[:, None])
        tj = t[np.arange(B)[:, None], np.clip(j - 1, 0, t.shape[1] - 1)]
        qi = q[:, i - 1][:, None]
        sub = np.where(tj == qi, -S2, MISMATCH * S1 + 1)
        diag = np.where(j >= 1, H + sub, INF)
        up_h = np.concatenate([H[:, 1:], np.full((B, 1), INF)], axis=1)  # (i-1, j)
        up_f = np.concatenate([F[:, 1:], np.full((B, 1), INF)], axis=1)
        F = np.minimum(np.minimum(up_h, INF - opn - ext) + opn + ext,
                       np.minimum(up_f, INF - ext) + ext)
        H0 = np.minimum(diag, F)
        H0 = np.where(j == 0, opn + ext * i, H0)
        H0 = np.where(valid, H0, INF)
        # E, a run of target-only columns from (i, j') along the row:
        # min over k' < k of H0[k'] + opn + ext * (k - k')
        base = np.minimum(H0, INF // 2) - ext * k
        run = np.minimum.accumulate(base, axis=1)
        E = np.concatenate([np.full((B, 1), INF), run[:, :-1] + opn + ext * k[:, 1:]], axis=1)
        H = np.where(valid, np.minimum(H0, np.minimum(E, INF)), INF)
        fin = n == i
        if fin.any():
            res[fin] = H[fin, (m - n - dlo)[fin]]
    cost, matches, mism, gaps, alen = _decode(res, n, m)
    return [
        {"cost": int(cost[b]), "matches": int(matches[b]), "mismatches": int(mism[b]),
         "gaps": int(gaps[b]), "alen": int(alen[b]),
         "pident": 100.0 * matches[b] / alen[b] if alen[b] else 0.0}
        for b in range(B)
    ]
