"""Random DNA, point mutations and small indels, with the coordinate maps
that tie each mutated sequence back to the one it came from.

Sequences are uint8 arrays of 2-bit codes (A=0, C=1, G=2, T=3).  The maps
are what lets the reference say where a query's copy lies in any genome:
the benchmark plants every copy itself, so it knows the truth without
reading anything the program made.
"""

from __future__ import annotations

import numpy as np

ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_codes(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 4, size=n, dtype=np.uint8)


def revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - codes[::-1]).astype(np.uint8)


def to_ascii(codes: np.ndarray) -> bytes:
    return ASCII[codes].tobytes()


def stratified(n: int, lo: float, hi: float) -> np.ndarray:
    """n values spread evenly over [lo, hi] (the midpoints of n equal
    strata): the same set for every seed, which only orders them."""
    return lo + (np.arange(n) + 0.5) / n * (hi - lo)


def equidistributed(i: int, offset: float, step: float) -> float:
    """The i-th point of a rotation sequence in [0, 1): any run of
    consecutive points covers [0, 1) evenly, so every seed (which only
    moves `offset`) draws nearly the same set of sizes."""
    return (offset + i * step) % 1.0


class PosMap:
    """Piecewise-identity map between a source sequence and a sequence
    made from it by indels: kept blocks (src_start, dst_start, length)."""

    def __init__(self, src_start, dst_start, length, src_len: int, dst_len: int):
        self.src_start = np.asarray(src_start, dtype=np.int64)
        self.dst_start = np.asarray(dst_start, dtype=np.int64)
        self.length = np.asarray(length, dtype=np.int64)
        self.src_len = int(src_len)
        self.dst_len = int(dst_len)

    @classmethod
    def identity(cls, n: int) -> PosMap:
        return cls([0], [0], [n], n, n)

    @staticmethod
    def _apply(pos, starts, other, length, limit):
        pos = np.asarray(pos, dtype=np.int64)
        j = np.clip(np.searchsorted(starts, pos, side="right") - 1, 0, len(starts) - 1)
        off = pos - starts[j]
        inside = off < length[j]
        out = np.where(inside, other[j] + off, other[j] + length[j])  # a dropped base: the next kept
        return np.clip(out, 0, max(limit - 1, 0))

    def fwd(self, pos):
        """Source positions to positions in the mutated sequence."""
        return self._apply(pos, self.src_start, self.dst_start, self.length, self.dst_len)

    def inv(self, pos):
        """Positions in the mutated sequence to source positions."""
        return self._apply(pos, self.dst_start, self.src_start, self.length, self.src_len)


def substitute(rng, codes: np.ndarray, rate: float, allowed: np.ndarray | None = None) -> np.ndarray:
    """A copy with round(rate x len) bases changed to another base, at
    distinct positions (within `allowed`, a bool mask, where given)."""
    out = codes.copy()
    cand = np.flatnonzero(allowed) if allowed is not None else None
    pool = cand.shape[0] if cand is not None else codes.shape[0]
    n = min(int(round(rate * codes.shape[0])), pool)
    if n <= 0:
        return out
    pick = rng.choice(pool, size=n, replace=False)
    pos = cand[pick] if cand is not None else pick
    out[pos] = (out[pos] + rng.integers(1, 4, size=n, dtype=np.uint8)) % 4
    return out


def indels(rng, codes: np.ndarray, rate: float, max_len: int = 3,
           allowed: np.ndarray | None = None) -> tuple[np.ndarray, PosMap]:
    """round(rate x len) insertions or deletions of 1..max_len bases, at
    sorted positions at least max_len + 1 apart (within `allowed`, a
    bool mask of source positions where a deletion may start and every
    base it removes is allowed too).  Returns the new sequence and its
    map from `codes`."""
    n_src = codes.shape[0]
    want = int(round(rate * n_src))
    if want <= 0 or n_src <= 2 * (max_len + 1):
        return codes.copy(), PosMap.identity(n_src)
    ok = np.ones(n_src, dtype=bool) if allowed is None else allowed.copy()
    ok[:max_len + 1] = False
    ok[n_src - max_len - 1:] = False
    if allowed is not None:  # a deletion's span stays inside allowed bases
        for d in range(1, max_len + 1):
            ok[:-d] &= allowed[d:]
    cand = np.flatnonzero(ok)
    if cand.shape[0] == 0:
        return codes.copy(), PosMap.identity(n_src)
    pos = np.sort(rng.choice(cand, size=min(want * 2, cand.shape[0]), replace=False))
    keep = np.concatenate([[True], np.diff(pos) > max_len + 1])
    pos = pos[keep][:want]
    n = pos.shape[0]
    lens = rng.integers(1, max_len + 1, size=n)
    is_ins = rng.random(n) < 0.5
    pieces, src_s, dst_s, blen = [], [], [], []
    s = 0
    d = 0
    for p, ln, ins in zip(pos.tolist(), lens.tolist(), is_ins.tolist()):
        pieces.append(codes[s:p])
        src_s.append(s)
        dst_s.append(d)
        blen.append(p - s)
        d += p - s
        if ins:
            pieces.append(random_codes(rng, ln))
            d += ln
            s = p
        else:
            s = p + ln
    pieces.append(codes[s:])
    src_s.append(s)
    dst_s.append(d)
    blen.append(n_src - s)
    d += n_src - s
    return np.concatenate(pieces), PosMap(src_s, dst_s, blen, n_src, d)


def mutate(rng, codes: np.ndarray, sub_rate: float, indel_rate: float,
           allowed: np.ndarray | None = None, max_indel: int = 3) -> tuple[np.ndarray, PosMap]:
    """Substitutions, then indels; the map is from `codes`."""
    sub = substitute(rng, codes, sub_rate, allowed)
    return indels(rng, sub, indel_rate, max_indel, allowed)
