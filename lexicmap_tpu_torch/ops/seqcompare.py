"""SeqComparator: fast pseudo-alignment of a candidate target window against
the indexed query (ref: lib-seq_compare.go:115-521).

The reference indexes all query k-mers (both strands) in a radix tree and
probes it with target k-mers using >=m-base prefix matching.  Here the query
index is a SORTED K-MER ARRAY: a >=m-prefix search is a contiguous range
([kmer & ~suffix_mask, kmer | suffix_mask]) found by two binary searches, and
all target positions are probed in one vectorized pass.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils.arrays import ranges_to_indices as _ranges_to_indices

from ..utils.kmers import homopolymer_codes, is_low_complexity_dust, kmer_lcp, kmers_fwd_rc
from .chaining import Anchors, clear_substr_pairs, trim_substr_pairs
from .chaining2 import Chain2Result, Chaining2Options, chain2


@dataclass
class SeqComparatorOptions:
    k: int = 31
    min_prefix: int = 11
    chaining: Chaining2Options = field(default_factory=Chaining2Options)
    min_aligned_fraction: float = 0.0  # -q/--min-qcov-per-hsp
    min_identity: float = 70.0


@dataclass
class SeqComparatorResult:
    """(ref: SeqComparatorResult, lib-seq_compare.go:162-180)"""

    aligned_bases: int = 0
    aligned_fraction: float = 0.0
    matched_bases: int = 0
    pident: float = 0.0
    query_len: int = 0
    chains: list[Chain2Result] = field(default_factory=list)

    def update2(self, chains: list[Chain2Result], query_len: int) -> None:
        """(ref: Update2, lib-seq_compare.go:226-257)"""
        self.chains = chains
        self.query_len = query_len
        self.matched_bases = 0
        regions = []
        for c in chains:
            c.aligned_fraction = c.aligned_bases_q / query_len * 100
            regions.append((c.qbegin, c.qend))
            self.matched_bases += c.matched_bases
        self.aligned_bases = coverage_len(regions)
        self.aligned_fraction = self.aligned_bases / query_len * 100
        self.pident = min(
            (self.matched_bases / self.aligned_bases * 100) if self.aligned_bases else 0.0,
            100.0,
        )


def coverage_len(regions: list[tuple[int, int]]) -> int:
    """Total covered bases of possibly-overlapping [begin, end] regions
    (ref: coverageLen, lib-seq_compare.go:270-308)."""
    if not regions:
        return 0
    regions = sorted(regions)
    total = 0
    start, end = regions[0]
    for b, e in regions[1:]:
        if b > end:
            total += end - start + 1
            start, end = b, e
            continue
        if e <= end:
            continue
        end = e
    total += end - start + 1
    return total


def min_prefix_for(L: int, m: int) -> int:
    """The minimum prefix for a target window of length L: longer windows
    need longer prefixes (ref: lib-seq_compare.go:345-354)."""
    if L >= 1_000_000:
        return m + 8
    if L >= 250_000:
        return m + 6
    if L >= 50_000:
        return m + 4
    if L >= 10_000:
        return m + 2
    return m


class SeqComparator:
    def __init__(self, opt: SeqComparatorOptions):
        self.opt = opt
        self.k = opt.k
        self.ccc, self.ggg, self.ttt = homopolymer_codes(opt.k)[1:]
        self.qk: np.ndarray | None = None  # sorted query k-mers
        self.qv: np.ndarray | None = None  # pos<<1|strand per sorted k-mer

    def index(self, qcodes: np.ndarray) -> None:
        """Index all query k-mers, both strands (ref: Index,
        lib-seq_compare.go:115-159).  Positions whose FORWARD k-mer is
        low-complexity are excluded entirely (both strands), matching the
        reference's filter order."""
        k = self.k
        fwd, rc = kmers_fwd_rc(qcodes, k)
        n = fwd.shape[0]
        if n == 0:
            self.qk = np.empty(0, dtype=np.uint64)
            self.qv = np.empty(0, dtype=np.uint32)
            return
        bad = (fwd == 0) | (fwd == self.ccc) | (fwd == self.ggg) | (fwd == self.ttt)
        bad |= is_low_complexity_dust(fwd, k)
        keep = np.nonzero(~bad)[0]
        kk = np.concatenate([fwd[keep], rc[keep]])
        vv = np.concatenate(
            [
                (keep.astype(np.uint32) << np.uint32(1)),
                (keep.astype(np.uint32) << np.uint32(1)) | np.uint32(1),
            ]
        )
        order = np.argsort(kk, kind="stable")
        self.qk = kk[order]
        self.qv = vv[order]
        # bucket table over the top 16 bits for the native probe: valid for
        # any min_prefix >= 8 (the probe range shares its top 2m bits).
        # Built with bincount+cumsum — O(n + 2^bits) — NOT searchsorted of
        # 65537 probes, which dominated per-fragment indexing in gsearch.
        self.qtab_bits = min(16, 2 * k - 2)
        pref = (self.qk >> np.uint64(2 * k - self.qtab_bits)).astype(np.int64)
        counts = np.bincount(pref, minlength=1 << self.qtab_bits)
        self.qtab = np.zeros((1 << self.qtab_bits) + 1, dtype=np.uint32)
        np.cumsum(counts, out=self.qtab[1:], dtype=np.uint32)

    def compare(
        self, begin: int, end: int, tcodes: np.ndarray, query_len: int
    ) -> SeqComparatorResult | None:
        """(ref: Compare, lib-seq_compare.go:335-521).  begin/end bound the
        query region anchors may fall into (flanking regions are skipped)."""
        k = self.k
        L = tcodes.shape[0]
        m = min_prefix_for(L, self.opt.min_prefix)

        if L < k or self.qk is None or self.qk.shape[0] == 0:
            return None

        from ..native import (
            compare_prepare_native,
            compare_probe_codes_native,
            compare_probe_native,
        )

        copt = self.opt.chaining
        prepared = compare_prepare_native(
            self.qk, self.qv, tcodes, m, k, begin, end,
            copt.band_base, copt.band_count, copt.max_gap,
            qtab=getattr(self, "qtab", None), bbits=getattr(self, "qtab_bits", 0),
        )
        if prepared is not None:
            aq, at, al, arc, scores, prev = prepared
            n = aq.shape[0]
            if n == 0:
                return None
            anchors = Anchors(aq, at, al, arc, arc)
            if n == 1:
                res = chain2(anchors, copt)
            else:
                from .chaining2 import _chain2_finish

                Mi = int(np.argmax(scores))
                res = _chain2_finish(anchors, scores, prev, float(scores[Mi]), Mi, copt)
            return self._result_from_chain2(res, query_len)

        native = compare_probe_codes_native(
            self.qk, self.qv, tcodes, m, k, begin, end,
            qtab=getattr(self, "qtab", None), bbits=getattr(self, "qtab_bits", 0),
        )
        if native is not None:
            aq, at, al, arc = native
            if aq.shape[0] < 1:
                return None
            anchors = Anchors(aq, at, al, arc, arc)
            return self._finish_compare(anchors, query_len)

        tf, tr = kmers_fwd_rc(tcodes, k)
        nt = tf.shape[0]
        if nt == 0:
            return None

        valid = (tf != 0) & (tf != self.ccc) & (tf != self.ggg) & (tf != self.ttt)
        tpos = np.nonzero(valid)[0]
        if tpos.shape[0] == 0:
            return None

        native = compare_probe_native(
            self.qk, self.qv, tf, tr, valid, m, k, begin, end
        )
        if native is not None:
            aq, at, al, arc = native
            if aq.shape[0] < 1:
                return None
            anchors = Anchors(aq, at, al, arc, arc)
            return self._finish_compare(anchors, query_len)

        suf = np.uint64((1 << (2 * (k - m))) - 1)
        anchors_parts = []

        for strand, tk in ((0, tf[tpos]), (1, tr[tpos])):
            lb = tk & ~suf
            rb = tk | suf
            lo = np.searchsorted(self.qk, lb, side="left")
            hi = np.searchsorted(self.qk, rb, side="right")
            counts = hi - lo
            nz = counts > 0
            if not nz.any():
                continue
            lo_nz = lo[nz]
            hi_nz = hi[nz]
            t_idx = tpos[nz]
            tk_nz = tk[nz]
            idx = _ranges_to_indices(lo_nz, hi_nz)
            per = (hi_nz - lo_nz).astype(np.int64)
            t_rep = np.repeat(t_idx, per)
            tk_rep = np.repeat(tk_nz, per)
            qkm = self.qk[idx]
            qvv = self.qv[idx]
            lcp = kmer_lcp(tk_rep, qkm, k).astype(np.int64)
            if strand == 0:
                sel = (qvv & np.uint32(1)) == 0
                p = (qvv[sel] >> np.uint32(1)).astype(np.int64)
                lcps = lcp[sel]
                keep = (p >= begin) & (p + lcps <= end)
                anchors_parts.append(
                    (p[keep], t_rep[sel][keep], lcps[keep], False)
                )
            else:
                sel = (qvv & np.uint32(1)) == 1
                lcps = lcp[sel]
                p = (qvv[sel] >> np.uint32(1)).astype(np.int64) + k - lcps
                keep = ~((p + lcps < begin) | (p > end))
                anchors_parts.append(
                    (p[keep], t_rep[sel][keep] + k - lcps[keep], lcps[keep], True)
                )

        total = sum(a[0].shape[0] for a in anchors_parts)
        if total < 1:
            return None
        qb = np.concatenate([a[0] for a in anchors_parts])
        tb = np.concatenate([a[1] for a in anchors_parts])
        ln = np.concatenate([a[2] for a in anchors_parts])
        rcflags = np.concatenate(
            [np.full(a[0].shape[0], a[3], dtype=bool) for a in anchors_parts]
        )
        anchors = Anchors(qb, tb, ln, rcflags, rcflags)
        return self._finish_compare(anchors, query_len)

    def _finish_compare(self, anchors: Anchors, query_len: int):
        k = self.k
        anchors = clear_substr_pairs(anchors, k)
        anchors = trim_substr_pairs(anchors, k, 100.0)
        if len(anchors) == 0:
            return None
        return self._result_from_chain2(chain2(anchors, self.opt.chaining), query_len)

    def _result_from_chain2(self, res, query_len: int):
        chains, _nm, n_aligned_q, _nat, *_ = res
        if chains is None:
            return None
        r = SeqComparatorResult()
        r.aligned_bases = n_aligned_q
        r.query_len = query_len
        r.aligned_fraction = n_aligned_q / query_len * 100
        chains.sort(key=lambda c: c.qbegin)
        r.chains = chains
        return r

