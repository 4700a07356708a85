"""Genome search: ANI/AF between query genomes and indexed genomes.

Re-derivation of the reference's genome-vs-index pipeline:
- screening (ref: GSearchScreen, lib-index-search-genome.go:112-534):
  windowed LexicHash masking of the query genome, >=p-prefix seed matching,
  candidate genomes scored by the summed matched-prefix lengths;
- fragment alignment (ref: GSearchAlign3Sampled, lib-index-search-genome3.go
  :614-952): the query is cut into fragments; FracMinHash-sampled 13-mers
  anchor each fragment against a subject sketch built over the subject's
  forward+RC concatenation; chains are pseudo-aligned and WFA-aligned;
  per-genome ANI = mean fragment pident, AF = aligned bases / genome size;
- direct comparison (ref: CompareTwoGenomes, genome3.go:956-1120) for
  `genome compare`;
- similar-pair discovery (ref: pair.go) for `genome pair`.

FracMinHash sampling uses the reference's exact hash (util.Hash64 = Thomas
Wang's 64-bit integer hash, ref: util/util.go:27-37), so the sampled k-mer
sets match the reference's bit-for-bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import BITS_GENOME_IDX, BITS_NONE_IDX, MASK_GENOME_IDX
from ..ops.chaining import Anchors, clear_substr_pairs, trim_substr_pairs
from ..ops.chaining2 import Chaining2Options, chain2
from ..ops.extend import extend_match
from ..ops.masking import capture, find_gap_regions, skip_mask_from_regions
from ..ops.seqcompare import SeqComparator, SeqComparatorOptions
from ..ops.align import score_and_evalue
from ..utils.hashes import wang_hash64
from ..ops.wfa import wfa_align
from ..utils.kmers import (
    homopolymer_codes,
    is_low_complexity_dust,
    kmer_lcp,
    kmers_fwd_rc,
    seq_to_codes,
)
from .search import IndexSearcher, _ranges_to_indices, searchsorted_segments

GSA3_SAMPLED_K = 13  # ref: lib-index-search-genome3.go:97
GSA3_SAMPLING_SCALE = 4  # ref: lib-index-search-genome3.go:98


@dataclass
class GSearchOptions:
    """(ref: search-genome.go:714-832 flags)"""

    min_prefix: int = 21  # -p/--seed-min-prefix
    windows: int = 1
    frag_size: int = 1020
    min_frag_size: int = 100
    top_n: int = 10  # -n/--top-n-genomes
    top_n_chains: int = 5
    min_af: float = 15.0  # percent
    kmer_scale: int = GSA3_SAMPLING_SCALE
    max_subject_genome_size: int = 20_000_000
    ortho_ani: bool = False
    only_screening: bool = False
    min_identity: float = 70.0
    min_qcov_frag: float = 0.0
    align_min_match_len: int = 30
    align_max_gap: int = 100
    align_band: int = 100
    max_evalue: float = 10.0
    extend_length2: int = 50

    def chaining2_options(self) -> Chaining2Options:
        return Chaining2Options(
            max_gap=self.align_max_gap,
            min_score=int(self.align_min_match_len * self.min_identity / 100),
            min_align_len=self.align_min_match_len,
            min_identity=self.min_identity,
            band_base=self.align_band,
            band_count=self.align_band // 2,
        )

    def seqcompare_options(self) -> SeqComparatorOptions:
        return SeqComparatorOptions(
            k=31,
            min_prefix=11,
            chaining=self.chaining2_options(),
            min_aligned_fraction=self.min_qcov_frag,
            min_identity=self.min_identity,
        )


@dataclass
class GQuery:
    """A query genome (ref: GQuery, search-genome-util.go)."""

    id: bytes
    seqs: list[np.ndarray]  # per-contig 2-bit codes
    big_codes: np.ndarray  # contigs joined by k A's (from N's)
    skip_regions: list[tuple[int, int]]
    genome_size: int


def read_genome_query(path: str, k: int) -> GQuery | None:
    """(ref: GenomeReader.Read, search-genome-util.go:127-199)"""
    from ..utils.fasta import genome_id_from_filename, read_fastx

    seqs = []
    parts = []
    skip = []
    size = 0
    pos = 0
    gid = genome_id_from_filename(path).encode()
    for rec in read_fastx(path):
        if parts:
            skip.append((pos, pos + k - 1))
            parts.append(b"N" * k)
            pos += k
        parts.append(rec.seq)
        seqs.append(seq_to_codes(rec.seq))
        size += len(rec.seq)
        pos += len(rec.seq)
    if not parts:
        return None
    big = b"".join(parts)
    skip.extend(find_gap_regions(big))
    skip.sort()
    return GQuery(
        id=gid,
        seqs=seqs,
        big_codes=seq_to_codes(big),
        skip_regions=skip,
        genome_size=size,
    )


@dataclass
class GSearchResult:
    batch_genome_index: int
    genome_id: bytes = b""
    genome_size: int = 0
    num_seqs: int = 0
    ani: float = 0.0  # fraction
    af_q: float = 0.0  # fraction
    af_s: float = 0.0
    aligned_fragments: int = 0
    aligned_length: int = 0
    aligned_matches: int = 0
    screen_score: int = 0


# --------------------------------------------------------------------------
# hashing for FracMinHash sampling


def hash64(x: np.ndarray) -> np.ndarray:
    """The reference's util.Hash64 — Thomas Wang's 64-bit integer hash
    (ref: util/util.go:27-37) — so FracMinHash sampling keeps exactly the
    same k-mers as the reference (ref: lib-index-search-genome3.go:154)."""
    return wang_hash64(x)


# --------------------------------------------------------------------------
# screening


def gsearch_screen(idx: IndexSearcher, q: GQuery, opt: GSearchOptions):
    """Candidate-genome screening (ref: GSearchScreen).

    Returns a list of (codes_of_genome_chunks, score) sorted by score desc,
    truncated to top_n."""
    ms = idx.mask_set
    k = idx.k
    ccc, ggg, ttt = homopolymer_codes(k)[1:]
    L = q.big_codes.shape[0]
    windows = max(opt.windows, 1)
    step = L // (windows + 1) if windows > 1 else L
    window = step * 2 if windows > 1 else L

    # per-window capture vectors [m] (0 = no captured k-mer for that mask)
    window_vecs: list[np.ndarray] = []
    for i in range(windows):
        start = i * step
        end = L if i == windows - 1 else start + window
        regions = [
            (s - start, e - start)
            for s, e in q.skip_regions
            if e >= start and s < end
        ]
        res = capture(ms, q.big_codes[start:end], regions, check_shorter_prefix=True)
        kk = res.kmers.copy()
        bad = (
            (kk == 0) | (kk == ccc) | (kk == ggg) | (kk == ttt)
            | is_low_complexity_dust(kk, k)
        )
        kk[bad] = 0
        window_vecs.append(kk)
    if windows > 1:
        # dedup per mask across windows (the reference scores each distinct
        # (mask, k-mer) once)
        for w in range(1, windows):
            dup = np.zeros(ms.m, dtype=bool)
            for w2 in range(w):
                dup |= window_vecs[w] == window_vecs[w2]
            window_vecs[w][dup] = 0

    p = opt.min_prefix

    # device screening: the window capture vectors are exactly the seed
    # matcher's query format ([m] k-mers, 0 = none), so candidate screening
    # is ONE batched device prefix match over all windows — the same CUDA
    # kernel as search phase 2a (parallel/device_search.py).  The hi-word
    # tables cover prefixes up to 16 bases; for the deeper gsearch prefix
    # (21 by default) the device returns the 16-base superset range and the
    # host narrows it with two lo-word bisections per mask (hybrid).  The
    # port's match_batch answers every window or raises (it has no output
    # cap to overflow), so there is no host path for a declined batch.
    dev = None
    if idx.device_matcher is not None:
        p_dev = min(p, 16)
        dev = idx.device_matcher.match_batch(np.stack(window_vecs), p_dev)

    if dev is not None:
        suf = np.uint64((1 << (2 * (k - p))) - 1)
        scores: dict[int, int] = {}
        for rdr in idx.chunks:
            mb, me = rdr.mask_begin, rdr.mask_end
            for w, (hm, he0, hnh) in enumerate(dev):
                insel = (hm >= mb) & (hm < me)
                if not insel.any():
                    continue
                mi = hm[insel]
                qks = window_vecs[w][mi]
                base = np.asarray(rdr.mask_offsets)[mi - mb]
                seg_lo = base + he0[insel]
                seg_hi = seg_lo + hnh[insel]
                if p > 16:
                    seg_lo2 = searchsorted_segments(
                        rdr.kmers, seg_lo, seg_hi, qks & ~suf, "left"
                    )
                    seg_hi = searchsorted_segments(
                        rdr.kmers, seg_lo, seg_hi, qks | suf, "right"
                    )
                    seg_lo = seg_lo2
                eidx = _ranges_to_indices(seg_lo, seg_hi)
                qrow = np.repeat(
                    np.arange(mi.shape[0]), (seg_hi - seg_lo).astype(np.int64)
                )
                first_vals = np.asarray(
                    rdr.values[np.asarray(rdr.entry_offsets)[eidx]]
                )
                ok = (first_vals & np.uint64(1)) == np.uint64(0)
                eidx = eidx[ok]
                qrow = qrow[ok]
                if eidx.shape[0] == 0:
                    continue
                lcp = kmer_lcp(np.asarray(rdr.kmers[eidx]), qks[qrow], k)
                v0 = np.asarray(rdr.entry_offsets)[eidx]
                v1 = np.asarray(rdr.entry_offsets)[eidx + 1]
                vidx = _ranges_to_indices(v0, v1)
                per = (v1 - v0).astype(np.int64)
                vals = np.asarray(rdr.values[vidx])
                lcps = np.repeat(lcp, per)
                codes = (vals >> np.uint64(BITS_NONE_IDX)).astype(np.int64)
                for code, l in zip(codes, lcps):
                    code = int(code)
                    if idx.filter_by_taxid and not idx._genome_allowed(code):
                        continue
                    scores[code] = scores.get(code, 0) + int(l)
        return _screen_assemble(idx, scores, opt)

    # host path: range-search each (mask, kmer) with p = min_prefix; score
    # per genome = sum of matched prefix lengths over every posting
    per_mask: list[list[int]] = [[] for _ in range(ms.m)]
    for vec in window_vecs:
        for j in np.nonzero(vec)[0]:
            per_mask[j].append(int(vec[j]))
    suf = np.uint64((1 << (2 * (k - p))) - 1)
    scores = {}
    for rdr in idx.chunks:
        mask_ids = []
        qkmers = []
        for mi in range(rdr.mask_begin, rdr.mask_end):
            for kmv in per_mask[mi]:
                mask_ids.append(mi)
                qkmers.append(kmv)
        if not mask_ids:
            continue
        mask_ids = np.array(mask_ids, dtype=np.int64)
        qkmers = np.array(qkmers, dtype=np.uint64)
        rel = mask_ids - rdr.mask_begin
        seg_lo = rdr.mask_offsets[rel]
        seg_hi = rdr.mask_offsets[rel + 1]
        e0 = searchsorted_segments(rdr.kmers, seg_lo, seg_hi, qkmers & ~suf, "left")
        e1 = searchsorted_segments(rdr.kmers, seg_lo, seg_hi, qkmers | suf, "right")
        counts = e1 - e0
        nz = counts > 0
        if not nz.any():
            continue
        eidx = _ranges_to_indices(e0[nz], e1[nz])
        qrow = np.repeat(np.nonzero(nz)[0], counts[nz])
        first_vals = np.asarray(rdr.values[np.asarray(rdr.entry_offsets)[eidx]])
        ok = (first_vals & np.uint64(1)) == 0  # prefix entries only
        eidx = eidx[ok]
        qrow = qrow[ok]
        if eidx.shape[0] == 0:
            continue
        lcp = kmer_lcp(np.asarray(rdr.kmers[eidx]), qkmers[qrow], k)
        v0 = np.asarray(rdr.entry_offsets)[eidx]
        v1 = np.asarray(rdr.entry_offsets)[eidx + 1]
        vidx = _ranges_to_indices(v0, v1)
        per = (v1 - v0).astype(np.int64)
        vals = np.asarray(rdr.values[vidx])
        lcps = np.repeat(lcp, per)
        codes = (vals >> np.uint64(BITS_NONE_IDX)).astype(np.int64)
        for code, l in zip(codes, lcps):
            code = int(code)
            if idx.filter_by_taxid and not idx._genome_allowed(code):
                continue
            scores[code] = scores.get(code, 0) + int(l)

    return _screen_assemble(idx, scores, opt)


def _screen_assemble(idx: IndexSearcher, scores: dict, opt: GSearchOptions):
    if not scores:
        return []

    # merge genome chunks (only chunks that actually had hits, like the
    # reference's BatchGenomeIndex accumulation)
    merged: dict[int, list] = {}
    for code, sc in scores.items():
        gi = idx.genome_chunk_group.get(code)
        key = code if gi is None else -1 - gi
        if key in merged:
            merged[key][0].append(code)
            merged[key][1] += sc
        else:
            merged[key] = [[code], sc]
    out = [(sorted(v[0]), v[1]) for v in merged.values()]
    out.sort(key=lambda t: -t[1])
    if opt.top_n > 0:
        out = out[: opt.top_n]
    return out


# --------------------------------------------------------------------------
# fragment alignment


def seqs2fragments(seqs: list[np.ndarray], frag_len: int, min_frag_len: int):
    """(ref: seqs2fragments, search-genome-util.go:276-305)"""
    frags = []
    total = 0
    for contig in seqs:
        end = contig.shape[0]
        for s in range(0, end, frag_len):
            e = min(s + frag_len, end)
            if e == end and e - s < min_frag_len:
                continue
            frags.append(contig[s:e])
            total += e - s
    return frags, total


def sample_fragment_kmers(frag: np.ndarray, scale: int):
    """Forward-strand FracMinHash sampling of 13-mers
    (ref: sampleQueryFragment, genome3.go:251-306)."""
    k = GSA3_SAMPLED_K
    fwd, rc = kmers_fwd_rc(frag, k)
    if fwd.shape[0] == 0:
        return np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.int64)
    canon = np.minimum(fwd, rc)
    keep = (hash64(canon) & np.uint64(scale - 1)) == 0
    ccc, ggg, ttt = homopolymer_codes(k)[1:]
    keep &= (fwd != ccc) & (fwd != ggg) & (fwd != ttt)
    sel = np.nonzero(keep)[0]
    if sel.shape[0]:
        sel = sel[~is_low_complexity_dust(fwd[sel], k)]
    return fwd[sel], sel.astype(np.int64)


class SubjectSketch:
    """Sampled 13-mer map over the subject's forward+RC concatenation
    (ref: buildSubjectSketchSampledOptimized, genome3.go:103-233)."""

    def __init__(self, concat: np.ndarray, skip_excl: np.ndarray | None,
                 contig_bounds: list[tuple[int, int]], forward_len: int, rc_start: int,
                 scale: int):
        k = GSA3_SAMPLED_K
        self.seq_len = int(concat.shape[0])
        self.contig_bounds = contig_bounds
        fseq = concat[:forward_len]
        fwd, rc = kmers_fwd_rc(fseq, k)
        n = fwd.shape[0]
        keep = np.ones(n, dtype=bool)
        if skip_excl is not None:
            keep &= ~skip_excl[:n]
        canon = np.minimum(fwd, rc)
        keep &= (hash64(canon) & np.uint64(scale - 1)) == 0
        ccc, ggg, ttt = homopolymer_codes(k)[1:]
        keep &= (fwd != ccc) & (fwd != ggg) & (fwd != ttt)
        sel = np.nonzero(keep)[0]
        if sel.shape[0]:
            sel = sel[~is_low_complexity_dust(fwd[sel], k)]
        # store both forward positions and mirrored RC positions
        kmers = np.concatenate([fwd[sel], rc[sel]])
        pos = np.concatenate(
            [sel, rc_start + (forward_len - sel - k)]
        ).astype(np.int64)
        order = np.argsort(kmers, kind="stable")
        self.kmers = kmers[order]
        self.pos = pos[order]

    def lookup(self, qkmers: np.ndarray):
        lo = np.searchsorted(self.kmers, qkmers, side="left")
        hi = np.searchsorted(self.kmers, qkmers, side="right")
        return lo, hi


def _align_fragment(
    qfrag: np.ndarray,
    qk: np.ndarray,
    qp: np.ndarray,
    sketch: SubjectSketch,
    concat: np.ndarray,
    cpr_opt: SeqComparatorOptions,
    c2opt: Chaining2Options,
    opt: GSearchOptions,
    total_bases: int,
    top_chains: int,
    want_pos: bool = False,
):
    """(ref: alignQueryFragToSubjectSampled + alignChain, genome3.go:316-609)"""
    K = GSA3_SAMPLED_K
    if qk.shape[0] == 0:
        return None
    lo, hi = sketch.lookup(qk)
    counts = np.minimum(hi - lo, 100)  # maxMatchesPerKmer
    nz = counts > 0
    if not nz.any():
        return None
    idxs = _ranges_to_indices(lo[nz], (lo + counts)[nz])
    qpos = np.repeat(qp[nz], counts[nz])
    spos = sketch.pos[idxs]
    n = qpos.shape[0]
    anchors = Anchors(
        qpos, spos, np.full(n, K, dtype=np.int32),
        np.zeros(n, bool), np.zeros(n, bool),
    )
    anchors = clear_substr_pairs(anchors, K)
    anchors = trim_substr_pairs(anchors, K, 100.0)
    if len(anchors) == 0:
        return None
    chains, *_ = chain2(anchors, c2opt)
    if not chains:
        return None

    cpr = SeqComparator(cpr_opt)
    cpr.index(qfrag)
    q_len = qfrag.shape[0]
    ext_len = opt.frag_size // 2
    best = None
    for ci, c in enumerate(chains):
        if top_chains > 0 and ci >= top_chains:
            break
        r = _align_chain(
            qfrag, concat, c, sketch, cpr, ext_len, opt, total_bases, q_len
        )
        if r is None:
            continue
        matched, aligned, gaps, pident = r
        score = matched * aligned
        if best is None or score > best[0]:
            best = (score, matched, aligned, gaps, pident, c.tbegin)
    if best is None:
        return None
    return best[1:] if want_pos else best[1:5]


def ortho_ani_compare(query: GQuery, subject: GQuery, opt: GSearchOptions):
    """OrthoANI-style comparison: fragment BOTH genomes, align each side's
    fragments against the other genome, and average pident over reciprocal
    best fragment pairs (ref: GSearchAlignOrthoANI, lib-index-search-genome
    .go:538 / genome3.go:1183; simplified reciprocal-best formulation).

    Returns (ani_fraction, af_q, af_s, n_pairs)."""

    def one_side(qg: GQuery, sg: GQuery):
        """Align qg fragments to sg; returns {frag_idx: (pident, s_frag_idx,
        aligned)} using the best chain's subject position."""
        qfrags, qtotal = seqs2fragments(qg.seqs, opt.frag_size, opt.min_frag_size)
        out = {}
        if not qfrags:
            return out, qtotal
        concat, skip_excl, bounds, fwd_len, rc_start = _build_subject_concat(
            sg.seqs, opt.frag_size
        )
        sketch = SubjectSketch(
            concat, skip_excl, bounds, fwd_len, rc_start, opt.kmer_scale
        )
        cpr_opt = opt.seqcompare_options()
        c2opt = opt.chaining2_options()
        for i, frag in enumerate(qfrags):
            qk, qp = sample_fragment_kmers(frag, opt.kmer_scale)
            r = _align_fragment(
                frag, qk, qp, sketch, concat, cpr_opt, c2opt, opt,
                sg.genome_size, opt.top_n_chains, want_pos=True,
            )
            if r is None:
                continue
            matched, aligned, gaps, pident, tpos = r
            # map subject position to a forward-strand fragment index
            if tpos >= rc_start:
                tpos = fwd_len - 1 - (tpos - rc_start)
            # subtract preceding contig intervals to approximate the
            # original coordinate, then bucket by fragment size
            sfrag = int(tpos // opt.frag_size)
            out[i] = (pident, sfrag, aligned - gaps)
        return out, qtotal

    fwd_map, qtotal = one_side(query, subject)
    rev_map, stotal = one_side(subject, query)
    pidents = []
    aligned_q = 0
    aligned_s = 0
    for qi, (pid1, sj, al1) in fwd_map.items():
        back = rev_map.get(sj)
        if back is None:
            continue
        pid2, qj, al2 = back
        if qj == qi:  # reciprocal best
            pidents.append((pid1 + pid2) / 2)
            aligned_q += al1
            aligned_s += al2
    ani = sum(pidents) / len(pidents) / 100 if pidents else 0.0
    af_q = min(aligned_q / qtotal, 1.0) if qtotal else 0.0
    af_s = min(aligned_s / stotal, 1.0) if stotal else 0.0
    return ani, af_q, af_s, len(pidents)


def _align_chain(qfrag, concat, c, sketch, cpr, ext_len, opt, total_bases, q_len):
    """(ref: alignChain, genome3.go:482-609)"""
    if c.qend < c.qbegin or c.tend < c.tbegin:
        return None
    subject_len = sketch.seq_len
    contig_start, contig_end = 0, subject_len
    for b0, b1 in sketch.contig_bounds:
        if b0 <= c.tbegin < b1:
            contig_start, contig_end = b0, b1
            break
    else:
        # maybe in the RC half: mirrored bounds
        for b0, b1 in sketch.contig_bounds:
            cs = subject_len - b1
            ce = subject_len - b0
            if cs <= c.tbegin < ce:
                contig_start, contig_end = cs, ce
                break

    t_begin = max(c.tbegin - ext_len, contig_start)
    t_end = min(c.tend + ext_len, contig_end - 1)
    tsub = concat[t_begin : t_end + 1]
    q_b = max(c.qbegin - ext_len, 0)
    q_e = min(c.qend + ext_len, q_len - 1)

    cr = cpr.compare(q_b, q_e, tsub, q_len)
    if cr is None:
        return None

    tot_matched = tot_aligned = tot_gaps = 0
    trials = 0
    for cc in cr.chains:
        if cc.qend < cc.qbegin or cc.tend < cc.tbegin:
            continue
        trials += 1
        if trials > 2:
            break
        max_ext = tsub.shape[0] - 1 - cc.tend
        qs, ts, *_ = extend_match(
            qfrag, tsub, cc.qbegin, cc.qend + 1, cc.tbegin, cc.tend + 1,
            opt.extend_length2, cc.tbegin, max_ext, False,
        )
        cigar = wfa_align(qs, ts)
        if cigar is None:
            continue
        _s, _b, evalue = score_and_evalue(cigar.trimmed_ops(), len(qs), total_bases)
        if evalue > opt.max_evalue:
            continue
        tot_matched += cigar.matches
        tot_aligned += cigar.align_len
        tot_gaps += cigar.gaps
        break  # keep the best ONE match

    if tot_aligned <= 0:
        return None
    pident = tot_matched / tot_aligned * 100
    aligned_q = tot_aligned - tot_gaps
    af = min(aligned_q / q_len * 100, 100.0)
    if pident < opt.min_identity or af < opt.min_qcov_frag:
        return None
    return tot_matched, tot_aligned, tot_gaps, pident


def _build_subject_concat(contigs: list[np.ndarray], frag_len: int):
    """Forward contigs joined by N-intervals + RC half
    (ref: genome3.go:806-861).  Returns (concat, skip_excl, bounds,
    forward_len, rc_start)."""
    K = GSA3_SAMPLED_K
    interval = max(int(frag_len * 1.5), K)
    parts = []
    bounds = []
    regions = []
    pos = 0
    for i, ctg in enumerate(contigs):
        if i > 0:
            regions.append((pos, pos + interval - 1))
            parts.append(np.zeros(interval, dtype=np.uint8))  # N -> A codes
            pos += interval
        bounds.append((pos, pos + ctg.shape[0]))
        parts.append(ctg)
        pos += ctg.shape[0]
    fwd = np.concatenate(parts) if parts else np.empty(0, dtype=np.uint8)
    forward_len = fwd.shape[0]
    rc_interval = frag_len * 2
    rc = (np.uint8(3) - fwd)[::-1]
    concat = np.concatenate([fwd, np.zeros(rc_interval, dtype=np.uint8), rc])
    rc_start = forward_len + rc_interval
    skip_excl = (
        skip_mask_from_regions(forward_len, K, regions) if regions else None
    )
    return concat, skip_excl, bounds, forward_len, rc_start


def gsearch_align(
    idx: IndexSearcher,
    q: GQuery,
    groups: list[tuple[list[int], int]],
    opt: GSearchOptions,
) -> list[GSearchResult]:
    """Fragment the query and align against each candidate genome
    (ref: GSearchAlign3Sampled)."""
    qfrags, qfrag_total = seqs2fragments(q.seqs, opt.frag_size, opt.min_frag_size)
    if not qfrags:
        return []
    sampled = [sample_fragment_kmers(f, opt.kmer_scale) for f in qfrags]

    cpr_opt = opt.seqcompare_options()
    c2opt = opt.chaining2_options()

    import os as _os
    from concurrent.futures import ThreadPoolExecutor

    n_workers = min(4, _os.cpu_count() or 1)
    if n_workers > 1 and len(groups) > 1:
        # candidate genomes align in threads (native kernels release the GIL;
        # the reference's per-subject goroutines, ref: genome3.go:749-937)
        with ThreadPoolExecutor(max_workers=n_workers) as ex:
            futs = [
                ex.submit(
                    _align_one_group, idx, qfrags, sampled, qfrag_total,
                    codes, screen_score, cpr_opt, c2opt, opt,
                )
                for codes, screen_score in groups
            ]
            results = [r for f in futs if (r := f.result()) is not None]
        results.sort(key=lambda r: (-r.ani, -r.af_q, -r.af_s, r.batch_genome_index))
        return results

    results = []
    for codes, screen_score in groups:
        r = _align_one_group(
            idx, qfrags, sampled, qfrag_total, codes, screen_score,
            cpr_opt, c2opt, opt,
        )
        if r is not None:
            results.append(r)
    results.sort(key=lambda r: (-r.ani, -r.af_q, -r.af_s, r.batch_genome_index))
    return results


def _align_one_group(idx, qfrags, sampled, qfrag_total, codes, screen_score,
                     cpr_opt, c2opt, opt):
    # read subject contigs (possibly multiple genome chunks)
    contigs: list[np.ndarray] = []
    genome_size = 0
    num_seqs = 0
    for code in codes:
        b = code >> BITS_GENOME_IDX
        gi = code & MASK_GENOME_IDX
        st = idx.genome_stores[b]
        sizes = st.seq_sizes(gi)
        pos = 0
        for s in sizes:
            contigs.append(st.subseq_codes(gi, pos, pos + s - 1))
            pos += s + idx.contig_interval
        genome_size += int(st.gsizes[gi])
        num_seqs += len(sizes)
    if (
        opt.max_subject_genome_size > 0
        and genome_size > opt.max_subject_genome_size
    ):
        return None

    concat, skip_excl, bounds, fwd_len, rc_start = _build_subject_concat(
        contigs, opt.frag_size
    )
    sketch = SubjectSketch(concat, skip_excl, bounds, fwd_len, rc_start, opt.kmer_scale)

    gr = GSearchResult(
        batch_genome_index=codes[0],
        genome_id=idx.id_of_code.get(codes[0], b"?"),
        genome_size=genome_size,
        num_seqs=num_seqs,
        screen_score=screen_score,
    )
    pidents = []
    for frag, (qk, qp) in zip(qfrags, sampled):
        r = _align_fragment(
            frag, qk, qp, sketch, concat, cpr_opt, c2opt, opt,
            genome_size, opt.top_n_chains,
        )
        if r is None:
            continue
        matched, aligned, gaps, pident = r
        gr.aligned_fragments += 1
        gr.aligned_length += aligned - gaps
        gr.aligned_matches += matched
        pidents.append(pident)
    if pidents:
        gr.ani = sum(pidents) / len(pidents) / 100
    gr.af_q = min(gr.aligned_length / qfrag_total, 1.0) if qfrag_total else 0.0
    gr.af_s = min(gr.aligned_length / genome_size, 1.0) if genome_size else 0.0
    if gr.af_q * 100 >= opt.min_af:
        return gr
    return None


def compare_two_genomes(
    query: GQuery, subject: GQuery, opt: GSearchOptions
) -> GSearchResult:
    """Direct genome-vs-genome ANI/AF (ref: CompareTwoGenomes,
    genome3.go:956-1120)."""
    qfrags, qfrag_total = seqs2fragments(query.seqs, opt.frag_size, opt.min_frag_size)
    gr = GSearchResult(
        batch_genome_index=-1,
        genome_id=subject.id,
        genome_size=subject.genome_size,
        num_seqs=len(subject.seqs),
    )
    if not qfrags:
        return gr
    sampled = [sample_fragment_kmers(f, opt.kmer_scale) for f in qfrags]
    concat, skip_excl, bounds, fwd_len, rc_start = _build_subject_concat(
        subject.seqs, opt.frag_size
    )
    sketch = SubjectSketch(concat, skip_excl, bounds, fwd_len, rc_start, opt.kmer_scale)
    cpr_opt = opt.seqcompare_options()
    c2opt = opt.chaining2_options()
    pidents = []
    for frag, (qk, qp) in zip(qfrags, sampled):
        r = _align_fragment(
            frag, qk, qp, sketch, concat, cpr_opt, c2opt, opt,
            subject.genome_size, opt.top_n_chains,
        )
        if r is None:
            continue
        matched, aligned, gaps, pident = r
        gr.aligned_fragments += 1
        gr.aligned_length += aligned - gaps
        gr.aligned_matches += matched
        pidents.append(pident)
    if pidents:
        gr.ani = sum(pidents) / len(pidents) / 100
    gr.af_q = min(gr.aligned_length / qfrag_total, 1.0) if qfrag_total else 0.0
    gr.af_s = (
        min(gr.aligned_length / subject.genome_size, 1.0) if subject.genome_size else 0.0
    )
    return gr


# --------------------------------------------------------------------------
# shared-k-mer statistics

# standard-normal quantiles (ref: search-genome-util.go:310-316)
Z_QUANTILE_95 = 1.645
Z_QUANTILE_975 = 1.96
Z_QUANTILE_99 = 2.33


def min_shared_kmers_threshold(
    L: int, k: int, scaled: int, ani: float, z: float = Z_QUANTILE_95
) -> int:
    """Recommended MinSharedKmers cutoff under the Mash/sourmash model
    (iid mutations, sketched shared-count ~ Poisson(mu)):
        mu = (L - k + 1) * ani^k / scaled;  T = floor(mu - z*sqrt(mu))
    clamped to [1, 65535] (ref: MinSharedKmersThreshold,
    search-genome-util.go:318-389)."""
    import math

    if scaled == 0:
        scaled = 1
    mu = (L - k + 1) * (ani**k) / scaled
    t = math.floor(mu - z * math.sqrt(mu))
    return max(1, min(t, 0xFFFF))


# --------------------------------------------------------------------------
# genome pair (ref: pair.go)


def should_keep_pair(
    n: int, k_matches: int, t: float, S: int, prob_threshold: float
) -> bool:
    """Binomial-probability pruning check (ref: pair.go:730-789, the
    Agievich bound approximation from the Onika paper).

    n: masks processed so far; k_matches: matches observed; t: minimum
    mask fraction; S: total masks; returns True if P(reach t*S) is above
    prob_threshold."""
    import math

    required = int(t * S)
    if k_matches >= required:
        return True
    remaining = S - n
    if k_matches + remaining < required:
        return False
    fn = float(n)
    fk = float(k_matches)
    p = t
    if n > 0:
        observed = fk / fn
        if observed > p:
            p = observed
    p = max(1e-12, min(1.0 - 1e-12, p))
    q = 1.0 - p
    diff = fk - 0.5 * fn
    log_coeff = (
        fn * math.log(2.0)
        - 0.5 * math.log(math.pi * fn / 2.0)
        - 2.0 * diff * diff / fn
        + 23.0 / (18.0 * fn)
    )
    log_mass = log_coeff + fk * math.log(p) + (fn - fk) * math.log(q)
    if log_mass > 0.0:
        return True
    return log_mass >= math.log(prob_threshold)


def genome_pairs(
    idx: IndexSearcher,
    min_prefix: int = 21,
    min_mask_fraction: float = 0.25,
    prob_threshold: float = 0.001,
    n_masks: int = 1024,
):
    """Find similar genome pairs (ref: pair.go).

    Per mask (a subset of n_masks masks by default — the first mask of each
    log4(n_masks)-bp prefix, ref: pair.go:162-179), genomes whose captured
    k-mers share >= min_prefix bases are counted as a pair match, keeping
    the maximum shared-prefix length per pair per mask (ref:
    processKmerWithWindow, pair.go:817-933; reversed/suffix seed copies are
    skipped).  Pairs are pruned early with the binomial-probability check
    (should_keep_pair, every 8 masks) and kept when they match at least
    min_mask_fraction of the processed masks.  Masks are processed in
    ascending index order (the reference's goroutine merge order is
    nondeterministic; the final counts are identical, only which pairs are
    transiently pruned can differ at the margin).

    Returns [(genome1_code, genome2_code, n_masks_matched, sum_prefix)]
    sorted by (n_masks_matched, sum_prefix) descending."""
    k = idx.k
    m = idx.mask_set.m
    if n_masks and n_masks > 0:
        import math as _math

        mp = int(_math.log2(n_masks) / 2)
        prefs = idx.mask_set.masks >> np.uint64(2 * (k - mp))
        chosen_sel = np.ones(m, dtype=bool)
        chosen_sel[1:] = prefs[1:] != prefs[:-1]  # first mask per prefix
        chosen = set(np.nonzero(chosen_sel)[0].tolist())
        total_masks = len(chosen)
    else:
        chosen = None
        total_masks = m
    required = int(min_mask_fraction * total_masks)

    shift = np.uint64(2 * (k - min_prefix))
    active: dict[tuple[int, int], int] = {}
    gsum: dict[tuple[int, int], int] = {}
    processed = 0
    for rdr in idx.chunks:
        entry_kmers = np.asarray(rdr.kmers)
        entry_off = np.asarray(rdr.entry_offsets)
        values = np.asarray(rdr.values)
        mask_off = np.asarray(rdr.mask_offsets)
        for mi in range(rdr.mask_end - rdr.mask_begin):
            if chosen is not None and (rdr.mask_begin + mi) not in chosen:
                continue
            processed += 1
            e0, e1 = int(mask_off[mi]), int(mask_off[mi + 1])
            per_mask: dict[tuple[int, int], int] = {}
            if e1 - e0 > 0:
                kk = entry_kmers[e0:e1]
                # per-entry genome lists from FORWARD values only
                # (ref: pair.go:566-568 skips reverse-complement copies)
                glists = []
                for be in range(e0, e1):
                    vv = values[entry_off[be] : entry_off[be + 1]]
                    fwd = (vv & np.uint64(1)) == 0
                    g = (vv[fwd] >> np.uint64(BITS_NONE_IDX)).astype(np.int64)
                    glists.append(np.unique(g))
                # same-kmer pairs: prefix = k (ref: pair.go:884-914)
                for g in glists:
                    for i in range(g.shape[0]):
                        for j in range(i + 1, g.shape[0]):
                            key = (int(g[i]), int(g[j]))
                            if per_mask.get(key, 0) < k:
                                per_mask[key] = k
                # cross-kmer pairs: bucket by min_prefix-prefix (equivalent
                # to the reference's LCP >= minPrefix window)
                prefs_ = kk >> shift
                bounds = np.nonzero(prefs_[1:] != prefs_[:-1])[0] + 1
                starts = np.concatenate([[0], bounds])
                ends = np.concatenate([bounds, [kk.shape[0]]])
                for s, e in zip(starts, ends):
                    if e - s < 2:
                        continue
                    for i in range(s, e):
                        if glists[i].shape[0] == 0:
                            continue
                        for j in range(i + 1, e):
                            if glists[j].shape[0] == 0:
                                continue
                            l = int(
                                kmer_lcp(
                                    np.array([kk[i]], dtype=np.uint64),
                                    np.array([kk[j]], dtype=np.uint64),
                                    k,
                                )[0]
                            )
                            for g1 in glists[i]:
                                for g2 in glists[j]:
                                    if g1 == g2:
                                        continue
                                    key = (
                                        (int(g1), int(g2))
                                        if g1 < g2
                                        else (int(g2), int(g1))
                                    )
                                    if per_mask.get(key, 0) < l:
                                        per_mask[key] = l
            # merge into global counts with probabilistic pruning
            # (ref: pair.go:283-330)
            if prob_threshold <= 0:
                for key, l in per_mask.items():
                    active[key] = active.get(key, 0) + 1
                    gsum[key] = gsum.get(key, 0) + l
            else:
                add_new = False
                if 1 + (total_masks - processed) >= required:
                    add_new = should_keep_pair(
                        processed, 1, min_mask_fraction, total_masks, prob_threshold
                    )
                for key, l in per_mask.items():
                    if key in active:
                        active[key] += 1
                        gsum[key] += l
                    elif add_new:
                        active[key] = 1
                        gsum[key] = gsum.get(key, 0) + l
                if processed < total_masks and processed & 7 == 0:
                    for key in [
                        key
                        for key, matches in active.items()
                        if matches > 1
                        and not should_keep_pair(
                            processed,
                            matches,
                            min_mask_fraction,
                            total_masks,
                            prob_threshold,
                        )
                    ]:
                        del active[key]
                        del gsum[key]

    out = []
    for key, n in active.items():
        if n >= required:
            out.append((key[0], key[1], n, gsum[key]))
    out.sort(key=lambda t: (-t[2], -t[3]))
    return out
