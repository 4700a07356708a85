"""Search engine: the 4-phase per-query pipeline.

Re-derivation of Index.Search (ref: lib-index-search.go:1154-2897):

  1) MASK     capture the query with the index masks (+ low-complexity filter)
  2) MATCH    prefix matching of captured k-mers against the sorted per-mask
              seed arrays, plus suffix matching via reversed k-mers dispatched
              to their nearest mask; decode postings into per-genome anchors
  3) CHAIN    ClearSubstrPairs + Chainer DP per candidate genome; keep top-N
  4) ALIGN    per chain: extract the extended target window, pseudo-align
              (SeqComparator+Chainer2), extend 2-mer boundaries, gap-affine
              global alignment, BLAST-like scoring, HSP filtering; then
              genome-chunk merging, qcovGnm, and output ordering

All per-mask operations are vectorized over sorted arrays (two binary
searches replace the reference's anchor-index + varint scan,
ref: cmd/kv/kv-searcher.go:263-611).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..utils.arrays import ranges_to_indices as _ranges_to_indices

from ..constants import (
    BITS_GENOME_IDX,
    BITS_IDX,
    BITS_IDX_FLAGS,
    BITS_NONE_IDX,
    MASK_GENOME_IDX,
    SearchDefaults,
)
from ..masks import MaskSet
from ..ops.align import align, alignment_text, score_and_evalue, score_to_bit_evalue
from ..ops.wfa import wfa_align
from ..ops.chaining import Anchors, ChainingOptions, chain, clear_substr_pairs, seed_weight
from ..ops.chaining2 import Chain2Result, Chaining2Options
from ..ops.extend import extend_match
from ..ops.masking import capture
from ..ops.seqcompare import SeqComparator, SeqComparatorOptions, coverage_len
from ..utils.kmers import (
    homopolymer_codes,
    is_low_complexity_dust,
    kmer_lcp,
    reverse_kmers,
    seq_to_codes,
)
from .store import (
    DIR_GENOMES,
    DIR_SEEDS,
    FILE_GENOME_CHUNKS,
    FILE_GENOME_MAP,
    FILE_INFO,
    FILE_MASKS,
    GenomeStoreReader,
    IndexInfo,
    SeedChunkReader,
    batch_dir,
    read_genome_chunks,
    read_genome_map,
)


@dataclass
class SearchOptions:
    """Mirror of IndexSearchingOptions + the SeqComparator wiring
    (ref: lib-index-search.go:56-105, search.go:306-383)."""

    min_prefix: int = SearchDefaults.MIN_PREFIX
    min_single_prefix: int = SearchDefaults.MIN_SINGLE_PREFIX
    top_n: int = SearchDefaults.TOP_N_GENOMES
    top_n_chains: int = SearchDefaults.TOP_N_CHAINS
    max_gap: float = SearchDefaults.SEED_MAX_GAP
    max_distance: float = SearchDefaults.SEED_MAX_DIST
    extend_length: int = SearchDefaults.ALIGN_EXT_LEN
    extend_length2: int = SearchDefaults.EXTEND_LENGTH2
    min_qcov_genome: float = SearchDefaults.MIN_QCOV_PER_GENOME
    min_qcov_hsp: float = SearchDefaults.MIN_QCOV_PER_HSP
    min_identity: float = SearchDefaults.ALIGN_MIN_MATCH_PIDENT
    min_align_len: int = SearchDefaults.ALIGN_MIN_MATCH_LEN
    align_max_gap: int = SearchDefaults.ALIGN_MAX_GAP
    align_band: int = SearchDefaults.ALIGN_BAND
    max_evalue: float = SearchDefaults.MAX_EVALUE
    in_memory: bool = False
    output_seq: bool = False  # -a/--all
    engine: str = "host"  # "host" | "device" (CUDA seed-locate kernel)
    device: str | None = None  # "cuda" (the default) | "cpu" (the kernel's plain twin)
    wfa_engine: str = "host"  # "host" | "device" (CUDA WFA of phase 5, on `device`)
    chain_engine: str = "host"  # "host" | "device" (CUDA chain1 DP of phase 3, on `device`)
    debug: bool = False  # per-phase timings to stderr (ref: --debug logs)

    # TaxId filtering (ref: lib-index-search.go:93-98, search.go:232-239)
    taxdump_dir: str | None = None
    genome2taxid_file: str | None = None
    taxids: list[int] = field(default_factory=list)
    negative_taxids: list[int] = field(default_factory=list)
    keep_genomes_without_taxid: bool = False

    def chaining_options(self) -> ChainingOptions:
        return ChainingOptions(
            max_gap=self.max_gap,
            min_score=float(seed_weight(self.min_single_prefix)),
            max_distance=self.max_distance,
            top_chains=self.top_n_chains,
        )

    def seqcompare_options(self) -> SeqComparatorOptions:
        # ref: search.go:361-383
        return SeqComparatorOptions(
            k=SearchDefaults.CMP_K,
            min_prefix=SearchDefaults.CMP_MIN_PREFIX,
            chaining=Chaining2Options(
                max_gap=self.align_max_gap,
                min_score=int(self.min_align_len * self.min_identity / 100),
                min_align_len=self.min_align_len,
                min_identity=self.min_identity,
                band_base=self.align_band,
                band_count=self.align_band // 2,
                heuristic_kmer_pident_threshold=(
                    SearchDefaults.HEURISTIC_KMER_PIDENT_THRESHOLD
                ),
            ),
            min_aligned_fraction=self.min_qcov_hsp,
            min_identity=self.min_identity,
        )


@dataclass
class SeqDetail:
    """Mirror of SimilarityDetail (ref: lib-index-search.go:1062-1083)."""

    rc: bool
    n_seeds: int
    similarity_score: float
    chains: list[Chain2Result]
    aligned_bases: int
    seq_id: bytes
    seq_idx: int
    n_seqs: int
    seq_len: int
    n_chunks: int = 1
    chunk_idx: int = 0


@dataclass
class GenomeHit:
    """Mirror of SearchResult (ref: lib-index-search.go:986-1003)."""

    batch_genome_index: int
    genome_batch: int
    genome_index: int
    genome_id: bytes = b""
    genome_size: int = 0
    num_seqs: int = 0
    score: float = 0.0
    details: list[SeqDetail] = field(default_factory=list)
    aligned_fraction: float = 0.0  # qcovGnm


def searchsorted_segments(vals, lo0, hi0, queries, side="left"):
    """Vectorized binary search of queries[i] within vals[lo0[i]:hi0[i]]."""
    lo = lo0.astype(np.int64).copy()
    hi = hi0.astype(np.int64).copy()
    q = queries
    while True:
        active = lo < hi
        if not active.any():
            break
        mid = (lo + hi) >> 1
        v = vals[np.where(active, mid, 0)]
        if side == "left":
            right = v < q
        else:
            right = v <= q
        lo = np.where(active & right, mid + 1, lo)
        hi = np.where(active & ~right, mid, hi)
    return lo


class IndexSearcher:
    def __init__(self, db_dir: str, opt: SearchOptions | None = None):
        self.path = db_dir
        self.opt = opt or SearchOptions()
        self.info = IndexInfo.load(os.path.join(db_dir, FILE_INFO))
        self.mask_set = MaskSet.load(os.path.join(db_dir, FILE_MASKS))
        self.k = self.mask_set.k
        self.total_bases = self.info.input_bases
        self.contig_interval = self.info.contig_interval

        self.chunks: list[SeedChunkReader] = []
        seeds_dir = os.path.join(db_dir, DIR_SEEDS)
        for name in sorted(os.listdir(seeds_dir)):
            rdr = SeedChunkReader(os.path.join(seeds_dir, name), mmap=not self.opt.in_memory)
            if self.opt.in_memory:
                rdr.load_in_memory()
            self.chunks.append(rdr)

        self.genome_stores: list[GenomeStoreReader] = []
        genomes_dir = os.path.join(db_dir, DIR_GENOMES)
        for b in range(self.info.genome_batches):
            self.genome_stores.append(GenomeStoreReader(os.path.join(genomes_dir, batch_dir(b))))

        self.id_of_code: dict[int, bytes] = {}
        for gid, code in read_genome_map(os.path.join(db_dir, FILE_GENOME_MAP)):
            self.id_of_code[code] = gid

        self.genome_chunks = read_genome_chunks(os.path.join(db_dir, FILE_GENOME_CHUNKS))
        self.genome_chunk_idx: dict[int, tuple[int, int]] = {}
        self.genome_chunk_group: dict[int, int] = {}
        for gi, lst in enumerate(self.genome_chunks):
            for ci, code in enumerate(lst):
                self.genome_chunk_idx[code] = (len(lst), ci)
                self.genome_chunk_group[code] = gi

        self._ccc, self._ggg, self._ttt = homopolymer_codes(self.k)[1:]

        # optional batched device WFA (bit-exact with the host aligner;
        # ref: the per-HSP wfa.Align at lib-index-search.go:2218)
        self.device_wfa = None
        if self.opt.wfa_engine == "device":
            from ..parallel.wfa_device import DeviceWFA

            self.device_wfa = DeviceWFA(device=self.opt.device)

        # optional batched device chainer (bit-exact forward DP with host
        # backtracking; ref: Chainer.Chain, lib-chaining.go:122-633); only
        # the device engine's batches chain through it (the mesh engine
        # makes one on its mesh's device)
        self.device_chainer = None
        if self.opt.chain_engine == "device" and self.opt.engine == "device":
            self.device_chainer = self.make_device_chainer(self.opt.device)

        # optional device seed matcher (device-resident packed index)
        self.device_matcher = None
        if self.opt.engine == "device":
            from ..parallel.device_search import DeviceSeedMatcher

            self.device_matcher = DeviceSeedMatcher(self, device=self.opt.device)
            if self.opt.debug:
                import sys as _sys

                print(self.device_matcher.describe(), file=_sys.stderr)

        # TaxId filtering (ref: lib-index-search.go:316-416)
        self.filter_by_taxid = bool(self.opt.taxids or self.opt.negative_taxids)
        self.taxonomy = None
        self.code2taxid: dict[int, int] = {}
        self._taxid_verdict: dict[int, bool] = {}
        if self.filter_by_taxid:
            from ..utils.taxonomy import Taxonomy, read_genome2taxid

            if not (self.opt.taxdump_dir and self.opt.genome2taxid_file):
                raise ValueError(
                    "taxdump dir and genome2taxid file are required for TaxId filtering"
                )
            self.taxonomy = Taxonomy.from_taxdump(self.opt.taxdump_dir)
            g2t = read_genome2taxid(self.opt.genome2taxid_file)
            for code, gid in self.id_of_code.items():
                t = g2t.get(gid.decode())
                if t is not None:
                    self.code2taxid[code] = t

    def _genome_allowed(self, code: int) -> bool:
        """Per-genome TaxId verdict with memoization
        (ref: lib-index-search.go:1399-1448)."""
        v = self._taxid_verdict.get(code)
        if v is not None:
            return v
        taxid = self.code2taxid.get(code)
        keep = True
        if taxid is None:
            keep = self.opt.keep_genomes_without_taxid
        else:
            if self.opt.negative_taxids and any(
                self.taxonomy.is_descendant_or_self(taxid, t)
                for t in self.opt.negative_taxids
            ):
                keep = False
            elif self.opt.taxids:
                keep = any(
                    self.taxonomy.is_descendant_or_self(taxid, t)
                    for t in self.opt.taxids
                )
        self._taxid_verdict[code] = keep
        return keep

    # ------------------------------------------------------------------
    # phase 1+2: masking + seed matching

    def _mask_query(self, qcodes: np.ndarray):
        from ..native import capture_native_call
        from ..ops.masking import CaptureResult
        from ..utils.kmers import kmers_fwd_rc as _kfr

        fwd, rc = _kfr(qcodes, self.k)
        # checkShorterPrefix=true (ref: lib-index-search.go:1175): the query
        # capture keeps sub-distinct-prefix winners — suffix matching can pair
        # a low-LCP query k-mer with a stored reversed seed.
        native = capture_native_call(
            fwd, rc, None, self.mask_set.masks, self.k,
            self.mask_set.prefix_len, True,
        )
        if native is not None:
            kmers_out, counts, pos_flat = native
            offsets = np.zeros(self.mask_set.m + 1, dtype=np.int64)
            np.cumsum(counts, out=offsets[1:])
            res = CaptureResult(kmers=kmers_out, pos_flat=pos_flat, pos_offsets=offsets)
        else:
            res = capture(
                self.mask_set, qcodes, None, check_shorter_prefix=True,
                precomputed=(fwd, rc),
            )
        kmers = res.kmers.copy()
        bad = (
            (kmers == self._ccc)
            | (kmers == self._ggg)
            | (kmers == self._ttt)
            | is_low_complexity_dust(kmers, self.k)
        )
        kmers[bad] = 0  # positions kept, like the reference
        return kmers, res

    def _reversed_query_kmers(self, kmers: np.ndarray):
        """Dispatch reversed captured k-mers to their nearest mask
        (ref: lib-index-search.go:1229-1309).  Returns (new_mask, rev_kmer,
        orig_mask) arrays, deduplicated per (new_mask, rev_kmer) keeping the
        lowest original mask."""
        sel = np.nonzero(kmers != 0)[0]
        if sel.shape[0] == 0:
            e = np.empty(0, dtype=np.int64)
            return e, np.empty(0, dtype=np.uint64), e
        rev = reverse_kmers(kmers[sel], self.k)
        newm = self.mask_set.nearest_mask(rev)
        order = np.lexsort((sel, rev, newm))
        nm = newm[order]
        rv = rev[order]
        om = sel[order]
        first = np.ones(nm.shape[0], dtype=bool)
        first[1:] = (nm[1:] != nm[:-1]) | (rv[1:] != rv[:-1])
        return nm[first], rv[first], om[first]

    def _match_chunk(self, rdr: SeedChunkReader, mask_ids, qkmers, want_rev: bool):
        """Range-match query k-mers against one chunk's entries.

        mask_ids: absolute mask index per query k-mer (within chunk range)
        Returns (hit_entry_idx, hit_query_row, lcp) arrays."""
        p = self.opt.min_prefix
        k = self.k
        suf = np.uint64((1 << (2 * (k - p))) - 1)
        rel = mask_ids - rdr.mask_begin
        seg_lo = rdr.mask_offsets[rel]
        seg_hi = rdr.mask_offsets[rel + 1]
        lb = qkmers & ~suf
        rb = qkmers | suf
        entry_kmers = rdr.kmers

        from ..native import range_match_native

        native = range_match_native(
            entry_kmers, rdr.entry_offsets, rdr.values, seg_lo, seg_hi,
            lb, rb, qkmers, k, want_rev,
        )
        if native is not None:
            return native

        e0 = searchsorted_segments(entry_kmers, seg_lo, seg_hi, lb, side="left")
        e1 = searchsorted_segments(entry_kmers, seg_lo, seg_hi, rb, side="right")
        counts = e1 - e0
        nz = counts > 0
        if not nz.any():
            e = np.empty(0, dtype=np.int64)
            return e, e, e
        idx = _ranges_to_indices(e0[nz], e1[nz])
        qrow = np.repeat(np.nonzero(nz)[0], counts[nz])
        # entry-level flag check: the FIRST posting's reverse flag must match
        # (ref: kv-searcher.go:447-469)
        first_vals = rdr.values[rdr.entry_offsets[idx]]
        flag_ok = (first_vals & np.uint64(1)) == np.uint64(1 if want_rev else 0)
        idx = idx[flag_ok]
        qrow = qrow[flag_ok]
        if idx.shape[0] == 0:
            e = np.empty(0, dtype=np.int64)
            return e, e, e
        lcp = kmer_lcp(np.asarray(entry_kmers[idx]), qkmers[qrow], k)
        return idx, qrow, lcp

    def _collect_anchors(
        self,
        qcodes: np.ndarray,
        genome_codes: set[int] | None = None,
        premasked=None,
        dev_hits_pre=None,
    ):
        """Phases 1+2; returns dict refBatchAndIdx -> Anchors.

        genome_codes: optional white list of batch<<17|idx codes
        (the reference's genomeIds param, used by genome screening).
        premasked / dev_hits_pre: results of _mask_query / a batched device
        match computed up front by search_many (amortizes device dispatch)."""
        k = self.k
        kmers, capres = premasked if premasked is not None else self._mask_query(qcodes)
        rnew, rkmers, rorig = self._reversed_query_kmers(kmers)

        from ..native import get_lib

        # phase 2b fast path: postings gather + decode + genome grouping in
        # ONE native call (collect_anchors, core.cpp) — the numpy tail below
        # is the reference semantics and handles the filtered cases
        use_native = (
            get_lib() is not None
            and not self.filter_by_taxid
            and genome_codes is None
            and not os.environ.get("LEXICMAP_TPU_NO_BATCH")
        )
        rec_chunk: list = []  # per matched entry: chunk idx, entry idx, lcp, mask
        rec_eidx: list = []
        rec_lcp: list = []
        rec_qmask: list = []

        all_vals = []
        all_lcp = []
        all_qloc_entry = []  # per-hit: index of the orig mask (for query locs)
        all_rev = []

        # device prefix matching: one kernel launch for all masks.
        # dev_hits_pre=None means "not matched yet" (issue a device match
        # here, or use host bisection when there is no device matcher).
        dev_hits = dev_hits_pre
        if (
            dev_hits is None
            and self.device_matcher is not None
            and self.opt.min_prefix <= 16
        ):
            dev_hits = self.device_matcher.match(kmers, self.opt.min_prefix)

        for ci, rdr in enumerate(self.chunks):
            # ---- prefix search ----
            mb, me = rdr.mask_begin, rdr.mask_end
            if dev_hits is not None:
                # device path: the kernel already located every mask's
                # [e0, e0+n) entry range; apply the same entry-level
                # reverse-flag filter + LCP as the host path
                hm, he0, hnh = dev_hits
                insel = (hm >= mb) & (hm < me)
                mi = hm[insel]
                qks = kmers[mi]
                base = np.asarray(rdr.mask_offsets)[mi - mb]
                eidx = _ranges_to_indices(base + he0[insel], base + he0[insel] + hnh[insel])
                qrow = np.repeat(np.arange(mi.shape[0]), hnh[insel])
                first_vals = np.asarray(rdr.values[np.asarray(rdr.entry_offsets)[eidx]])
                ok = (first_vals & np.uint64(1)) == np.uint64(0)
                eidx = eidx[ok]
                qrow = qrow[ok]
                lcp = (
                    kmer_lcp(np.asarray(rdr.kmers[eidx]), qks[qrow], self.k)
                    if eidx.shape[0]
                    else np.empty(0, dtype=np.int64)
                )
            else:
                mask_ids = np.arange(mb, me)
                qk = kmers[mb:me]
                sel = qk != 0
                if sel.any():
                    mi = mask_ids[sel]
                    qks = qk[sel]
                    eidx, qrow, lcp = self._match_chunk(rdr, mi, qks, want_rev=False)
                else:
                    eidx = np.empty(0, dtype=np.int64)
                    mi = qrow = lcp = eidx
            if eidx.shape[0]:
                if use_native:
                    rec_chunk.append(np.full(eidx.shape[0], ci, dtype=np.int32))
                    rec_eidx.append(np.asarray(eidx, dtype=np.int64))
                    rec_lcp.append(np.asarray(lcp, dtype=np.int64))
                    rec_qmask.append(np.asarray(mi[qrow], dtype=np.int64))
                else:
                    v_idx = _ranges_to_indices(
                        np.asarray(rdr.entry_offsets[eidx]),
                        np.asarray(rdr.entry_offsets[eidx + 1]),
                    )
                    per = np.asarray(rdr.entry_offsets[eidx + 1]) - np.asarray(
                        rdr.entry_offsets[eidx]
                    )
                    all_vals.append(np.asarray(rdr.values[v_idx]))
                    all_lcp.append(np.repeat(lcp, per))
                    all_qloc_entry.append(np.repeat(mi[qrow], per))
                    all_rev.append(np.zeros(int(per.sum()), dtype=bool))

            # ---- suffix search (reversed k-mers assigned to this chunk) ----
            insel = (rnew >= mb) & (rnew < me)
            if insel.any():
                mi = rnew[insel]
                qks = rkmers[insel]
                orig = rorig[insel]
                eidx, qrow, lcp = self._match_chunk(rdr, mi, qks, want_rev=True)
                if eidx.shape[0]:
                    if use_native:
                        rec_chunk.append(np.full(eidx.shape[0], ci, dtype=np.int32))
                        rec_eidx.append(np.asarray(eidx, dtype=np.int64))
                        rec_lcp.append(np.asarray(lcp, dtype=np.int64))
                        rec_qmask.append(np.asarray(orig[qrow], dtype=np.int64))
                    else:
                        v_idx = _ranges_to_indices(
                            np.asarray(rdr.entry_offsets[eidx]),
                            np.asarray(rdr.entry_offsets[eidx + 1]),
                        )
                        per = np.asarray(rdr.entry_offsets[eidx + 1]) - np.asarray(
                            rdr.entry_offsets[eidx]
                        )
                        all_vals.append(np.asarray(rdr.values[v_idx]))
                        all_lcp.append(np.repeat(lcp, per))
                        all_qloc_entry.append(np.repeat(orig[qrow], per))
                        all_rev.append(np.ones(int(per.sum()), dtype=bool))

        if use_native:
            if not rec_eidx:
                return {}
            from ..native import collect_anchors_native

            res = collect_anchors_native(
                [
                    (
                        np.asarray(r.values).ctypes.data,
                        np.asarray(r.entry_offsets).ctypes.data,
                    )
                    for r in self.chunks
                ],
                np.concatenate(rec_chunk),
                np.concatenate(rec_eidx),
                np.concatenate(rec_lcp),
                np.concatenate(rec_qmask),
                capres.pos_flat,
                capres.pos_offsets,
                capres.n_positions(),
                k,
            )
            ref, bq, bt, ln, rcq, rct = res
            if ref.shape[0] == 0:
                return {}
            bounds = np.nonzero(np.diff(ref))[0] + 1
            starts = np.concatenate([[0], bounds])
            ends = np.concatenate([bounds, [ref.shape[0]]])
            return {
                int(ref[s]): Anchors(bq[s:e], bt[s:e], ln[s:e], rcq[s:e], rct[s:e])
                for s, e in zip(starts, ends)
            }

        if not all_vals:
            return {}

        vals = np.concatenate(all_vals)
        lcps = np.concatenate(all_lcp).astype(np.int64)
        qmask = np.concatenate(all_qloc_entry).astype(np.int64)
        # suffix-search flag per VALUE row is not needed: the value's own
        # reverse bit drives the coordinate fix-up (ref: lib-index-search.go
        # :1451-1483); qmask gives the query-locs source either way.

        # expand by query locations of the originating mask
        qloc_counts = capres.n_positions()[qmask]
        keep = qloc_counts > 0
        vals = vals[keep]
        lcps = lcps[keep]
        qmask = qmask[keep]
        qloc_counts = qloc_counts[keep]
        if vals.shape[0] == 0:
            return {}

        off = capres.pos_offsets
        qloc_idx = _ranges_to_indices(off[qmask], off[qmask] + qloc_counts)
        rep = qloc_counts.astype(np.int64)
        vals = np.repeat(vals, rep)
        lcps = np.repeat(lcps, rep)
        qlocs = capres.pos_flat[qloc_idx].astype(np.int64)

        # decode posting values
        ref_idx = (vals >> np.uint64(BITS_NONE_IDX)).astype(np.int64)

        # genome filters: TaxId white/black lists and explicit genome sets
        if self.filter_by_taxid or genome_codes is not None:
            uniq = np.unique(ref_idx)
            allowed = set()
            for code in uniq:
                code = int(code)
                if genome_codes is not None and code not in genome_codes:
                    continue
                if self.filter_by_taxid and not self._genome_allowed(code):
                    continue
                allowed.add(code)
            keep = np.isin(ref_idx, np.array(sorted(allowed), dtype=np.int64))
            if not keep.any():
                return {}
            vals = vals[keep]
            lcps = lcps[keep]
            qlocs = qlocs[keep]
            ref_idx = ref_idx[keep]

        pos_t = ((vals << np.uint64(BITS_IDX)) >> np.uint64(BITS_IDX_FLAGS)).astype(np.int64)
        rv_t = (vals & np.uint64(1)).astype(bool)
        rc_t = ((vals >> np.uint64(1)) & np.uint64(1)).astype(bool)

        rc_q = (qlocs & 1).astype(bool)
        pos_q = qlocs >> 1

        # coordinate fix-ups (ref: lib-index-search.go:1455-1483)
        begin_q = np.where(
            ~rv_t,
            np.where(rc_q, pos_q + k - lcps, pos_q),
            np.where(rc_q, pos_q, pos_q + k - lcps),
        )
        begin_t = np.where(
            ~rv_t,
            np.where(rc_t, pos_t + k - lcps, pos_t),
            np.where(rc_t, pos_t, pos_t + k - lcps),
        )

        # group by genome
        order = np.argsort(ref_idx, kind="stable")
        ref_sorted = ref_idx[order]
        bounds = np.nonzero(np.diff(ref_sorted))[0] + 1
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [ref_sorted.shape[0]]])
        out = {}
        for s, e in zip(starts, ends):
            rid = int(ref_sorted[s])
            sl = order[s:e]
            out[rid] = Anchors(begin_q[sl], begin_t[sl], lcps[sl], rc_q[sl], rc_t[sl])
        return out

    # ------------------------------------------------------------------
    # phase 3: chaining

    def _chain_genomes(self, per_genome: dict):
        copt = self.opt.chaining_options()
        min_score = copt.min_score
        if len(per_genome) >= 8 and not os.environ.get("LEXICMAP_TPU_NO_BATCH"):
            hits = self._chain_genomes_batch(per_genome, copt)
            if hits is not None:
                return hits
        hits = []
        for rid, anchors in per_genome.items():
            a = clear_substr_pairs(anchors, self.k) if len(anchors) > 1 else anchors
            paths, score = chain(a, copt)
            if score < min_score or not paths:
                continue
            hit = GenomeHit(
                batch_genome_index=rid,
                genome_batch=rid >> BITS_GENOME_IDX,
                genome_index=rid & MASK_GENOME_IDX,
                score=float(score),
            )
            hits.append((hit, a, paths))
        # keep top-N genomes by chaining score
        top_n = self.opt.top_n
        if top_n > 0 and len(hits) > top_n:
            hits.sort(key=lambda t: -t[0].score)
            hits = hits[:top_n]
        return hits

    def _chain_genomes_batch(self, per_genome: dict, copt):
        """MANY-HIT fast path: sort + nested-anchor removal + chain DP +
        backtrack for every genome in ONE threaded native call
        (native/core.cpp::chain1_batch), bit-identical to the per-genome
        loop below (cross-checked by tests/test_native.py).  Returns None
        when the native lib is unavailable (caller falls back)."""
        from ..native import chain1_batch_native

        import multiprocessing as _mp

        threads = 1 if _mp.current_process().daemon else 0
        items = list(per_genome.items())
        batch = chain1_batch_native(
            [(a.qbegin, a.tbegin, a.length) for _, a in items],
            self.k, copt.max_gap, copt.min_score, copt.max_distance,
            copt.top_chains, threads=threads,
        )
        if batch is None:
            return None
        min_score = copt.min_score
        hits = []
        for (rid, anchors), (kept, paths, score) in zip(items, batch):
            if score < min_score or not paths:
                continue
            hit = GenomeHit(
                batch_genome_index=rid,
                genome_batch=rid >> BITS_GENOME_IDX,
                genome_index=rid & MASK_GENOME_IDX,
                score=float(score),
            )
            hits.append((hit, anchors.take(kept), paths))
        top_n = self.opt.top_n
        if top_n > 0 and len(hits) > top_n:
            hits.sort(key=lambda t: -t[0].score)
            hits = hits[:top_n]
        return hits

    def _chain_genomes_many(self, per_genome_list: list[dict]):
        """Batched phase 3: the chain1 forward DP of every genome of every
        query runs as one kernel launch (chain_engine=device;
        parallel/chain_device.py), with host backtracking — bit-identical
        to _chain_genomes.  Genomes the device flags (and those with fewer
        than two anchors) take the host chainer.  Returns one hits list per
        input per_genome dict."""
        from ..ops.chaining import _chain_backtrack, chain, clear_substr_pairs

        copt = self.opt.chaining_options()
        min_score = copt.min_score
        flat = []  # (query_pos, rid, cleared_anchors)
        for qi, per_genome in enumerate(per_genome_list):
            for rid, anchors in per_genome.items():
                a = clear_substr_pairs(anchors, self.k) if len(anchors) > 1 else anchors
                flat.append((qi, rid, a))
        dp = self.device_chainer.chain_batch(
            [(a.qbegin, a.tbegin, a.length) for (_, _, a) in flat]
        )
        out = [[] for _ in per_genome_list]
        for (qi, rid, a), (kind, fwd) in zip(flat, dp):
            if kind == "ok":
                ms, prev, dirs = fwd
                paths, score = _chain_backtrack(
                    ms, prev, dirs, np.float32(min_score), copt
                )
            else:
                paths, score = chain(a, copt)
            if score < min_score or not paths:
                continue
            hit = GenomeHit(
                batch_genome_index=rid,
                genome_batch=rid >> BITS_GENOME_IDX,
                genome_index=rid & MASK_GENOME_IDX,
                score=float(score),
            )
            out[qi].append((hit, a, paths))
        top_n = self.opt.top_n
        for qi, hits in enumerate(out):
            if top_n > 0 and len(hits) > top_n:
                hits.sort(key=lambda t: -t[0].score)
                out[qi] = hits[:top_n]
        return out

    # ------------------------------------------------------------------
    # phase 4: alignment

    def _path_windows(self, qcodes, hit: GenomeHit, anchors: Anchors, paths):
        """Prepare the target windows of every chain path (must be called
        with paths already sorted by first-anchor TBegin).  Returns
        (windows [tcodes...], metas [(q_begin, q_end, t_begin, t_end, rc,
        n_seeds)], trec) — shared by the host fused phase 4 and the device
        engine so window order/coordinates can never diverge."""
        opt = self.opt
        qlen = qcodes.shape[0]
        ext_len = opt.extend_length
        store = self.genome_stores[hit.genome_batch]
        gidx = hit.genome_index

        windows = []
        metas = []
        trec = None
        for path in paths:
            first = path[0]
            last = path[-1]
            qb = int(anchors.qbegin[first])
            tb = int(anchors.tbegin[first])
            qe = int(anchors.qbegin[last]) + int(anchors.length[last]) - 1
            te = int(anchors.tbegin[last]) + int(anchors.length[last]) - 1
            if len(path) == 1:
                rc = bool(anchors.qrc[last]) != bool(anchors.trc[last])
            else:
                rc = tb > int(anchors.tbegin[last])
            if rc:
                t_begin = max(int(anchors.tbegin[last]) - ext_len, 0)
                t_end = tb + int(anchors.length[last]) - 1 + ext_len
            else:
                t_begin = max(tb - ext_len, 0)
                t_end = te + ext_len
            q_begin = qb - min(qb, ext_len)
            q_end = qe + min(qlen - qe - 1, ext_len)

            trec = store.subseq(gidx, t_begin, t_end)
            tcodes = np.frombuffer(trec.seq, dtype=np.uint8)
            if tcodes.shape[0] < t_end - t_begin + 1:
                t_end -= t_end - t_begin + 1 - tcodes.shape[0]
            if rc:
                tcodes = (np.uint8(3) - tcodes)[::-1]
            windows.append(np.ascontiguousarray(tcodes))
            metas.append((q_begin, q_end, t_begin, t_end, rc, len(path)))
        return windows, metas, trec

    def _align_prepare_native(self, qcodes, hit: GenomeHit, anchors: Anchors, paths, cpr,
                              pseudo=None, wins=None):
        """Stage 1 of the fused native phase 5: prepare the per-genome
        align_paths argument pack (target windows, metas, injected device
        pseudo-align rows).  wins: this genome's _path_windows result when
        the caller already extracted it (the device engine's phase 4).
        Returns NotImplemented (no native lib), None
        (no target record), or a ctx dict consumed by _align_spans_native /
        _align_finish_native.  Split out so the device engine can batch the
        WFA spans of EVERY genome of EVERY query in a batch into one device
        dispatch (the reference's falin runs per genome,
        ref: lib-index-search.go:1845-2720)."""
        from ..native import get_lib

        if get_lib() is None or cpr.qk is None:
            return NotImplemented
        opt = self.opt
        k = self.k
        qlen = qcodes.shape[0]

        if wins is None:
            wins = self._path_windows(qcodes, hit, anchors, paths)
        windows, metas, trec = wins
        if trec is None:
            return None

        pre_rows = pre_off = pre_cnt = None
        if pseudo is not None:
            assert len(pseudo) == len(windows)
            pre_cnt = np.full(len(windows), -1, dtype=np.int64)
            pre_off = np.zeros(len(windows), dtype=np.int64)
            blocks = []
            off = 0
            for i, (kind, rows) in enumerate(pseudo):
                if kind == "none":
                    pre_cnt[i] = 0
                elif kind == "rows":
                    pre_cnt[i] = rows.shape[0]
                    pre_off[i] = off
                    blocks.append(rows)
                    off += rows.shape[0]
            pre_rows = (
                np.ascontiguousarray(np.concatenate(blocks))
                if blocks
                else np.zeros((0, 8), dtype=np.int64)
            )
        t_len = np.array([w.shape[0] for w in windows], dtype=np.int64)
        t_off = np.zeros(len(windows), dtype=np.int64)
        np.cumsum(t_len[:-1], out=t_off[1:])
        tbuf = np.concatenate(windows) if windows else np.zeros(0, dtype=np.uint8)
        copt = cpr.opt.chaining
        args = (
            qcodes, cpr.qk, cpr.qv, getattr(cpr, "qtab", None),
            getattr(cpr, "qtab_bits", 0),
            cpr.k, cpr.opt.min_prefix,
            copt.band_base, copt.band_count, float(copt.max_gap),
            float(copt.min_score), int(copt.min_align_len),
            float(copt.heuristic_kmer_pident_threshold),
            tbuf, t_off, t_len,
            np.array([m[0] for m in metas], dtype=np.int64),
            np.array([m[1] for m in metas], dtype=np.int64),
            np.array([m[2] for m in metas], dtype=np.int64),
            np.array([m[3] for m in metas], dtype=np.int64),
            np.array([1 if m[4] else 0 for m in metas], dtype=np.uint8),
            np.asarray(trec.seq_sizes, dtype=np.int64), self.contig_interval, k,
            opt.extend_length2, self.total_bases, opt.max_evalue,
            opt.min_qcov_hsp, opt.min_identity,
        )
        kw = dict(pre_rows=pre_rows, pre_off=pre_off, pre_cnt=pre_cnt)
        return {
            "args": args, "kw": kw, "windows": windows, "metas": metas,
            "trec": trec, "qlen": qlen,
        }

    def _align_spans_native(self, qcodes, ctx):
        """Stage 2a of the fused native phase 5 (WFA offload only): collect
        the extended HSP windows this genome will WFA-align.  Returns the
        list of (qcodes, tcodes) pairs (empty when there is nothing to
        align on the device)."""
        from ..native import align_paths_native

        spans = align_paths_native(*ctx["args"], span_mode=1, **ctx["kw"])
        if spans is None or not spans.shape[0]:
            return []
        windows = ctx["windows"]
        pairs = []
        for (q0, qn, t0, tn, pi) in spans:
            tc = windows[int(pi)]
            pairs.append((qcodes[q0 : q0 + qn], tc[t0 : t0 + tn]))
        return pairs

    def _align_finish_native(self, qcodes, hit: GenomeHit, ctx, ops_lists=None,
                             rows=None):
        """Stage 2b/3 of the fused native phase 5: run align_paths (with the
        device WFA op streams injected when ops_lists is given — bit-exact
        with the host WFA) and assemble SeqDetails from the returned rows.
        `rows` short-circuits the align_paths call with a precomputed row
        matrix (the many-hit batch path, _phase4_batch_native).  Returns
        NotImplemented when the caller must use the per-chain Python path."""
        from ..native import align_paths_native

        opt = self.opt
        args, kw = ctx["args"], ctx["kw"]
        metas, trec, qlen = ctx["metas"], ctx["trec"], ctx["qlen"]
        if rows is None and ops_lists is not None and all(o is not None for o in ops_lists):
            blobs = [
                b"".join(op.encode() * int(n) for (op, n) in opl)
                for opl in ops_lists
            ]
            inj_len = np.array([len(b) for b in blobs], dtype=np.int64)
            inj_off = np.zeros(len(blobs), dtype=np.int64)
            np.cumsum(inj_len[:-1], out=inj_off[1:])
            inj_ops = np.frombuffer(
                b"".join(blobs) or b"\0", dtype=np.uint8
            )
            rows = align_paths_native(
                *args, span_mode=2, inj_ops=inj_ops, inj_off=inj_off,
                inj_len=inj_len, **kw,
            )
        if rows is None:
            rows = align_paths_native(*args, **kw)
        if rows is None:
            return NotImplemented
        if rows.shape[0] == 0:
            return None

        hit.genome_size = trec.genome_size
        hit.num_seqs = trec.num_seqs
        hit.genome_id = trec.id
        n_chunks, chunk_idx = self.genome_chunk_idx.get(hit.batch_genome_index, (1, 0))

        from ..ops.seqcompare import SeqComparatorResult

        sds: list[SeqDetail] = []
        gids = rows[:, 1].astype(np.int64)
        bounds = np.nonzero(np.diff(gids))[0] + 1
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [rows.shape[0]]])
        for s, epos in zip(starts, ends):
            grp = rows[s:epos]
            path_idx = int(grp[0, 0])
            i_seq = int(grp[0, 2])
            rc = bool(grp[0, 17])
            kept = []
            max_sim = 0.0
            for row in grp:
                c = Chain2Result(
                    n_anchors=int(row[16]),
                    qbegin=int(row[3]), qend=int(row[4]),
                    tbegin=int(row[5]), tend=int(row[6]),
                    aligned_length=int(row[7]), matched_bases=int(row[8]),
                    gaps=int(row[9]), pident=float(row[10]),
                    aligned_fraction=float(row[11]),
                    aligned_bases_q=int(row[12]),
                    score=int(row[13]), bit_score=int(row[14]),
                    evalue=float(row[15]),
                )
                sim = float(c.bit_score) * c.pident
                if sim > max_sim:
                    max_sim = sim
                kept.append(c)
            r2 = SeqComparatorResult()
            r2.update2(kept, qlen)
            sds.append(
                SeqDetail(
                    rc=rc,
                    n_seeds=metas[path_idx][5],
                    similarity_score=max_sim,
                    chains=kept,
                    aligned_bases=r2.aligned_bases,
                    seq_id=trec.seq_ids[i_seq] if trec.seq_ids else b"",
                    seq_idx=i_seq,
                    n_seqs=trec.num_seqs,
                    seq_len=trec.seq_sizes[i_seq],
                    n_chunks=n_chunks,
                    chunk_idx=chunk_idx,
                )
            )

        if not sds:
            return None
        if not self.genome_chunk_idx:
            regions = [(c.qbegin, c.qend) for sd in sds for c in sd.chains]
            af = min(coverage_len(regions) / qlen * 100, 100.0)
            hit.aligned_fraction = af
            if af < opt.min_qcov_genome:
                return None
        sds.sort(key=lambda sd: -sd.similarity_score)
        hit.details = sds
        return hit

    def _align_genome_native(self, qcodes, hit: GenomeHit, anchors: Anchors, paths, cpr,
                             pseudo=None, wins=None):
        """Fused native phase 4: one C call per genome runs pseudo-alignment,
        contig assignment, dedup, extension, WFA and scoring for every chain
        window (core.cpp align_paths).  Composition of the prepare / spans /
        finish stages; the device engine drives the stages itself to batch
        the WFA spans of a whole query batch into one device dispatch.
        pseudo: optional device pseudo-align results, one entry per sorted
        path: ('rows', int64 [C, 8]) | ('none', None) | ('host', None).
        wins: the genome's _path_windows result, when already extracted.
        Same semantics as the loop in _align_genome (ref: falin,
        lib-index-search.go:1845-2720)."""
        ctx = self._align_prepare_native(qcodes, hit, anchors, paths, cpr, pseudo, wins)
        if ctx is NotImplemented:
            return NotImplemented
        if ctx is None:
            return None
        ops_lists = None
        if self.device_wfa is not None and pseudo is not None:
            # two-phase WFA offload: collect the extended HSP windows, align
            # them batched on the device (bit-exact with the host WFA; rare
            # overflows fall back to host inside DeviceWFA), then finish with
            # the op streams injected
            pairs = self._align_spans_native(qcodes, ctx)
            if pairs:
                ops_lists = self.device_wfa.align_batch(pairs)
        return self._align_finish_native(qcodes, hit, ctx, ops_lists)

    def _phase4_batch_native(self, qcodes, hits, cpr, threads=0, pseudo_map=None,
                             wins_map=None):
        """MANY-HIT phase 4: prepare every genome's align_paths argument
        pack, then run ONE threaded native call for the whole genome set
        (native/core.cpp::align_paths_batch).  Bit-identical to the
        per-genome loop (same align_paths core per genome).  Rare per-genome
        overflow / WFA-failure slots are retried via the per-genome paths.
        pseudo_map / wins_map: per hit index, the device engine's chain rows
        and extracted windows (see _phase4_assemble).
        Returns the results list, or None when the native path is
        unavailable (caller falls back)."""
        from ..native import align_paths_batch_native

        pseudo_map = pseudo_map or {}
        wins_map = wins_map or {}
        ctxs = []
        for i, (hit, anchors, paths) in enumerate(hits):
            paths = sorted(paths, key=lambda p: int(anchors.tbegin[p[0]]))
            ctx = self._align_prepare_native(qcodes, hit, anchors, paths, cpr,
                                             pseudo_map.get(i), wins_map.get(i))
            if ctx is NotImplemented:
                return None
            ctxs.append(ctx)  # may be None (missing target record)
        live = [(i, c) for i, c in enumerate(ctxs) if c is not None]
        if not live:
            return []
        batch = align_paths_batch_native(
            [c["args"] for _, c in live], threads=threads,
            ctx_kw_list=[c["kw"] for _, c in live],
        )
        if batch is None:
            return None
        results = []
        for (i, ctx), rows in zip(live, batch):
            hit, anchors, paths = hits[i]
            if isinstance(rows, str):
                if rows == "overflow":
                    # per-genome retry grows the row buffer as needed
                    r = self._align_finish_native(qcodes, hit, ctx)
                    if r is NotImplemented:
                        r = self._align_genome(qcodes, hit, anchors, paths, cpr,
                                               pseudo_map.get(i))
                else:  # wfa_fail: per-chain Python path
                    r = self._align_genome(qcodes, hit, anchors, paths, cpr,
                                           pseudo_map.get(i))
            elif rows.shape[0] == 0:
                r = None
            else:
                r = self._align_finish_native(qcodes, hit, ctx, rows=rows)
            if r is not None and r is not NotImplemented:
                results.append(r)
        return results

    def _align_genome(self, qcodes, hit: GenomeHit, anchors: Anchors, paths, cpr: SeqComparator,
                      pseudo=None, wins=None):
        """(ref: falin, lib-index-search.go:1845-2720)"""
        opt = self.opt
        k = self.k
        qlen = qcodes.shape[0]
        ext_len = opt.extend_length
        store = self.genome_stores[hit.genome_batch]
        gidx = hit.genome_index

        sds: list[SeqDetail] = []
        dedup: set = set()

        # sort chains by the TBegin of their first anchor
        paths = sorted(paths, key=lambda p: int(anchors.tbegin[p[0]]))

        if not opt.output_seq:
            r = self._align_genome_native(qcodes, hit, anchors, paths, cpr, pseudo=pseudo,
                                          wins=wins)
            if r is not NotImplemented:
                return r

        for path in paths:
            n_seeds = len(path)
            first = path[0]
            last = path[-1]
            qb = int(anchors.qbegin[first])
            tb = int(anchors.tbegin[first])
            qe = int(anchors.qbegin[last]) + int(anchors.length[last]) - 1
            te = int(anchors.tbegin[last]) + int(anchors.length[last]) - 1

            if n_seeds == 1:
                rc = bool(anchors.qrc[last]) != bool(anchors.trc[last])
            else:
                rc = tb > int(anchors.tbegin[last])

            if rc:
                t_begin = max(int(anchors.tbegin[last]) - ext_len, 0)
                t_end = tb + int(anchors.length[last]) - 1 + ext_len
            else:
                t_begin = max(tb - ext_len, 0)
                t_end = te + ext_len

            q_begin = qb - min(qb, ext_len)
            q_end = qe + min(qlen - qe - 1, ext_len)

            trec = store.subseq(gidx, t_begin, t_end)
            tcodes = np.frombuffer(trec.seq, dtype=np.uint8)
            if tcodes.shape[0] < t_end - t_begin + 1:
                t_end -= t_end - t_begin + 1 - tcodes.shape[0]
            if rc:
                tcodes = (np.uint8(3) - tcodes)[::-1]

            cr = cpr.compare(q_begin, q_end, tcodes, qlen)
            if cr is None:
                continue

            if hit.genome_size == 0:
                hit.genome_size = trec.genome_size
                hit.num_seqs = trec.num_seqs
                hit.genome_id = trec.id

            seq_sizes = trec.seq_sizes
            n_chunks, chunk_idx = self.genome_chunk_idx.get(hit.batch_genome_index, (1, 0))

            i_seq_pre = -1
            last_i_seq = -1
            group: list[Chain2Result] = []

            def flush(group_chains: list[Chain2Result], i_seq: int):
                self._flush_hsp_group(
                    sds, group_chains, i_seq, rc, n_seeds, qcodes, tcodes,
                    t_begin, t_end, qlen, trec, n_chunks, chunk_idx,
                )

            for c in cr.chains:
                qb2, qe2, tb2, te2 = c.qbegin, c.qend, c.tbegin, c.tend
                i_seq = 0
                t_off_begin = 0
                if trec.num_seqs > 1:
                    i_seq, t_off_begin = _find_contig(
                        seq_sizes, self.contig_interval, k, rc, t_begin, t_end, tb2, te2
                    )
                    if i_seq < 0:
                        continue
                    if i_seq_pre >= 0 and i_seq != i_seq_pre:
                        i_seq0 = i_seq
                        # convert current chain with its own contig offset,
                        # clamped against the PREVIOUS contig's size (faithful
                        # to ref lib-index-search.go:2113-2158)
                        _convert_chain(
                            c, rc, t_begin, t_end, t_off_begin,
                            seq_sizes[i_seq_pre], len(tcodes)
                        )
                        if group:
                            flush(group, i_seq_pre)
                        group = []
                        # dedup key uses the PREVIOUS contig index here,
                        # mirroring ref lib-index-search.go:2360
                        h = (c.qbegin, c.qend, c.tbegin, c.tend, rc, i_seq_pre)
                        if h not in dedup:
                            group.append(c)
                            dedup.add(h)
                        i_seq_pre = -1
                        last_i_seq = i_seq0
                        continue
                i_seq_pre = i_seq
                last_i_seq = i_seq

                _convert_chain(
                    c, rc, t_begin, t_end, t_off_begin, seq_sizes[i_seq], len(tcodes)
                )
                h = (c.qbegin, c.qend, c.tbegin, c.tend, rc, i_seq)
                if h in dedup:
                    continue
                dedup.add(h)
                group.append(c)

            if last_i_seq >= 0 and group:
                flush(group, last_i_seq)

        if not sds:
            return None

        if not self.genome_chunk_idx:
            regions = [(c.qbegin, c.qend) for sd in sds for c in sd.chains]
            af = min(coverage_len(regions) / qlen * 100, 100.0)
            hit.aligned_fraction = af
            if af < opt.min_qcov_genome:
                return None

        sds.sort(key=lambda sd: -sd.similarity_score)
        hit.details = sds
        return hit

    def _flush_hsp_group(
        self, sds, group, i_seq, rc, n_seeds, qcodes, tcodes,
        t_begin, t_end, qlen, trec, n_chunks, chunk_idx,
    ):
        """Align and score one group of pseudo-chains belonging to one contig
        (ref: lib-index-search.go:2164-2348 / 2430-2617)."""
        opt = self.opt
        ext2_base = opt.extend_length2
        has_result = False
        max_sim = 0.0
        kept: list[Chain2Result] = []

        # per-chain window/extension params (shared by both paths)
        prepped: list[tuple] = []
        for c in group:
            if c.qbegin >= c.qend + 1:
                continue
            if rc:
                start = t_end - c.tend - c.t_pos_offset_begin
                end = t_end - c.tbegin - c.t_pos_offset_begin + 1
            else:
                start = c.t_pos_offset_begin + c.tbegin - t_begin
                end = c.t_pos_offset_begin + c.tend - t_begin + 1
            if start >= end:
                continue
            ext2 = ext2_base
            if c.aligned_bases_q > 1_000_000:
                ext2 += 80
            elif c.aligned_bases_q > 250_000:
                ext2 += 40
            elif c.aligned_bases_q > 50_000:
                ext2 += 20
            elif c.aligned_bases_q > 10_000:
                ext2 += 10
            prepped.append((c, start, end, ext2))

        # fused fast path (no -a output): extend + WFA + trimmed stats for
        # the WHOLE group in one native call (mirrors the per-chain loop
        # below; ref: lib-index-search.go:2164-2348)
        batch = None
        if prepped and not opt.output_seq:
            from ..native import hsp_extend_wfa_batch_native

            res = hsp_extend_wfa_batch_native(
                qcodes, tcodes, rc,
                np.array([c.qbegin for c, *_ in prepped], dtype=np.int64),
                np.array([c.qend + 1 for c, *_ in prepped], dtype=np.int64),
                np.array([p[1] for p in prepped], dtype=np.int64),
                np.array([p[2] for p in prepped], dtype=np.int64),
                np.array([p[3] for p in prepped], dtype=np.int64),
                np.array([c.tbegin for c, *_ in prepped], dtype=np.int64),
                np.array([c.max_ext_len for c, *_ in prepped], dtype=np.int64),
            )
            if res is not None and res[1] < 0:
                batch = res[0]

        if batch is not None:
            for bi, (c, start, end, ext2) in enumerate(prepped):
                row = batch[bi]
                if row[1] == 0:  # empty trimmed region -> e-value inf
                    continue
                a_len, a_matches, a_gaps = int(row[1]), int(row[2]), int(row[4])
                cg_qb, cg_qe = int(row[5]), int(row[6])
                cg_tb, cg_te = int(row[7]), int(row[8])
                score = int(row[9])
                s1, e1, s2, e2 = int(row[10]), int(row[11]), int(row[12]), int(row[13])
                len_qseq, len_tseq = int(row[14]), int(row[15])
                bits, evalue = score_to_bit_evalue(score, len_qseq, self.total_bases)
                c.score, c.bit_score, c.evalue = score, bits, evalue
                if evalue > opt.max_evalue:
                    continue

                c.qbegin -= s1
                c.qend += e1
                c.qbegin = c.qbegin + cg_qb - 1
                c.qend = c.qend - (len_qseq - cg_qe)
                if rc:
                    c.tbegin -= e2
                    c.tend += s2
                    c.tbegin = c.tbegin + (len_tseq - cg_te)
                    c.tend = c.tend - (cg_tb - 1)
                else:
                    c.tbegin -= s2
                    c.tend += e2
                    c.tbegin = c.tbegin + (cg_tb - 1)
                    c.tend = c.tend - (len_tseq - cg_te)

                c.aligned_bases_q = c.qend - c.qbegin + 1
                c.aligned_length = a_len
                c.matched_bases = a_matches
                c.gaps = a_gaps
                c.aligned_fraction = min(c.aligned_bases_q / qlen * 100, 100.0)
                c.pident = c.matched_bases / a_len * 100 if a_len else 0.0
                if c.aligned_fraction < opt.min_qcov_hsp or c.pident < opt.min_identity:
                    continue
                sim = float(c.bit_score) * c.pident
                if sim > max_sim:
                    max_sim = sim
                has_result = True
                kept.append(c)
            prepped = []  # handled

        # -a with --wfa device: the device WFA emits full op streams, which
        # is exactly what the 24-col text assembly consumes — batch the
        # whole group's alignments in one device call (bit-exact with the
        # host WFA; None entries fall back per chain below)
        dev_ops = None
        ext_cache = None
        if prepped and opt.output_seq and self.device_wfa is not None:
            ext_cache = [
                extend_match(
                    qcodes, tcodes, c.qbegin, c.qend + 1, start, end,
                    ext2, c.tbegin, c.max_ext_len, rc,
                )
                for c, start, end, ext2 in prepped
            ]
            dev_ops = self.device_wfa.align_batch(
                [(qs, ts) for qs, ts, *_ in ext_cache]
            )

        for pi_, (c, start, end, ext2) in enumerate(prepped):
            if ext_cache is not None:
                qseq, tseq, s1, e1, s2, e2 = ext_cache[pi_]
            else:
                qseq, tseq, s1, e1, s2, e2 = extend_match(
                    qcodes, tcodes, c.qbegin, c.qend + 1, start, end,
                    ext2, c.tbegin, c.max_ext_len, rc,
                )
            # fast path (no -a output): WFA + trimmed stats in one native
            # call; identical numbers to the RLE-tuple path
            fast = None
            if not opt.output_seq:
                from ..native import wfa_align_stats_native

                fast = wfa_align_stats_native(qseq, tseq)
            if fast is not None:
                stats, _ops = fast
                if stats[1] == 0:  # empty trimmed region -> e-value inf
                    continue
                a_len, a_matches, a_gaps = int(stats[1]), int(stats[2]), int(stats[4])
                cg_qb, cg_qe = int(stats[5]), int(stats[6])
                cg_tb, cg_te = int(stats[7]), int(stats[8])
                score = int(stats[9])
                bits, evalue = score_to_bit_evalue(score, len(qseq), self.total_bases)
                cigar = None
            else:
                cigar = None
                if dev_ops is not None and dev_ops[pi_] is not None:
                    from ..ops.align import _finalize

                    ops_d = dev_ops[pi_]
                    cost = sum(
                        cnt * 4 if op == "X" else (6 + cnt * 2)
                        for op, cnt in ops_d
                        if op in "XID"
                    )
                    cigar = _finalize(ops_d, cost, len(qseq), len(tseq))
                if cigar is None:
                    cigar = wfa_align(qseq, tseq)
                if cigar is None:  # fallback: banded Gotoh
                    cigar = align(qseq, tseq)
                trimmed = cigar.trimmed_ops()
                score, bits, evalue = score_and_evalue(
                    trimmed, len(qseq), self.total_bases
                )
                a_len, a_matches, a_gaps = cigar.align_len, cigar.matches, cigar.gaps
                cg_qb, cg_qe = cigar.qbegin, cigar.qend
                cg_tb, cg_te = cigar.tbegin, cigar.tend
            c.score, c.bit_score, c.evalue = score, bits, evalue
            if evalue > opt.max_evalue:
                continue

            c.qbegin -= s1
            c.qend += e1
            c.qbegin = c.qbegin + cg_qb - 1
            c.qend = c.qend - (len(qseq) - cg_qe)
            if rc:
                c.tbegin -= e2
                c.tend += s2
                c.tbegin = c.tbegin + (len(tseq) - cg_te)
                c.tend = c.tend - (cg_tb - 1)
            else:
                c.tbegin -= s2
                c.tend += e2
                c.tbegin = c.tbegin + (cg_tb - 1)
                c.tend = c.tend - (len(tseq) - cg_te)

            c.aligned_bases_q = c.qend - c.qbegin + 1
            c.aligned_length = a_len
            c.matched_bases = a_matches
            c.gaps = a_gaps
            c.aligned_fraction = min(c.aligned_bases_q / qlen * 100, 100.0)
            c.pident = c.matched_bases / a_len * 100 if a_len else 0.0
            if c.aligned_fraction < opt.min_qcov_hsp or c.pident < opt.min_identity:
                continue

            if opt.output_seq:
                c.cigar = b"".join(
                    str(n).encode() + op.encode() for op, n in trimmed
                )
                from ..utils.kmers import codes_to_seq

                qtext = codes_to_seq(np.frombuffer(bytes(qseq), dtype=np.uint8))
                ttext = codes_to_seq(np.frombuffer(bytes(tseq), dtype=np.uint8))
                qr, ar, tr = alignment_text(trimmed, qtext, ttext)
                c.qseq, c.alignment, c.tseq = qr, ar, tr

            sim = float(c.bit_score) * c.pident
            if sim > max_sim:
                max_sim = sim
            has_result = True
            kept.append(c)

        if has_result:
            from ..ops.seqcompare import SeqComparatorResult

            r2 = SeqComparatorResult()
            r2.update2(kept, qlen)
            sds.append(
                SeqDetail(
                    rc=rc,
                    n_seeds=n_seeds,
                    similarity_score=max_sim,
                    chains=kept,
                    aligned_bases=r2.aligned_bases,
                    seq_id=trec.seq_ids[i_seq] if trec.seq_ids else b"",
                    seq_idx=i_seq,
                    n_seqs=trec.num_seqs,
                    seq_len=trec.seq_sizes[i_seq],
                    n_chunks=n_chunks,
                    chunk_idx=chunk_idx,
                )
            )

    # ------------------------------------------------------------------

    def search(
        self,
        qcodes: np.ndarray,
        genome_codes: set[int] | None = None,
        premasked=None,
        dev_hits_pre=None,
    ) -> list[GenomeHit]:
        """Full pipeline for one query (already encoded to 2-bit codes)."""
        import sys
        import time

        debug = self.opt.debug
        t0 = time.time()
        if qcodes.shape[0] < self.k:
            return []
        per_genome = self._collect_anchors(
            qcodes, genome_codes, premasked=premasked, dev_hits_pre=dev_hits_pre
        )
        if debug:
            print(
                f"  [debug] seed matching: {len(per_genome)} genome hits "
                f"in {time.time() - t0:.3f}s",
                file=sys.stderr,
            )
            t0 = time.time()
        if not per_genome:
            return []
        hits = self._chain_genomes(per_genome)
        if debug:
            print(
                f"  [debug] chaining: {len(hits)} genomes kept "
                f"in {time.time() - t0:.3f}s",
                file=sys.stderr,
            )
            t0 = time.time()
        if not hits:
            return []

        return self._phase4_assemble(qcodes, hits, debug=debug, t0=t0)

    def make_device_chainer(self, device):
        """A DeviceChainer with this search's chaining options on `device`."""
        from ..parallel.chain_device import DeviceChainer

        copt = self.opt.chaining_options()
        return DeviceChainer(max_gap=copt.max_gap, min_score=copt.min_score,
                             max_dist=int(copt.max_distance), device=device)

    def phase4_pool(self):
        """The threads that align a query's genomes (phases 5-6), shared by
        the per-query path and the device engine's batch-wide flow; they
        persist across queries (thread spawn costs per query add up)."""
        ex = getattr(self, "_phase4_pool", None)
        if ex is None:
            from concurrent.futures import ThreadPoolExecutor

            ex = self._phase4_pool = ThreadPoolExecutor(max_workers=min(4, os.cpu_count() or 1))
        return ex

    def _phase4_assemble(self, qcodes, hits, pseudo_map=None, debug=False, t0=0.0,
                         cpr=None, wins_map=None):
        """Phase 4 (per-genome alignment) + final result assembly.

        pseudo_map: optional {hit_index -> per-sorted-path device pseudo-align
        results} computed up front by the device engine (parallel/engine.py),
        which also hands over the query's indexed comparator (cpr) and each
        hit's extracted windows ({hit_index -> _path_windows result})."""
        import sys
        import time

        if cpr is None:
            cpr = SeqComparator(self.opt.seqcompare_options())
            cpr.index(qcodes)
        wins_map = wins_map or {}

        results: list[GenomeHit] = []
        import multiprocessing as _mp

        in_pool_worker = _mp.current_process().daemon
        if (
            len(hits) >= 8
            and self.device_wfa is None
            and not self.opt.output_seq
            and not os.environ.get("LEXICMAP_TPU_NO_BATCH")
        ):
            # MANY-HIT fast path: one threaded native call aligns every
            # genome (align_paths_batch); per-genome futures + ctypes
            # marshaling dominate beyond a few hundred genome hits
            res = self._phase4_batch_native(
                qcodes, hits, cpr, threads=1 if in_pool_worker else 0,
                pseudo_map=pseudo_map, wins_map=wins_map,
            )
            if res is not None:
                if debug:
                    print(
                        f"  [debug] alignment: {len(res)} genomes with HSPs "
                        f"in {time.time() - t0:.3f}s (batched native)",
                        file=sys.stderr,
                    )
                return self._assemble_results(qcodes, res)
        if len(hits) > 1 and (os.cpu_count() or 1) > 1 and not in_pool_worker:
            # per-genome alignment fans out over threads: the native WFA /
            # chaining calls release the GIL (the reference's per-genome
            # goroutines, ref: lib-index-search.go:2722-2727).
            ex = self.phase4_pool()
            futs = [
                ex.submit(
                    self._align_genome, qcodes, hit, anchors, paths, cpr,
                    pseudo_map.get(i) if pseudo_map else None, wins_map.get(i),
                )
                for i, (hit, anchors, paths) in enumerate(hits)
            ]
            for f in futs:
                r = f.result()
                if r is not None:
                    results.append(r)
        else:
            for i, (hit, anchors, paths) in enumerate(hits):
                r = self._align_genome(
                    qcodes, hit, anchors, paths, cpr,
                    pseudo_map.get(i) if pseudo_map else None, wins_map.get(i),
                )
                if r is not None:
                    results.append(r)

        if debug:
            print(
                f"  [debug] alignment: {len(results)} genomes with HSPs "
                f"in {time.time() - t0:.3f}s",
                file=sys.stderr,
            )
        return self._assemble_results(qcodes, results)

    def _assemble_results(self, qcodes, results: list[GenomeHit]):
        """Phase 6: genome-chunk merging, qcovGnm recompute, final filters
        and output ordering for one query's per-genome alignment results
        (ref: lib-index-search.go:2755-2870).  Shared by the host per-query
        path (_phase4_assemble) and the device engine's batched-WFA flow."""
        if not results:
            return []

        # merge genome chunks of the same genome, then (re)compute qcovGnm for
        # every result (ref: lib-index-search.go:2755-2870)
        if self.genome_chunk_idx:
            bygroup: dict[int, list[GenomeHit]] = {}
            pre: list[GenomeHit] = []
            for r in results:
                gi = self.genome_chunk_group.get(r.batch_genome_index)
                if gi is None:
                    pre.append(r)
                else:
                    bygroup.setdefault(gi, []).append(r)
            for rs in bygroup.values():
                main = rs[0]
                for other in rs[1:]:
                    main.details.extend(other.details)
                pre.append(main)
            qlen = qcodes.shape[0]
            merged: list[GenomeHit] = []
            for r in pre:
                regions = [(c.qbegin, c.qend) for sd in r.details for c in sd.chains]
                r.aligned_fraction = min(coverage_len(regions) / qlen * 100, 100.0)
                if r.aligned_fraction < self.opt.min_qcov_genome:
                    continue
                r.details.sort(key=lambda sd: -sd.similarity_score)
                merged.append(r)
            results = merged
            if not results:
                return []

        # sort genomes by the best detail's similarity score
        results.sort(key=lambda r: -r.details[0].similarity_score)
        for r in results:
            r.details = _sort_by_seq_id(r.details)
            if not r.genome_id:
                r.genome_id = self.id_of_code.get(r.batch_genome_index, b"?")
        return results

    def search_bytes(self, seq: bytes) -> list[GenomeHit]:
        return self.search(seq_to_codes(seq.upper()))

    def search_many(self, seqs: list[bytes]) -> list[list[GenomeHit]]:
        """Search a batch of queries.  With --engine device, the whole batch
        flows through the device engine (parallel/engine.py): seed matching
        runs as one batched kernel launch per bucket and pseudo-alignment as
        one launch each of the probe and chain kernels, with the remaining
        host phases threaded.  Host engine: per-query loop."""
        if self.device_matcher is None:
            return [self.search(seq_to_codes(s.upper())) for s in seqs]

        eng = getattr(self, "_device_engine", None)
        if eng is None:
            from ..parallel.engine import DeviceSearchEngine

            eng = DeviceSearchEngine(self)
            self._device_engine = eng
        # pipeline: host phase 5 (alignment) of batch N runs in a worker
        # thread while the device prepares batch N+1 (native align calls
        # release the GIL, so the two genuinely overlap)
        fin = getattr(self, "_finish_pool", None)
        if fin is None:
            from concurrent.futures import ThreadPoolExecutor

            fin = ThreadPoolExecutor(max_workers=1)
            self._finish_pool = fin
        out_map: dict[int, list[GenomeHit]] = {}
        fut = None
        fut_ids: list[int] = []
        for o in range(0, len(seqs), 32):
            ids = list(range(o, min(o + 32, len(seqs))))
            prepared = eng.prepare_batch([seqs[i] for i in ids])
            if fut is not None:
                for i, r in zip(fut_ids, fut.result()):
                    out_map[i] = r
            fut = fin.submit(eng.finish_batch, prepared)
            fut_ids = ids
        if fut is not None:
            for i, r in zip(fut_ids, fut.result()):
                out_map[i] = r
        return [out_map.get(i, []) for i in range(len(seqs))]


def _find_contig(seq_sizes, interval, k, rc, t_begin, t_end, tb2, te2):
    """Locate the contig containing the matched window region
    (ref: lib-index-search.go:2049-2100).  Returns (i_seq, t_pos_offset_begin)
    with i_seq = -1 when the region crosses contigs."""
    if rc:
        b, e = t_end - te2 + k, t_end - tb2 - k
    else:
        b, e = t_begin + tb2 + k, t_begin + te2 - k
    if b >= e:
        if rc:
            b, e = t_end - te2, t_end - tb2
        else:
            b, e = t_begin + tb2, t_begin + te2
    off_begin = 0
    off_end = 0
    for j, l in enumerate(seq_sizes):
        off_end += l - 1
        if b + k >= off_begin and e - k <= off_end:
            return j, off_begin
        if e < off_begin:
            return -1, 0
        off_end += interval + 1
        off_begin = off_end
    return -1, 0


def _convert_chain(c: Chain2Result, rc, t_begin, t_end, t_off_begin, seq_size, tlen):
    """Convert window coordinates to contig coordinates
    (ref: lib-index-search.go:2380-2411)."""
    qb, qe, tb, te = c.qbegin, c.qend, c.tbegin, c.tend
    c.t_pos_offset_begin = t_off_begin
    if rc:
        c.tbegin = t_begin - t_off_begin + (tlen - te - 1)
        if c.tbegin < 0:
            c.qend += c.tbegin
            c.aligned_bases_q += c.tbegin
            c.tbegin = 0
        c.tend = t_begin - t_off_begin + (tlen - tb - 1)
        if c.tend > seq_size - 1:
            c.qbegin += c.tend - (seq_size - 1)
            c.tend = seq_size - 1
    else:
        c.tbegin = t_begin - t_off_begin + tb
        if c.tbegin < 0:
            c.qbegin -= c.tbegin
            c.aligned_bases_q += c.tbegin
            c.tbegin = 0
        c.tend = t_begin - t_off_begin + te
        if c.tend > seq_size - 1:
            c.qend -= c.tend - (seq_size - 1)
            c.tend = seq_size - 1
    c.max_ext_len = seq_size - 1 - c.tend


def _sort_by_seq_id(sds: list[SeqDetail]) -> list[SeqDetail]:
    """Group details by SeqID preserving first-occurrence order
    (ref: SearchResult.SortBySeqID, lib-index-search.go:1005-1058)."""
    out: list[SeqDetail] = []
    seen: dict[bytes, list[SeqDetail]] = {}
    order: list[bytes] = []
    for sd in sds:
        if sd.seq_id not in seen:
            seen[sd.seq_id] = []
            order.append(sd.seq_id)
        seen[sd.seq_id].append(sd)
    for sid in order:
        out.extend(seen[sid])
    return out

