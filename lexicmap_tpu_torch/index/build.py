"""Index building pipeline.

Re-derivation of BuildIndex/buildAnIndex (ref: lexicmap/cmd/lib-index-build.go
:205-1909) as a vectorized, batch-oriented pipeline:

  parse genomes -> concatenate contigs with interval A's -> capture (mask)
  -> low-complexity filter -> desert filling -> suffix (reversed k-mer)
  dispatch -> columnar postings sort -> seed chunks + genome store.

Differences from the reference (by design, TPU-first):
- postings are accumulated as flat arrays and sorted once per batch
  (lexsort by mask, k-mer, emission order) instead of per-mask hash maps
  guarded by mutexes (ref: lib-index-build.go:638,825-879): the scatter
  becomes a deterministic sort, which is also the multi-host story
  (global sort / all-to-all of postings).
- the seed store is fixed-width columnar (see index/store.py).
"""

from __future__ import annotations

import os
import re
import shutil
from dataclasses import dataclass, field

import numpy as np

from ..constants import (
    BITS_GENOME_IDX,
    BITS_NONE_IDX,
    MASK_NONE_IDX,
    MAX_GENOME_SIZE,
    IndexDefaults,
)
from ..masks import MaskSet
from ..ops.masking import capture, find_gap_regions, skip_mask_from_regions
from ..utils.fasta import genome_id_from_filename, read_fastx
from ..utils.kmers import (
    homopolymer_codes,
    is_low_complexity_dust,
    kmers_fwd_rc,
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
    GenomeStoreWriter,
    IndexInfo,
    SeedChunkWriter,
    batch_dir,
    chunk_dir,
    write_genome_chunks,
    write_genome_map,
)


@dataclass
class BuildOptions:
    k: int = IndexDefaults.K
    n_masks: int = IndexDefaults.MASKS
    rand_seed: int = IndexDefaults.RAND_SEED
    mask_file: str | None = None
    batch_size: int = IndexDefaults.BATCH_SIZE
    chunks: int = 0  # 0 -> min(cpus, 128)
    partitions: int = IndexDefaults.PARTITIONS
    max_genome_size: int = IndexDefaults.MAX_GENOME_SIZE
    min_seq_len: int = -1
    contig_interval: int = IndexDefaults.CONTIG_INTERVAL
    seed_max_desert: int = IndexDefaults.SEED_MAX_DESERT
    seed_in_desert_dist: int = IndexDefaults.SEED_IN_DESERT_DIST
    disable_desert_filling: bool = False
    # Desert-fill window capture candidacy: when True, a k-mer is a
    # candidate for mask m iff it shares m's DISTINCT prefix (the shortest
    # prefix unique to m among all masks — 7 or 8 bases for the default 20k
    # set; ref: lexichash MaskKnownDistinctPrefixes, lib-index-build.go:1196).
    # When False, candidacy requires a full distinct_prefix_len match.
    desert_capture_distinct: bool = False
    # Desert-fill window capture candidacy: when True, candidacy routes by
    # the mask GENERATION prefix length (7 for the default 20k set) and a
    # k-mer is capturable iff it wins the XOR-argmin for ANY mask sharing
    # that prefix (a duplicated-prefix pair both compete) — the lexichash
    # candidate-mask routing (cf. MaskKmer, lib-index-build.go:813) applied
    # to the window re-mask.  Mutually exclusive with
    # desert_capture_distinct; experiment knob for golden parity.
    desert_capture_group: bool = False
    max_kmer_freq: int = IndexDefaults.MAX_KMER_FREQ
    soft_masking: bool = False
    save_seed_pos: bool = False
    seq_name_filters: list[str] = field(default_factory=list)
    big_genome_file: str | None = None
    force: bool = False
    verbose: bool = False
    threads: int = 0  # 0 -> all CPUs
    # capture engine: "host" = native C++ trie co-descent; "device" = the
    # CUDA capture kernels (parallel/build_device.py), bit-exact, run
    # in-process (no fork workers: the device serializes capture anyway)
    engine: str = "host"
    # where the device capture runs: "cuda" (the default; raises without a
    # CUDA device) or "cpu" (the kernels' plain PyTorch twin)
    device: str = "cuda"

    @property
    def desert_seed_pos_range(self) -> int:
        # ref: index.go:329 (seedInDesertDist / 2)
        return self.seed_in_desert_dist // 2


# skipped-genome report reasons (ref: lib-index-build.go:459-466)
NO_VALID_SEQS = "no_valid_seqs"
TOO_LARGE_GENOME = "too_large_genome"
TOO_MANY_SEQS = "too_many_seqs"


@dataclass
class _GenomeChunk:
    """One indexed genome record (a whole genome, or one chunk of a big one)."""

    gid: bytes
    file_idx: int  # original input-file index (to group split chunks)
    codes: np.ndarray  # storage codes (degenerate->first base)
    seq_sizes: list[int]
    seq_ids: list[bytes]
    gap_regions: list[tuple[int, int]] = field(default_factory=list)  # N-runs >=5
    # with --soft-masking, lowercase bases are treated as A for seeding while
    # the real base is stored (ref: index.go --soft-masking documentation)
    seed_codes: np.ndarray | None = None

    @property
    def seeding_codes(self) -> np.ndarray:
        return self.seed_codes if self.seed_codes is not None else self.codes


def _parse_genome_file(
    path: str, file_idx: int, opt: BuildOptions, skipped: list[tuple[str, str]]
) -> list[_GenomeChunk]:
    """Parse one genome file into one or more concatenated chunks
    (ref: lib-index-build.go:1492-1766)."""
    k = opt.k
    min_seq_len = max(opt.min_seq_len if opt.min_seq_len > 0 else k, k)
    interval = opt.contig_interval
    exclude_res = [re.compile(p.encode()) for p in opt.seq_name_filters]
    gid = genome_id_from_filename(path).encode()[:65535]

    chunks: list[_GenomeChunk] = []
    parts: list[bytes] = []
    seq_sizes: list[int] = []
    seq_ids: list[bytes] = []
    cur_len = 0

    def flush():
        nonlocal parts, seq_sizes, seq_ids, cur_len
        if cur_len > 0:
            seq = (b"A" * interval).join(parts)
            seed_codes = None
            if opt.soft_masking:
                arr = np.frombuffer(seq, dtype=np.uint8)
                lower = (arr >= ord("a")) & (arr <= ord("z"))
                sc = seq_to_codes(seq).copy()
                sc[lower] = 0  # treated as A, not seeded distinctly
                seed_codes = sc
            chunks.append(
                _GenomeChunk(
                    gid=gid,
                    file_idx=file_idx,
                    codes=seq_to_codes(seq),
                    seq_sizes=seq_sizes,
                    seq_ids=seq_ids,
                    gap_regions=find_gap_regions(seq),
                    seed_codes=seed_codes,
                )
            )
        parts, seq_sizes, seq_ids, cur_len = [], [], [], 0

    for rec in read_fastx(path):
        if len(rec.seq) < min_seq_len:
            continue
        if exclude_res and any(r.search(rec.desc) for r in exclude_res):
            continue
        if len(rec.seq) > opt.max_genome_size:
            skipped.append((path, TOO_LARGE_GENOME))
            return []
        add = len(rec.seq) + (interval if cur_len > 0 else 0)
        if cur_len + add > opt.max_genome_size:
            flush()
            add = len(rec.seq)
        parts.append(rec.seq)
        seq_sizes.append(len(rec.seq))
        seq_ids.append(rec.id[:65535])
        cur_len += add
        if cur_len > MAX_GENOME_SIZE:
            skipped.append((path, TOO_MANY_SEQS))
            return []
    flush()
    if not chunks:
        skipped.append((path, NO_VALID_SEQS))
    return chunks


# --------------------------------------------------------------------------
# per-genome seeding


def _skip_regions_for(g: _GenomeChunk, k: int, interval: int):
    """Contig-junction intervals + N-gap runs (ref: lib-index-build.go:968-1014).

    Returns (skip_regions, interval_excluded) where interval_excluded is a
    bool array over positions used by desert filling's point queries.
    """
    regions: list[tuple[int, int]] = []
    if len(g.seq_sizes) > 1:
        n = 0
        for i, s in enumerate(g.seq_sizes):
            if i > 0:
                regions.append((n, n + interval - 1))
                n += interval
            n += s
    if g.gap_regions:
        regions.extend(g.gap_regions)
        regions.sort()
    L = g.codes.shape[0]
    interval_excluded = skip_mask_from_regions(L, k, regions) if regions else None
    return regions, interval_excluded


def seed_genome(
    mask_set: MaskSet,
    g: _GenomeChunk,
    opt: BuildOptions,
):
    """Capture + low-complexity filter + desert filling for one genome chunk.

    Returns (cap_kmers[m], cap_result, extras, locs) where extras is a list of
    (mask_idx, kmer, loc) and locs the sorted seed locations (pos<<1|strand).
    """
    k = mask_set.k
    regions, interval_excluded = _skip_regions_for(g, k, opt.contig_interval)
    scodes = g.seeding_codes
    fwd, rc = kmers_fwd_rc(scodes, k)

    from ..native import capture_native_call
    from ..ops.masking import CaptureResult

    exclude = None
    if regions:
        exclude = skip_mask_from_regions(scodes.shape[0], k, regions)
    native = None
    # a mask set beyond the kernels' key width, or a genome shorter than k
    # (capture returns None), takes the host capture; any other error of
    # the device capture propagates
    if opt.engine == "device":
        from ..parallel.build_device import DeviceCaptureEngine

        if DeviceCaptureEngine.supported(mask_set):
            native = _device_capture(mask_set, opt.device).capture(scodes, exclude)
    if native is None:
        native = capture_native_call(
            fwd, rc, exclude, mask_set.masks, k, mask_set.distinct_prefix_len, False
        )
    if native is not None:
        kmers_out, counts, pos_flat = native
        offsets = np.zeros(mask_set.m + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        res = CaptureResult(kmers=kmers_out, pos_flat=pos_flat, pos_offsets=offsets)
    else:
        res = capture(
            mask_set, scodes, skip_regions=regions, check_shorter_prefix=True,
            precomputed=(fwd, rc),
        )

    # remove low-complexity captured k-mers (ref: lib-index-build.go:1031-1044)
    ccc, ggg, ttt = homopolymer_codes(k)[1:]
    bad = (
        (res.kmers == ccc)
        | (res.kmers == ggg)
        | (res.kmers == ttt)
        | is_low_complexity_dust(res.kmers, k)
    )
    res.kmers[bad] = 0
    # zero out their position lists
    if bad.any():
        keep_counts = np.where(bad, 0, res.n_positions())
        new_off = np.zeros(mask_set.m + 1, dtype=np.int64)
        np.cumsum(keep_counts, out=new_off[1:])
        new_flat = np.empty(new_off[-1], dtype=np.uint32)
        for i in np.nonzero(~bad)[0]:
            new_flat[new_off[i] : new_off[i + 1]] = res.positions(i)
        res.pos_flat = new_flat
        res.pos_offsets = new_off

    locs = np.sort(res.pos_flat.astype(np.uint32))

    extras: list[tuple[int, int, int]] = []
    if not opt.disable_desert_filling:
        from ..native import fill_deserts_native_call

        extras = fill_deserts_native_call(
            fwd, rc, locs, interval_excluded, mask_set.masks, k,
            mask_set.distinct_prefix_len, opt.seed_max_desert, opt.seed_in_desert_dist,
            opt.desert_seed_pos_range,
            flags=(2 if opt.desert_capture_distinct else 0)
            | (4 if opt.desert_capture_group else 0),
        )
        if extras is None:
            extras = fill_deserts(mask_set, fwd, rc, locs, interval_excluded, opt)

    return res, extras, locs, regions


def _dust_scalar(x: int, k: int) -> bool:
    """Scalar DUST check (same semantics as utils.kmers.is_low_complexity_dust)."""
    counts: dict[int, int] = {}
    score = 0
    for i in range(k - 1):
        t = (x >> (2 * i)) & 63
        c = counts.get(t, 0)
        score += c
        counts[t] = c + 1
        if score > 50:
            return True
    return False


class _DesertWindow:
    """Lazy capturability checks inside one desert window.

    Instead of materializing the full position->mask capture maps for the
    window (the reference's loc2maskidx, ref: lib-index-build.go:1215-1229),
    capturability is decided per scanned position: k-mer x is captured by
    mask m iff they share m's full DISTINCT prefix (distinct_prefix_len
    bases; the regional capture runs with checkShorterPrefix=false, ref:
    lib-index-build.go:1196) and x is the argmin of (y XOR m) over the
    window k-mers y sharing that prefix.  Distinct prefixes are unique per
    mask, so at most one mask can capture a given k-mer.
    """

    def __init__(
        self, mask_set: MaskSet, wf: np.ndarray, wr: np.ndarray,
        distinct: bool = False,
        group: bool = False,
    ):
        """wf/wr are ALL window k-mers including interval/gap positions: the
        reference's regional re-mask passes skipRegions=nil over the
        'A'-filled concatenation (ref: lib-index-build.go:924,1196), so
        junction k-mers compete for capture; they are only skipped at
        selection time via the interval tree (pos_ok)."""
        self.ms = mask_set
        self.k = mask_set.k
        self.p = mask_set.distinct_prefix_len
        self.distinct = distinct
        self.group = group
        self.shift = np.uint64(2 * (self.k - self.p))
        self.sorted_w = np.sort(np.concatenate([wf, wr]))
        # sorted mask L-prefixes (no 4^L table: L can be large for
        # text-loaded mask sets)
        self.mask_prefs = (mask_set.masks >> self.shift).astype(np.uint64)
        if distinct:
            self.dlen = mask_set.distinct_prefix_lens()
            self.dlen_values = sorted(set(self.dlen.tolist()))
        if group:
            gl = 1
            while 4 ** (gl + 1) <= mask_set.m:
                gl += 1
            self.group_len = min(gl, self.p)

    def _wins_bucket(self, x: int, j: int, L: int) -> bool:
        """Is x the XOR-argmin among window k-mers sharing mask j's L-prefix?"""
        shift = np.uint64(2 * (self.k - L))
        m = np.uint64(self.ms.masks[j])
        lo_val = (m >> shift) << shift
        hi_val = lo_val | ((np.uint64(1) << shift) - np.uint64(1))
        lo = int(np.searchsorted(self.sorted_w, lo_val, side="left"))
        hi = int(np.searchsorted(self.sorted_w, hi_val, side="right"))
        bucket = self.sorted_w[lo:hi]
        if bucket.shape[0] == 0:
            return False
        xors = bucket ^ m
        return bool(bucket[int(np.argmin(xors))] == np.uint64(x))

    def capturing_mask(self, x: int) -> int:
        """Index of the (unique) mask capturing k-mer x here, or -1."""
        if self.distinct:
            # at most one mask's distinct prefix can match x
            for L in self.dlen_values:
                shift = np.uint64(2 * (self.k - L))
                xp = np.uint64(x) >> shift
                mp = self.ms.masks >> shift
                mlo = int(np.searchsorted(mp, xp, side="left"))
                mhi = int(np.searchsorted(mp, xp, side="right"))
                for j in range(mhi - 1, mlo - 1, -1):
                    if self.dlen[j] != L:
                        continue
                    if self._wins_bucket(x, j, L):
                        return j
            return -1
        if self.group:
            L = self.group_len
            shift = np.uint64(2 * (self.k - L))
            xp = np.uint64(x) >> shift
            mp = self.ms.masks >> shift
            mlo = int(np.searchsorted(mp, xp, side="left"))
            mhi = int(np.searchsorted(mp, xp, side="right"))
            for j in range(mhi - 1, mlo - 1, -1):  # highest mask wins
                if self._wins_bucket(x, j, L):
                    return j
            return -1
        pref = np.uint64(x >> (2 * (self.k - self.p)))
        mlo = int(np.searchsorted(self.mask_prefs, pref, side="left"))
        mhi = int(np.searchsorted(self.mask_prefs, pref, side="right"))
        if mhi <= mlo:
            return -1
        lo_val = pref << self.shift
        hi_val = lo_val | ((np.uint64(1) << self.shift) - np.uint64(1))
        lo = int(np.searchsorted(self.sorted_w, lo_val, side="left"))
        hi = int(np.searchsorted(self.sorted_w, hi_val, side="right"))
        bucket = self.sorted_w[lo:hi]
        cands = self.ms.masks[mlo:mhi]
        xors = bucket[None, :] ^ cands[:, None]
        winners = bucket[np.argmin(xors, axis=1)]
        capt = np.nonzero(winners == np.uint64(x))[0]
        if capt.shape[0] == 0:
            return -1
        return mlo + int(capt[-1])


def fill_deserts(
    mask_set: MaskSet,
    fwd: np.ndarray,
    rc: np.ndarray,
    locs: np.ndarray,
    interval_excluded: np.ndarray | None,
    opt: BuildOptions,
) -> list[tuple[int, int, int]]:
    """Fill sketching deserts (ref: lib-index-build.go:1084-1405).

    Scans the sorted seed locations; for every gap >= seed_max_desert, the
    +-1000 bp region is re-masked (prefix-restricted capture) and roughly
    every seed_in_desert_dist bases the nearest capturable, non-low-complexity
    k-mer (either strand) is added as an extra seed of its capturing mask.

    fwd/rc are the genome-wide k-mer arrays (both strands, every position).
    """
    k = mask_set.k
    nk = fwd.shape[0]  # number of k-mer positions = L - k + 1
    L = nk + k - 1
    max_desert = opt.seed_max_desert
    seed_dist = opt.seed_in_desert_dist
    seed_pos_r = opt.desert_seed_pos_range
    ccc, ggg, ttt = homopolymer_codes(k)[1:]

    extras: list[tuple[int, int, int]] = []
    if nk <= 0:
        return extras

    def pos_ok(gp: int) -> bool:
        """Position not in an interval/gap region and within k-mer range."""
        if gp >= nk:
            return False
        if interval_excluded is not None and gp < interval_excluded.shape[0]:
            return not bool(interval_excluded[gp])
        return True

    dust_cache: dict[int, bool] = {}

    def kmer_ok(x: int) -> bool:
        if x == 0 or x == ccc or x == ggg or x == ttt:
            return False
        v = dust_cache.get(x)
        if v is None:
            v = _dust_scalar(x, k)
            dust_cache[x] = v
        return not v

    pre = 0
    locs_aug = np.concatenate([locs, np.array([(L - k) << 1], dtype=np.uint32)])
    for pos2str in locs_aug:
        pos = int(pos2str) >> 1
        d = pos - pre
        if d < max_desert:
            pre = pos
            continue

        start = pre - 1000
        pos_of_pre = 1000
        if start < 0:
            pos_of_pre += start
            start = 0
        end = min(pos + 1000 + k, L)
        nw = end - start - k + 1
        if nw <= 0:
            pre = pos
            continue
        pos_of_cur = pos_of_pre + d

        wf = fwd[start : start + nw]
        wr = rc[start : start + nw]
        win = _DesertWindow(
            mask_set, wf, wr,
            distinct=opt.desert_capture_distinct,
            group=opt.desert_capture_group,
        )

        def try_pos(_j: int):
            """Returns (mask_idx, kmer, loc) or None."""
            gp = start + _j
            if _j >= nw or not pos_ok(gp):
                return None
            xf = int(fwd[gp])
            if kmer_ok(xf):
                im = win.capturing_mask(xf)
                if im >= 0:
                    return (im, xf, gp << 1)
            xr = int(rc[gp])
            if kmer_ok(xr):
                im = win.capturing_mask(xr)
                if im >= 0:
                    return (im, xr, (gp << 1) | 1)
            return None

        _j = pos_of_pre + seed_dist
        while _j < pos_of_cur:
            _start = _j + 1
            _end_up = _j - seed_pos_r
            hit = None
            # upstream scan
            while _j > _end_up:
                hit = try_pos(_j)
                if hit is not None:
                    break
                _j -= 1
            if hit is not None:
                extras.append(hit)
                _j += seed_dist
                continue
            if _start >= pos_of_cur:
                break
            # downstream scan
            _end_dn = min(_start + seed_pos_r, pos_of_cur - 1)
            _j = _start
            while _j < _end_dn:
                hit = try_pos(_j)
                if hit is not None:
                    break
                _j += 1
            if hit is not None:
                extras.append(hit)
            _j += seed_dist

        pre = pos
    return extras


# --------------------------------------------------------------------------
# batch building


class _PostingsAccumulator:
    def __init__(self):
        self.mask_ids: list[np.ndarray] = []
        self.kmers: list[np.ndarray] = []
        self.values: list[np.ndarray] = []
        self.orders: list[np.ndarray] = []

    def add(self, mask_ids, kmers, values, orders):
        if len(mask_ids):
            self.mask_ids.append(np.asarray(mask_ids, dtype=np.int64))
            self.kmers.append(np.asarray(kmers, dtype=np.uint64))
            self.values.append(np.asarray(values, dtype=np.uint64))
            self.orders.append(np.asarray(orders, dtype=np.int64))

    def arrays(self):
        if not self.mask_ids:
            e = np.empty(0, dtype=np.int64)
            return e, np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.uint64), e
        return (
            np.concatenate(self.mask_ids),
            np.concatenate(self.kmers),
            np.concatenate(self.values),
            np.concatenate(self.orders),
        )


def _emit_postings(
    mask_set: MaskSet,
    res,
    extras: list[tuple[int, int, int]],
    batch: int,
    genome_idx: int,
    genome_rank: int,
    acc: _PostingsAccumulator,
    max_kmer_freq: int,
) -> None:
    """Emit forward + reversed (suffix-index) postings of one genome
    (ref: lib-index-build.go:668-890)."""
    m = mask_set.m
    k = mask_set.k
    idx_shift = np.uint64((batch << BITS_GENOME_IDX | genome_idx) << BITS_NONE_IDX)

    counts = res.n_positions()
    has = (res.kmers != 0) & (counts > 0)
    sel = np.nonzero(has)[0]
    # forward captured
    mask_ids = np.repeat(sel, counts[sel])
    kmers = np.repeat(res.kmers[sel], counts[sel])
    locs = np.concatenate([res.positions(i) for i in sel]) if sel.shape[0] else np.empty(0, np.uint32)
    fwd_vals = idx_shift | ((locs.astype(np.uint64) << np.uint64(1)) & np.uint64(MASK_NONE_IDX))
    base = np.int64(genome_rank) << np.int64(34)
    n0 = mask_ids.shape[0]
    acc.add(mask_ids, kmers, fwd_vals, base + np.arange(n0))

    # forward extras.  NOTE: the --max-kmer-freq filter applies to the
    # FORWARD extras only — the reference's reversed pass iterates the raw
    # extra list without the frequency counter (ref: lib-index-build.go:
    # 737-750 vs 845-888), so the reversed dispatch below must use the
    # UNFILTERED extras.
    if extras:
        e_masks = np.array([e[0] for e in extras], dtype=np.int64)
        e_kmers = np.array([e[1] for e in extras], dtype=np.uint64)
        e_locs = np.array([e[2] for e in extras], dtype=np.uint64)
        f_masks, f_kmers, f_locs = e_masks, e_kmers, e_locs
        if max_kmer_freq > 0:
            keep = _filter_kmer_freq(e_masks, e_kmers, max_kmer_freq)
            f_masks, f_kmers, f_locs = e_masks[keep], e_kmers[keep], e_locs[keep]
        e_vals = idx_shift | ((f_locs << np.uint64(1)) & np.uint64(MASK_NONE_IDX))
        n1 = f_masks.shape[0]
        acc.add(f_masks, f_kmers, e_vals, base + (np.int64(1) << 32) + np.arange(n1))
    else:
        e_masks = np.empty(0, dtype=np.int64)
        e_kmers = np.empty(0, dtype=np.uint64)
        e_locs = np.empty(0, dtype=np.uint64)

    # reversed k-mers -> the mask sharing the longest prefix (suffix index)
    all_kmers = np.concatenate([res.kmers[sel], e_kmers])
    all_locs_list = [locs, e_locs.astype(np.uint32)]
    # positions per entry: captured entries have [counts] locs, extras have 1
    rev_counts = np.concatenate([counts[sel], np.ones(e_kmers.shape[0], dtype=np.int64)])
    if all_kmers.shape[0]:
        rkmers = reverse_kmers(all_kmers, k)
        new_masks = mask_set.nearest_mask(rkmers)
        r_mask_ids = np.repeat(new_masks, rev_counts)
        r_kmers = np.repeat(rkmers, rev_counts)
        r_locs = np.concatenate(all_locs_list).astype(np.uint64)
        r_vals = idx_shift | (((r_locs << np.uint64(1)) | np.uint64(1)) & np.uint64(MASK_NONE_IDX))
        n2 = r_mask_ids.shape[0]
        acc.add(r_mask_ids, r_kmers, r_vals, base + (np.int64(2) << 32) + np.arange(n2))


def _filter_kmer_freq(masks: np.ndarray, kmers: np.ndarray, max_freq: int) -> np.ndarray:
    """Keep only the first max_freq occurrences of each (mask, kmer) pair
    (ref: lib-index-build.go:737-750)."""
    n = masks.shape[0]
    if n == 0:
        return np.ones(0, dtype=bool)
    # occurrence ordinal of each (mask, kmer) pair in original order:
    # stable-sort groups the pairs while preserving first-seen order inside
    # each group, so rank-within-group = arange - group_start
    order = np.lexsort((kmers, masks))  # stable: ties keep original order
    sm = masks[order]
    sk = kmers[order]
    new_grp = np.empty(n, dtype=bool)
    new_grp[0] = True
    new_grp[1:] = (sk[1:] != sk[:-1]) | (sm[1:] != sm[:-1])
    group_start = np.maximum.accumulate(np.where(new_grp, np.arange(n), 0))
    rank = np.arange(n) - group_start
    keep = np.empty(n, dtype=bool)
    keep[order] = rank < max_freq
    return keep


def _seed_positions_with_flags(
    locs: np.ndarray, extras: list[tuple[int, int, int]], regions: list[tuple[int, int]]
) -> np.ndarray:
    """Sorted seed locations with the interval flag in the low bit
    (ref: lib-index-build.go:1407-1467): the first position at or after each
    skip-region end is flagged, so seed pairs crossing contig junctions can
    be skipped by `utils seed-pos` consumers."""
    all_locs = locs
    if extras:
        e = np.array([x[2] for x in extras], dtype=np.uint32)
        all_locs = np.sort(np.concatenate([locs, e]))
    out = all_locs.astype(np.uint64) << np.uint64(1)
    if regions:
        pos = (all_locs >> np.uint32(1)).astype(np.int64)
        for _s, e in regions:
            i = int(np.searchsorted(pos, e, side="left"))
            if i < out.shape[0]:
                out[i] |= np.uint64(1)
    return out.astype(np.uint32)


# lazy per-mask-set device capture engine (build --engine device)
_DEVICE_CAPTURE = None


def _device_capture(mask_set, device):
    global _DEVICE_CAPTURE
    from ..parallel import resolve_device
    from ..parallel.build_device import DeviceCaptureEngine

    dev = resolve_device(device)
    if (_DEVICE_CAPTURE is None or _DEVICE_CAPTURE.ms is not mask_set
            or _DEVICE_CAPTURE.device != dev):
        _DEVICE_CAPTURE = DeviceCaptureEngine(mask_set, device=dev)
    return _DEVICE_CAPTURE


# worker-pool state inherited across fork() for parallel genome seeding
_SEED_CTX = None


def _seed_worker(args):
    path, file_idx = args
    mask_set, opt = _SEED_CTX
    skipped: list[tuple[str, str]] = []
    out = []
    for g in _parse_genome_file(path, file_idx, opt, skipped):
        res, extras, locs, regions = seed_genome(mask_set, g, opt)
        out.append((g, res, extras, locs, regions))
    return out, skipped


def _iter_seeded_genomes(mask_set, batch, files, opt, skipped):
    """Yield (genome_chunk, capture, extras, locs, regions) per genome,
    parsing+seeding in a fork worker pool when multiple CPUs are available
    (the analog of the reference's stage-1 goroutines,
    ref: lib-index-build.go:929-1491)."""
    n_workers = min(os.cpu_count() or 1, opt.threads if opt.threads > 0 else 64)
    if opt.engine == "device":
        n_workers = 1  # device capture runs in-process (a forked worker cannot use CUDA)
    items = [(path, batch * opt.batch_size + fi) for fi, path in enumerate(files)]
    if n_workers <= 1 or len(files) <= 1:
        for path, file_idx in items:
            for g in _parse_genome_file(path, file_idx, opt, skipped):
                yield (g, *seed_genome(mask_set, g, opt))
        return

    import multiprocessing as mp

    global _SEED_CTX
    _SEED_CTX = (mask_set, opt)
    ctx = mp.get_context("fork")
    with ctx.Pool(n_workers) as pool:
        for out, wskipped in pool.imap(_seed_worker, items):
            skipped.extend(wskipped)
            yield from out


def _build_one_batch(
    mask_set: MaskSet,
    batch: int,
    files: list[str],
    base_outdir: str,
    seeds_outdir: str,
    n_chunks: int,
    opt: BuildOptions,
    skipped: list[tuple[str, str]],
):
    """Build one batch: genome store under base_outdir, seed chunks under
    seeds_outdir, plus the batch's genome map and chunk lists."""
    m = mask_set.m
    chunk_size = (m + n_chunks - 1) // n_chunks
    acc = _PostingsAccumulator()
    gw = GenomeStoreWriter(os.path.join(base_outdir, DIR_GENOMES, batch_dir(batch)), batch)
    genome_map_entries: list[tuple[bytes, int]] = []
    file_chunk_lists: dict[int, list[int]] = {}
    total_bases = 0
    n_genomes = 0
    genome_rank = 0
    seed_pos: list[np.ndarray] = []
    for g, res, extras, locs, regions in _iter_seeded_genomes(
        mask_set, batch, files, opt, skipped
    ):
        gidx = gw.write(g.gid, g.codes, g.seq_sizes, g.seq_ids)
        _emit_postings(
            mask_set, res, extras, batch, gidx, genome_rank, acc, opt.max_kmer_freq
        )
        if opt.save_seed_pos:
            seed_pos.append(_seed_positions_with_flags(locs, extras, regions))
        code = batch << BITS_GENOME_IDX | gidx
        genome_map_entries.append((g.gid, code))
        file_chunk_lists.setdefault(g.file_idx, []).append(code)
        total_bases += sum(g.seq_sizes)
        n_genomes += 1
        genome_rank += 1
        if opt.verbose:
            print(f"  [batch {batch}] indexed {g.gid.decode()} ({sum(g.seq_sizes)} bp)")
    gw.close()
    if opt.save_seed_pos:
        gdir = os.path.join(base_outdir, DIR_GENOMES, batch_dir(batch))
        flat = np.concatenate(seed_pos) if seed_pos else np.empty(0, dtype=np.uint32)
        off = np.zeros(len(seed_pos) + 1, dtype=np.int64)
        np.cumsum([p.shape[0] for p in seed_pos], out=off[1:])
        np.save(os.path.join(gdir, "seed_positions.npy"), flat)
        np.save(os.path.join(gdir, "seed_positions_offsets.npy"), off)

    # write this batch's seed chunks
    mask_ids, kmers, values, orders = acc.arrays()
    for c in range(n_chunks):
        begin = c * chunk_size
        end = min(begin + chunk_size, m)
        in_chunk = (mask_ids >= begin) & (mask_ids < end)
        w = SeedChunkWriter(os.path.join(seeds_outdir, DIR_SEEDS, chunk_dir(c)), begin, end)
        w.write(mask_ids[in_chunk], kmers[in_chunk], values[in_chunk], orders[in_chunk])

    write_genome_map(os.path.join(seeds_outdir, FILE_GENOME_MAP), genome_map_entries)
    write_genome_chunks(
        os.path.join(seeds_outdir, FILE_GENOME_CHUNKS),
        [v for v in file_chunk_lists.values() if len(v) > 1],
    )
    return total_bases, n_genomes, len(file_chunk_lists)


def build_index(outdir: str, infiles: list[str], opt: BuildOptions) -> IndexInfo:
    if opt.engine == "device":
        from ..parallel import resolve_device

        resolve_device(opt.device)  # no CUDA device for device="cuda": raise before any work
    if os.path.exists(outdir):
        if opt.force:
            shutil.rmtree(outdir)
        elif os.listdir(outdir):
            raise FileExistsError(f"output dir not empty: {outdir} (use force)")
    os.makedirs(outdir, exist_ok=True)

    # masks
    if opt.mask_file:
        mask_set = MaskSet.load_text(opt.mask_file)
        opt.k = mask_set.k
    else:
        mask_set = MaskSet.generate(opt.k, opt.n_masks, opt.rand_seed)
    mask_set.save(os.path.join(outdir, FILE_MASKS))
    m = mask_set.m

    n_chunks = opt.chunks if opt.chunks > 0 else min(os.cpu_count() or 1, 128)
    n_chunks = min(n_chunks, m)

    skipped: list[tuple[str, str]] = []
    n_batches = (len(infiles) + opt.batch_size - 1) // opt.batch_size
    tmp_dir = outdir.rstrip("/") + ".tmp"
    if n_batches > 1:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        os.makedirs(tmp_dir, exist_ok=True)

    total_bases = 0
    n_genomes = 0
    n_input = 0
    for batch in range(n_batches):
        files = infiles[batch * opt.batch_size : (batch + 1) * opt.batch_size]
        seeds_outdir = (
            outdir if n_batches == 1 else os.path.join(tmp_dir, batch_dir(batch))
        )
        os.makedirs(seeds_outdir, exist_ok=True)
        tb, ng, ni = _build_one_batch(
            mask_set, batch, files, outdir, seeds_outdir, n_chunks, opt, skipped
        )
        total_bases += tb
        n_genomes += ng
        n_input += ni

    info = IndexInfo(
        k=opt.k,
        masks=m,
        rand_seed=opt.rand_seed,
        max_desert=opt.seed_max_desert,
        seed_dist_in_desert=opt.seed_in_desert_dist,
        chunks=n_chunks,
        partitions=opt.partitions,
        input_genomes=n_input,
        input_bases=total_bases,
        genomes=n_genomes,
        genome_batch_size=opt.batch_size,
        genome_batches=n_batches,
        contig_interval=opt.contig_interval,
        soft_masking=opt.soft_masking,
        max_kmer_freq=opt.max_kmer_freq,
    )
    info.save(os.path.join(outdir, FILE_INFO))

    if n_batches > 1:
        import json

        with open(os.path.join(tmp_dir, "merge_meta.json"), "w") as fh:
            json.dump({"chunks": n_chunks, "info_updates": {}}, fh)
        from .merge import merge_batches

        merge_batches(tmp_dir, outdir, n_chunks)
        shutil.rmtree(tmp_dir)

    if opt.big_genome_file and skipped:
        with open(opt.big_genome_file, "w") as fh:
            for path, reason in skipped:
                fh.write(f"{path}\t{reason}\n")

    return info
