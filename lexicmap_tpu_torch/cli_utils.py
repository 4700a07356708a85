"""`lexicmap-tpu-torch utils` subcommands, and the helpers that the port's
other CLI families share.

The subcommands mirror the reference's utils command family (ref:
lexicmap/cmd/masks.go, kmers.go, genomes.go, genome-seqs.go,
genome-details.go, subseq.go, merge-search-results.go, edit-genome-ids.go,
recount-bases.go, reindex-seeds.go, re-merge.go, seed-pos.go, 2blast.go,
2sam.go) with the same output formats; `import-index` / `export-index`
convert to and from the reference's .lmi layout (`index/convert.py`).  All
of them are host code.  `_open_out` is also used by `cli_genome.py`, and
`no_cuda` is the one refusal of a device stage without a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

import numpy as np

from .constants import BITS_GENOME_IDX, BITS_IDX, BITS_IDX_FLAGS, BITS_NONE_IDX


def _open_out(path):
    import gzip

    if not path or path == "-":
        return sys.stdout, False
    if path.endswith(".gz"):
        return gzip.open(path, "wt"), True
    return open(path, "w"), True


def no_cuda(instead: str) -> bool:
    """True, after printing why, when no CUDA device is present: a command
    asked to run a device stage on the card then exits 1 rather than fall
    back to the CPU on its own.  `instead` names the flags that run the
    command without the card."""
    import torch

    if torch.cuda.is_available():
        return False
    print(f"error: no CUDA device is available; pass --device cpu to {instead}",
          file=sys.stderr)
    return True


def _load_index_parts(db):
    from .index.store import (
        DIR_GENOMES,
        FILE_GENOME_MAP,
        FILE_INFO,
        GenomeStoreReader,
        IndexInfo,
        batch_dir,
        read_genome_map,
    )

    info = IndexInfo.load(os.path.join(db, FILE_INFO))
    stores = [
        GenomeStoreReader(os.path.join(db, DIR_GENOMES, batch_dir(b)))
        for b in range(info.genome_batches)
    ]
    gmap = read_genome_map(os.path.join(db, FILE_GENOME_MAP))
    return info, stores, gmap


# --------------------------------------------------------------------------


def cmd_utils_masks(args) -> int:
    """View index masks or generate new ones (ref: masks.go:37-143)."""
    from .masks import MaskSet
    from .utils.kmers import decode_kmer

    out, own = _open_out(args.out_file)
    if args.index:
        ms = MaskSet.load(os.path.join(args.index, "masks.bin"))
    else:
        ms = MaskSet.generate(args.kmer, args.masks, args.seed, args.prefix)
    if args.mask > 0:
        out.write(f"{args.mask}\t{decode_kmer(int(ms.masks[args.mask - 1]), ms.k)}\n")
    else:
        for i, code in enumerate(ms.masks):
            out.write(f"{i + 1}\t{decode_kmer(int(code), ms.k)}\n")
    if own:
        out.close()
    return 0


def cmd_utils_kmers(args) -> int:
    """Dump seeds of one mask: mask, kmer, prefix, number, ref, pos, strand,
    reversed (ref: kmers.go:144,354)."""
    from .index.store import DIR_SEEDS, SeedChunkReader, chunk_dir
    from .masks import MaskSet
    from .utils.kmers import decode_kmer, kmer_lcp

    db = args.index
    info, stores, gmap = _load_index_parts(db)
    ms = MaskSet.load(os.path.join(db, "masks.bin"))
    id_of = {code: gid for gid, code in gmap}
    mask_idx = args.mask - 1  # 1-based
    out, own = _open_out(args.out_file)
    out.write("mask\tkmer\tprefix\tnumber\tref\tpos\tstrand\treversed\n")
    seeds_dir = os.path.join(db, DIR_SEEDS)
    for name in sorted(os.listdir(seeds_dir)):
        rdr = SeedChunkReader(os.path.join(seeds_dir, name))
        if not (rdr.mask_begin <= mask_idx < rdr.mask_end):
            continue
        rel = mask_idx - rdr.mask_begin
        e0, e1 = int(rdr.mask_offsets[rel]), int(rdr.mask_offsets[rel + 1])
        mask_code = np.uint64(ms.masks[mask_idx])
        for e in range(e0, e1):
            kmer = int(rdr.kmers[e])
            vals = rdr.values[rdr.entry_offsets[e] : rdr.entry_offsets[e + 1]]
            prefix = int(kmer_lcp(np.array([kmer], dtype=np.uint64), mask_code, info.k)[0])
            for v in np.asarray(vals):
                v = int(v)
                code = v >> BITS_NONE_IDX
                pos = (v << BITS_IDX) % (1 << 64) >> BITS_IDX_FLAGS
                strand = "-" if (v >> 1) & 1 else "+"
                rev = "yes" if v & 1 else "no"
                if args.only_forward and rev == "yes":
                    continue
                out.write(
                    f"{args.mask}\t{decode_kmer(kmer, info.k)}\t{prefix}\t"
                    f"{len(vals)}\t{id_of.get(code, b'?').decode()}\t{pos + 1}\t{strand}\t{rev}\n"
                )
    if own:
        out.close()
    return 0


def cmd_utils_genomes(args) -> int:
    """(ref: genomes.go)"""
    info, stores, gmap = _load_index_parts(args.index)
    out, own = _open_out(args.out_file)
    for gid, code in gmap:
        if args.extra:
            b = code >> BITS_GENOME_IDX
            gi = code & ((1 << BITS_GENOME_IDX) - 1)
            st = stores[b]
            out.write(
                f"{gid.decode()}\t{st.gsizes[gi]}\t"
                f"{int(st.ss_off[gi + 1] - st.ss_off[gi])}\n"
            )
        else:
            out.write(gid.decode() + "\n")
    if own:
        out.close()
    return 0


def cmd_utils_genome_seqs(args) -> int:
    """Dump a genome's sequences as FASTA (ref: genome-seqs.go)."""
    from .utils.fasta import write_fasta
    from .utils.kmers import codes_to_seq

    info, stores, gmap = _load_index_parts(args.index)
    name2code = {gid.decode(): code for gid, code in gmap}
    wanted = args.ref_name
    if wanted not in name2code:
        print(f"genome not found: {wanted}", file=sys.stderr)
        return 1
    code = name2code[wanted]
    b = code >> BITS_GENOME_IDX
    gi = code & ((1 << BITS_GENOME_IDX) - 1)
    st = stores[b]
    sizes = st.seq_sizes(gi)
    seq_ids = st.seq_ids[gi]
    out, own = _open_out(args.out_file)
    pos = 0
    outb = out.buffer if hasattr(out, "buffer") else out
    for sid, size in zip(seq_ids, sizes):
        codes = st.subseq_codes(gi, pos, pos + size - 1)
        write_fasta(outb, sid, codes_to_seq(codes))
        pos += size + info.contig_interval
    if own:
        out.close()
    return 0


def cmd_utils_genome_details(args) -> int:
    """(ref: genome-details.go:518-646)"""
    from .index.store import FILE_GENOME_CHUNKS, read_genome_chunks

    info, stores, gmap = _load_index_parts(args.index)
    gchunks = read_genome_chunks(os.path.join(args.index, FILE_GENOME_CHUNKS))
    chunk_of = {}
    for lst in gchunks:
        for ci, code in enumerate(lst):
            chunk_of[code] = (len(lst), ci)
    out, own = _open_out(args.out_file)
    if args.more_columns:
        out.write("ref\tgenome_size\tchunks\tchunk\tcidx\tgidx\tchunk_size\tseqs\tseqsizes\tseqids\n")
    else:
        out.write("ref\tgenome_size\tchunks\tchunk\tcidx\tgidx\tchunk_size\tseqs\n")
    for gid, code in gmap:
        b = code >> BITS_GENOME_IDX
        gi = code & ((1 << BITS_GENOME_IDX) - 1)
        st = stores[b]
        nchunks, ci = chunk_of.get(code, (1, 0))
        sizes = st.seq_sizes(gi)
        row = (
            f"{gid.decode()}\t{int(st.gsizes[gi])}\t{nchunks}\t{ci + 1}\t{b}\t{gi}\t"
            f"{int(st.gsizes[gi])}\t{len(sizes)}"
        )
        if args.more_columns:
            row += "\t" + ",".join(str(s) for s in sizes)
            row += "\t" + ",".join(s.decode() for s in st.seq_ids[gi])
        out.write(row + "\n")
    if own:
        out.close()
    return 0


def cmd_utils_subseq(args) -> int:
    """Extract subsequences (ref: subseq.go:42-69).

    Output ID format: "seqid:begin-end:strand"."""
    from .utils.fasta import write_fasta
    from .utils.kmers import codes_to_seq, revcomp_seq

    info, stores, gmap = _load_index_parts(args.index)
    name2code = {gid.decode(): code for gid, code in gmap}
    out, own = _open_out(args.out_file)
    outb = out.buffer if hasattr(out, "buffer") else out

    def extract(ref, seqid, start, end, strand, meta=b""):
        # start/end are 1-based inclusive
        if ref not in name2code:
            raise KeyError(f"reference name not found: {ref}")
        code = name2code[ref]
        b = code >> BITS_GENOME_IDX
        gi = code & ((1 << BITS_GENOME_IDX) - 1)
        st = stores[b]
        offset = 0
        seq_len = None
        if seqid:
            sizes = st.seq_sizes(gi)
            ids = [s.decode() for s in st.seq_ids[gi]]
            if seqid not in ids:
                raise KeyError(f"sequence id not found: {seqid}")
            j = ids.index(seqid)
            offset = sum(sizes[:j]) + j * info.contig_interval
            seq_len = sizes[j]
        s0 = max(start - 1 - args.up_stream, 0)
        e0 = end - 1 + args.down_stream
        if seq_len is not None:
            e0 = min(e0, seq_len - 1)
        codes = st.subseq_codes(gi, offset + s0, offset + e0)
        seq = codes_to_seq(codes)
        if strand == "-":
            seq = revcomp_seq(seq)
        rid = f"{seqid or ref}:{s0 + 1}-{s0 + len(seq)}:{strand}".encode() + meta
        width = getattr(args, "line_width", 60) or 1 << 30
        write_fasta(outb, rid, seq, width=width)

    try:
        if args.tsv:
            import csv

            with open(args.tsv) as fh:
                rdr = csv.reader(fh, delimiter="\t")
                rows = list(rdr)
            start_row = 0 if args.no_header_row else 1
            for row in rows[start_row:]:
                if len(row) < 20:
                    continue
                ref, seqid = row[3], row[4]
                sstart, send, sstr = int(row[14]), int(row[15]), row[16]
                # rich header with the hit's columns (ref: subseq.go search-
                # result mode; see docs/content/tutorials/search.md:274)
                meta = (
                    f" query={row[0]} sgenome={ref} sseqid={seqid}"
                    f" qcovGnm={row[5]} cls={row[6]} hsp={row[7]}"
                    f" qcovHSP={row[8]} alenHSP={row[9]} pident={row[10]}"
                    f" gaps={row[11]} qstart={row[12]} qend={row[13]}"
                    f" sstart={row[14]} send={row[15]} sstr={row[16]}"
                    f" slen={row[17]} evalue={row[18]} bitscore={row[19]}"
                ).encode()
                try:
                    extract(ref, seqid, sstart, send, sstr, meta)
                except KeyError as exc:
                    if not args.ignore_err:
                        raise
                    print(str(exc), file=sys.stderr)
        else:
            if not args.region:
                print("flag -r/--region needed", file=sys.stderr)
                return 1
            # validate like the reference (ref: subseq.go:510-534)
            m = re.fullmatch(r"(\d+):(\d+|-1)", args.region)
            if not m:
                print(f"invalid region: {args.region}", file=sys.stderr)
                return 1
            start = int(m.group(1))
            end = 1 << 40 if m.group(2) == "-1" else int(m.group(2))
            if start <= 0 or end <= 0 and m.group(2) != "-1":
                print(f"region positions must be >= 1: {args.region}",
                      file=sys.stderr)
                return 1
            if end < start:
                print(f"region start > end: {args.region}", file=sys.stderr)
                return 1
            extract(args.ref_name, args.seq_id, start, end,
                    "-" if args.revcom else "+")
    except KeyError as exc:
        print(str(exc), file=sys.stderr)
        return 1
    finally:
        if own:
            out.close()
    return 0


def cmd_utils_merge_search_results(args) -> int:
    """k-way merge of per-index TSVs for one query
    (ref: merge-search-results.go:38-52)."""
    import gzip as _gz

    rows = []
    header = None
    files = list(args.files)
    if args.infile_list:
        with open(args.infile_list) as fh:
            files.extend(x.strip() for x in fh if x.strip())
    for path in files:
        op = _gz.open if path.endswith(".gz") else open
        with op(path, "rt") as fh:
            lines = [l.rstrip("\n") for l in fh if l.strip()]
        if not lines:
            continue
        if header is None:
            header = lines[0]
        for line in lines[1:]:
            rows.append(line.split("\t"))
    if header is None:
        return 0
    # filter by query if requested
    if args.query:
        rows = [r for r in rows if r[0] == args.query]
    # group by (query, sgenome); order groups by best bitscore*pident desc
    groups: dict[tuple[str, str], list[list[str]]] = {}
    for r in rows:
        groups.setdefault((r[0], r[3]), []).append(r)
    per_query: dict[str, list] = {}
    for (q, g), rs in groups.items():
        best = max(float(r[19]) * float(r[10]) for r in rs)
        per_query.setdefault(q, []).append((best, g, rs))
    out, own = _open_out(args.out_file)
    out.write(header + "\n")
    for q, gs in per_query.items():
        gs.sort(key=lambda t: -t[0])
        hits = len(gs)
        for _best, _g, rs in gs:
            j = 1
            for r in rs:
                r = list(r)
                r[2] = str(hits)
                r[7] = str(j)
                out.write("\t".join(r) + "\n")
                j += 1
    if own:
        out.close()
    return 0


def cmd_utils_edit_genome_ids(args) -> int:
    """Regexp-rewrite genome IDs in genomes.map.tsv (ref: edit-genome-ids.go)."""
    from .index.store import FILE_GENOME_MAP, read_genome_map, write_genome_map

    pattern = re.compile(args.pattern)
    path = os.path.join(args.index, FILE_GENOME_MAP)
    entries = read_genome_map(path)
    new_entries = []
    n = 0
    for gid, code in entries:
        new = pattern.sub(args.replacement, gid.decode())
        if new != gid.decode():
            n += 1
        new_entries.append((new.encode(), code))
    if args.dry_run:
        for (old, _), (new, _) in zip(entries, new_entries):
            if old != new:
                print(f"{old.decode()} -> {new.decode()}")
        return 0
    write_genome_map(path, new_entries)
    print(f"edited {n} genome IDs", file=sys.stderr)
    return 0


def cmd_utils_recount_bases(args) -> int:
    """Backfill input_bases in info.json (ref: recount-bases.go)."""
    from .index.store import FILE_INFO, IndexInfo

    info, stores, _ = _load_index_parts(args.index)
    total = sum(int(st.gsizes.sum()) for st in stores)
    info.input_bases = total
    info.save(os.path.join(args.index, FILE_INFO))
    print(f"total bases: {total}", file=sys.stderr)
    return 0


def cmd_utils_reindex_seeds(args) -> int:
    """Regenerate seed-chunk lookup tables (ref: reindex-seeds.go).

    The columnar format's only derived structure is mask_offsets;
    rebuild it from the entry arrays (repairs corruption), and update
    info partitions."""
    from .index.store import DIR_SEEDS, FILE_INFO, IndexInfo, SeedChunkReader

    db = args.index
    info = IndexInfo.load(os.path.join(db, FILE_INFO))
    seeds_dir = os.path.join(db, DIR_SEEDS)
    for name in sorted(os.listdir(seeds_dir)):
        cdir = os.path.join(seeds_dir, name)
        rdr = SeedChunkReader(cdir, mmap=False)
        per = np.asarray(rdr.mask_offsets[1:]) - np.asarray(rdr.mask_offsets[:-1])
        mask_of_entry = np.repeat(np.arange(rdr.mask_begin, rdr.mask_end), per)
        mask_offsets = np.searchsorted(
            mask_of_entry, np.arange(rdr.mask_begin, rdr.mask_end + 1)
        ).astype(np.int64)
        np.save(os.path.join(cdir, "mask_offsets.npy"), mask_offsets)
    info.partitions = args.partitions
    info.save(os.path.join(db, FILE_INFO))
    print("seeds reindexed", file=sys.stderr)
    return 0


def cmd_utils_remerge(args) -> int:
    """(ref: re-merge.go:40)"""
    from .index.merge import remerge

    try:
        remerge(args.index)
    except (RuntimeError, FileNotFoundError) as e:
        print(f"remerge: {e}", file=sys.stderr)
        return 1
    print("remerge done", file=sys.stderr)
    return 0


def _plot_seed_distances(plot_dir, gid, pos, ext=".png", glen=None):
    """Histogram of distances between adjacent seed positions
    (ref: seed-pos.go:50-75 -O/--plot-dir, gonum/plot -> matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(plot_dir, exist_ok=True)
    d = np.diff(np.unique(pos))
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(np.minimum(d, 200), bins=40, color="#4477aa")
    ax.set_xlabel("distance between adjacent seeds (bp, capped at 200)")
    ax.set_ylabel("count")
    ax.set_title(f"{gid} (n={d.shape[0] + 1} seed positions)")
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, f"{gid}{ext}"), dpi=100)
    plt.close(fig)

    # sliding-window seed counts (ref: seed-pos.go --slid-window 500
    # --slid-step 200 -> <gid>.seed_number.png); windows span the WHOLE
    # genome (zero-count tail windows are the point of the plot) and count
    # seed rows, not unique positions
    win, step = 500, 200
    up = np.sort(pos)
    if up.shape[0]:
        span = int(glen) if glen else int(up[-1]) + 1
        starts = np.arange(0, max(span - win + 1, 1), step)
        counts = np.searchsorted(up, starts + win) - np.searchsorted(up, starts)
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.hist(counts, bins=40, color="#4477aa")
        ax.set_xlabel(f"seeds per {win} bp window (step {step})")
        ax.set_ylabel("count")
        ax.set_title(gid)
        fig.tight_layout()
        fig.savefig(os.path.join(plot_dir, f"{gid}.seed_number{ext}"), dpi=100)
        plt.close(fig)


def cmd_utils_seed_pos(args) -> int:
    """Seed position distributions (ref: seed-pos.go; needs --save-seed-pos).

    TSV: ref, pos (1-based), strand, after_interval; or with --histogram,
    per-genome seed-distance histogram."""
    from .index.store import DIR_GENOMES, batch_dir

    info, stores, gmap = _load_index_parts(args.index)
    out, own = _open_out(args.out_file)
    by_code = {code: gid for gid, code in gmap}
    wrote_any = False
    if args.histogram:
        out.write("ref\tdist_bin\tcount\n")
    else:
        out.write("ref\tpos\tstrand\tafter_interval\n")
    for b, st in enumerate(stores):
        gdir = os.path.join(args.index, DIR_GENOMES, batch_dir(b))
        fpos = os.path.join(gdir, "seed_positions.npy")
        if not os.path.exists(fpos):
            continue
        wrote_any = True
        flat = np.load(fpos)
        off = np.load(os.path.join(gdir, "seed_positions_offsets.npy"))
        for gi in range(len(st)):
            gid = by_code.get(b << BITS_GENOME_IDX | gi, b"?").decode()
            if args.ref_name and gid != args.ref_name:
                continue
            vals = flat[off[gi] : off[gi + 1]]
            pos = (vals >> np.uint32(2)).astype(np.int64)
            strand = (vals >> np.uint32(1)) & 1
            flag = vals & 1
            if getattr(args, "plot_dir", ""):
                _plot_seed_distances(
                    args.plot_dir, gid, pos, args.plot_ext,
                    glen=int(st.gsizes[gi]),
                )
            if args.histogram:
                d = np.diff(np.unique(pos))
                bins = np.minimum(d // 10 * 10, 200)
                uniq, cnt = np.unique(bins, return_counts=True)
                for u, c in zip(uniq, cnt):
                    out.write(f"{gid}\t{u}\t{c}\n")
            else:
                for p, s, f in zip(pos, strand, flag):
                    out.write(f"{gid}\t{p + 1}\t{'-' if s else '+'}\t{int(f)}\n")
    if own:
        out.close()
    if not wrote_any:
        print(
            "no seed positions in the index; rebuild with --save-seed-pos",
            file=sys.stderr,
        )
        return 1
    return 0


def cmd_utils_import_index(args) -> int:
    from .index.convert import import_reference_index

    import_reference_index(args.index, args.out_dir, args.mask_file or None, verbose=True)
    print(f"imported {args.index} -> {args.out_dir}", file=sys.stderr)
    return 0


def cmd_utils_export_index(args) -> int:
    from .index.convert import export_reference_index

    export_reference_index(args.index, args.out_dir, verbose=True)
    print(f"exported {args.index} -> {args.out_dir}", file=sys.stderr)
    return 0


# --------------------------------------------------------------------------
# format conversions


def _iter_tsv_rows(files, infile_list=None):
    import gzip as _gz

    paths = list(files)
    if infile_list:
        with open(infile_list) as fh:
            paths.extend(x.strip() for x in fh if x.strip())
    for path in paths:
        op = _gz.open if path.endswith(".gz") else open
        with op(path, "rt") as fh:
            first = True
            for line in fh:
                line = line.rstrip("\r\n")
                if not line:
                    continue
                if first:
                    first = False
                    if line.startswith("query\t"):
                        continue
                yield line.split("\t")


def cmd_utils_2blast(args) -> int:
    """TSV (+-a columns) -> BLAST-style pairwise text (ref: 2blast.go:100-286)."""
    g2s = {}
    if args.kv_file_genome:
        with open(args.kv_file_genome) as fh:
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2:
                    g2s[parts[0]] = parts[1]
    out, own = _open_out(args.out_file)
    pre_query = pre_genome = pre_seq = None
    i_genome = 0
    for it in _iter_tsv_rows(args.files, args.infile_list):
        if len(it) < 24:
            print(
                "the input has <24 columns; run 'lexicmap-tpu-torch search' with -a/--all",
                file=sys.stderr,
            )
            return 1
        (query, qlen, hits, sgenome, sseqid, qcovGnm, cls, hsp, qcovHSP, alenHSP,
         pident, gaps, qstart, qend, sstart, send, sstr, slen, evalue, bitscore,
         cigar, qseq, sseq, align) = it[:24]
        if query != pre_query:
            out.write(f"Query = {query}\nLength = {qlen}\n\n")
            pre_query = query
            pre_genome = None
            i_genome = 0
        if sgenome != pre_genome:
            i_genome += 1
            extra = g2s.get(sgenome, "")
            out.write(
                f"[Subject genome #{i_genome}/{hits}] = {sgenome} {extra}\n"
                f"Query coverage per genome = {qcovGnm}%\n\n"
            )
            pre_genome = sgenome
            pre_seq = None
        if sseqid != pre_seq:
            out.write(f">{sseqid}\nLength = {slen}\n\n")
            pre_seq = sseqid
        out.write(f" HSP cluster #{cls}, HSP #{hsp}\n")
        out.write(f" Score = {bitscore} bits, Expect = {evalue}\n")
        out.write(
            f" Query coverage per seq = {qcovHSP}%, Aligned length = {alenHSP}, "
            f"Identities = {pident}%, Gaps = {gaps}\n"
        )
        out.write(
            f" Query range = {qstart}-{qend}, Subject range = {sstart}-{send}, "
            f"Strand = Plus/{'Plus' if sstr == '+' else 'Minus'}\n\n"
        )
        # wrapped alignment
        width = args.line_width
        qs, ss = int(qstart), int(sstart)
        qe_, se_ = int(qend), int(send)
        rc = sstr == "-"
        posw = max(len(str(qe_)), len(str(se_)))
        qpos = qs
        spos = se_ if rc else ss
        for off in range(0, len(align), width):
            q_ = qseq[off : off + width]
            a_ = align[off : off + width]
            t_ = sseq[off : off + width]
            nq = len(q_) - q_.count("-")
            nt = len(t_) - t_.count("-")
            q_end2 = qpos + nq - 1
            s_end2 = (spos - nt + 1) if rc else (spos + nt - 1)
            out.write(f"Query  {qpos:>{posw}} {q_} {q_end2}\n")
            out.write(f"       {'':>{posw}} {a_}\n")
            out.write(f"Sbjct  {spos:>{posw}} {t_} {s_end2}\n\n")
            qpos = q_end2 + 1
            spos = (s_end2 - 1) if rc else (s_end2 + 1)
    if own:
        out.close()
    return 0


def cmd_utils_2sam(args) -> int:
    """TSV (+-a columns) -> SAM, byte-compatible with the reference's 2sam
    (ref: 2sam.go:172-380): per-query grouping with 0x100 on non-first
    records, SEQ only on the first record ('N'-padded to the clips),
    MAPQ 60 / reference mapq formula / 0 for secondaries, TLEN = aligned
    subject span, AS = alignment score derived back from the bitscore."""
    import math

    out, own = _open_out(args.out_file)
    out.write("@HD\tVN:1.6\tSO:unsorted\tGO:query\n")
    rows = list(_iter_tsv_rows(args.files, args.infile_list))
    # @SQ headers from subject seq lengths (first-seen order)
    seen = {}
    for it in rows:
        if len(it) >= 18 and it[4] not in seen:
            seen[it[4]] = it[17]
    for sid, slen in seen.items():
        out.write(f"@SQ\tSN:{sid}\tLN:{slen}\n")
    # the JAX package's program record, so that both packages write the same SAM
    out.write("@PG\tID:lexicmap-tpu\tPN:lexicmap-tpu\n")

    lam, ln_k = 0.625, math.log(0.41)

    def flush(query, aligns):
        if not aligns:
            return
        if len(aligns) == 1:
            aligns[0]["MAPQ"] = 60
        else:
            a = aligns[0]
            # replicate the reference's runner-up selection exactly,
            # including its index base (ref: 2sam.go:315-330 — maxI indexes
            # `aligns`, but the loop enumerates aligns[2:] from 0)
            max_score, max_i = aligns[1]["score"], 1
            for i, b in enumerate(aligns[2:]):
                b["FLAG"] |= 0x100
                if b["score"] > max_score:
                    max_score, max_i = b["score"], i
            aligns[1]["FLAG"] |= 0x100
            b = aligns[max_i]
            mapq = 40 * (a["score"] - b["score"]) / a["score"] if a["score"] else 0.0
            mapq *= a["qcovHSP"] / 100
            mapq *= (a["pident"] / 100) * (1 - a["gaps"] / a["alenHSP"])
            a["MAPQ"] = min(60, max(0, int(mapq)))
        for r in aligns:
            out.write(
                f"{query}\t{r['FLAG']}\t{r['RNAME']}\t{r['POS']}\t{r['MAPQ']}\t"
                f"{r['CIGAR']}\t*\t0\t{r['TLEN']}\t{r['SEQ']}\t*\t"
                f"NM:i:{r['NM']}\tAS:i:{r['AS']}\n"
            )

    pre_query = None
    aligns = []
    for it in rows:
        if len(it) < 24:
            print(
                "the input has <24 columns; run 'lexicmap-tpu-torch search' with -a/--all",
                file=sys.stderr,
            )
            return 1
        (query, qlen, hits, sgenome, sseqid, qcovGnm, cls, hsp, qcovHSP, alenHSP,
         pident, gaps, qstart, qend, sstart, send, sstr, slen, evalue, bitscore,
         cigar, qseq, sseq, align) = it[:24]
        if query != pre_query:
            flush(pre_query, aligns)
            aligns = []
        first = query != pre_query
        pre_query = query
        _qlen, _qstart, _qend = int(qlen), int(qstart), int(qend)
        algn_score = int((float(bitscore) * math.log(2) + ln_k) / lam)
        cig = cigar if not args.no_x else cigar.replace("X", "M")
        clip5 = f"{_qstart - 1}S" if _qstart > 1 else ""
        clip3 = f"{_qlen - _qend}S" if _qend < _qlen else ""
        cig = clip5 + cig + clip3
        nm = 0
        for num, op in re.findall(r"(\d+)([MIDX=])", cigar):
            if op in ("X", "I", "D"):
                nm += int(num)
        seq = (
            "N" * (_qstart - 1) + qseq.replace("-", "") + "N" * (_qlen - _qend)
            if first else "*"
        )
        aligns.append(dict(
            FLAG=0x10 if sstr == "-" else 0,
            RNAME=sseqid, POS=sstart, MAPQ=0, CIGAR=cig,
            TLEN=int(send) - int(sstart) + 1, SEQ=seq, NM=nm, AS=algn_score,
            score=algn_score, qcovHSP=float(qcovHSP), pident=float(pident),
            gaps=float(gaps), alenHSP=float(alenHSP),
        ))
    flush(pre_query, aligns)
    if own:
        out.close()
    return 0


# --------------------------------------------------------------------------


def register_utils(sub) -> None:
    pu = sub.add_parser("utils", help="utility commands")
    usub = pu.add_subparsers(dest="utils_cmd", required=True)

    p = usub.add_parser("masks", help="view or generate masks")
    p.add_argument("-d", "--index", default="")
    p.add_argument("-o", "--out-file", default="-")
    p.add_argument("-k", "--kmer", type=int, default=31)
    p.add_argument("-m", "--masks", type=int, default=20000)
    p.add_argument("-s", "--seed", type=int, default=1)
    p.add_argument("-p", "--prefix", type=int, default=0)
    p.add_argument("--mask", type=int, default=0, help="only show this mask (1-based)")
    p.set_defaults(func=cmd_utils_masks)

    p = usub.add_parser("kmers", help="view k-mers captured by a mask")
    p.add_argument("-d", "--index", required=True)
    p.add_argument("-o", "--out-file", default="-")
    p.add_argument("-m", "--mask", type=int, default=1)
    p.add_argument("-f", "--only-forward", action="store_true")
    p.set_defaults(func=cmd_utils_kmers)

    p = usub.add_parser("genomes", help="view genome IDs in the index")
    p.add_argument("-d", "--index", required=True)
    p.add_argument("-o", "--out-file", default="-")
    p.add_argument("-e", "--extra", action="store_true")
    p.set_defaults(func=cmd_utils_genomes)

    p = usub.add_parser("genome-seqs", help="dump a genome's sequences as FASTA")
    p.add_argument("-d", "--index", required=True)
    p.add_argument("-o", "--out-file", default="-")
    p.add_argument("-n", "--ref-name", required=True)
    p.set_defaults(func=cmd_utils_genome_seqs)

    p = usub.add_parser("genome-details", help="per-genome metadata")
    p.add_argument("-d", "--index", required=True)
    p.add_argument("-o", "--out-file", default="-")
    p.add_argument("-a", "--more-columns", action="store_true")
    p.set_defaults(func=cmd_utils_genome_details)

    p = usub.add_parser("subseq", help="extract subsequences")
    p.add_argument("-d", "--index", required=True)
    p.add_argument("-o", "--out-file", default="-")
    p.add_argument("-n", "--ref-name", default="")
    p.add_argument("-s", "--seq-id", default="")
    p.add_argument(
        "-r", "--region", default="",
        help='region of the subsequence, 1-based "start:end" (ref: subseq.go -r)',
    )
    p.add_argument("-R", "--revcom", action="store_true",
                   help="extract the negative strand")
    p.add_argument(
        "-f", "--search-result", "-t", "--tsv", dest="tsv", default="",
        help='use a "lexicmap search" result TSV as input',
    )
    p.add_argument("-H", "--no-header-row", action="store_true")
    p.add_argument("-U", "--upstream", "--up-stream", dest="up_stream",
                   type=int, default=0)
    p.add_argument("-D", "--downstream", "--down-stream", dest="down_stream",
                   type=int, default=0)
    p.add_argument("-w", "--line-width", type=int, default=60)
    p.add_argument("-e", "--ignore-err", action="store_true")
    # accepted for reference CLI compatibility; buffering is automatic here
    p.add_argument("-b", "--buffer-size", default="20M", help=argparse.SUPPRESS)
    p.add_argument("--max-open-files", type=int, default=1024, help=argparse.SUPPRESS)
    p.set_defaults(func=cmd_utils_subseq)

    p = usub.add_parser("merge-search-results", help="merge TSVs from multiple indexes")
    p.add_argument("files", nargs="*")
    p.add_argument("-X", "--infile-list", default="")
    p.add_argument("-o", "--out-file", default="-")
    p.add_argument("-q", "--query", default="")
    p.set_defaults(func=cmd_utils_merge_search_results)

    p = usub.add_parser("edit-genome-ids", help="regexp-rewrite genome IDs")
    p.add_argument("-d", "--index", required=True)
    p.add_argument("-p", "--pattern", required=True)
    p.add_argument("-r", "--replacement", required=True)
    p.add_argument("--dry-run", action="store_true")
    p.set_defaults(func=cmd_utils_edit_genome_ids)

    p = usub.add_parser("recount-bases", help="backfill input bases in info.json")
    p.add_argument("-d", "--index", required=True)
    p.set_defaults(func=cmd_utils_recount_bases)

    p = usub.add_parser("reindex-seeds", help="regenerate seed lookup tables")
    p.add_argument("-d", "--index", required=True)
    p.add_argument("--partitions", type=int, default=4096)
    p.set_defaults(func=cmd_utils_reindex_seeds)

    p = usub.add_parser("remerge", help="resume an interrupted batch merge")
    p.add_argument("-d", "--index", required=True)
    p.set_defaults(func=cmd_utils_remerge)

    p = usub.add_parser("seed-pos", help="seed position distributions")
    p.add_argument("-d", "--index", required=True)
    p.add_argument("-o", "--out-file", default="-")
    p.add_argument("-n", "--ref-name", default="")
    p.add_argument("--histogram", action="store_true")
    p.add_argument("-O", "--plot-dir", default="",
                   help="also write per-genome seed-distance histograms")
    p.add_argument("--plot-ext", default=".png")
    p.set_defaults(func=cmd_utils_seed_pos)

    p = usub.add_parser("2blast", help="search TSV -> BLAST-style text")
    p.add_argument("files", nargs="*")
    p.add_argument("-X", "--infile-list", default="")
    p.add_argument("-o", "--out-file", default="-")
    p.add_argument("-g", "--kv-file-genome", default="")
    p.add_argument("-w", "--line-width", type=int, default=60)
    p.set_defaults(func=cmd_utils_2blast)

    p = usub.add_parser(
        "import-index", help="convert a reference-format (.lmi) index to native"
    )
    p.add_argument("-d", "--index", required=True, help="reference index dir")
    p.add_argument("-O", "--out-dir", required=True)
    p.add_argument("-M", "--mask-file", default="", help="masks text file (utils masks export)")
    p.set_defaults(func=cmd_utils_import_index)

    p = usub.add_parser(
        "export-index", help="convert a native index to the reference format"
    )
    p.add_argument("-d", "--index", required=True, help="native index dir")
    p.add_argument("-O", "--out-dir", required=True)
    p.set_defaults(func=cmd_utils_export_index)

    p = usub.add_parser("2sam", help="search TSV -> SAM")
    p.add_argument("files", nargs="*")
    p.add_argument("-X", "--infile-list", default="")
    p.add_argument("-o", "--out-file", default="-")
    p.add_argument("--no-x", action="store_true", help="replace X ops with M")
    p.set_defaults(func=cmd_utils_2sam)
