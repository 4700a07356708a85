"""`lexicmap-tpu-torch genome` subcommands: search (ANI/AF), pair, compare.

(ref: lexicmap/cmd/search-genome.go, pair.go, compare.go)
"""

from __future__ import annotations

import itertools
import sys

from .cli_utils import _open_out, no_cuda


def cmd_genome_search(args) -> int:
    from .index.gsearch import (
        GSearchOptions,
        gsearch_align,
        gsearch_screen,
        read_genome_query,
    )
    from .index.search import IndexSearcher, SearchOptions
    from .utils.taxonomy import parse_taxid_args

    if (args.engine == "device" and args.device == "cuda"
            and no_cuda("screen on the CPU, or --engine host")):
        return 1
    taxids, neg = parse_taxid_args(args.taxids or [], args.taxid_file or None)
    sopt = SearchOptions(
        min_prefix=args.seed_min_prefix,
        in_memory=args.load_whole_seeds,
        engine=args.engine,
        device=args.device,
        taxdump_dir=args.taxdump or None,
        genome2taxid_file=args.genome2taxid or None,
        taxids=taxids,
        negative_taxids=neg,
        keep_genomes_without_taxid=args.keep_genomes_without_taxid,
    )
    gopt = GSearchOptions(
        min_prefix=args.seed_min_prefix,
        windows=args.windows,
        frag_size=args.frag_size,
        min_frag_size=args.min_frag_size,
        top_n=args.top_n_genomes,
        top_n_chains=args.top_n_chains,
        min_af=args.min_af,
        kmer_scale=args.kmer_scale,
        max_subject_genome_size=args.max_subject_genome_size * 1_000_000,
        only_screening=args.only_genome_screening,
        min_identity=args.align_min_match_pident,
        align_min_match_len=args.align_min_match_len,
        align_max_gap=args.align_max_gap,
        align_band=args.align_band,
    )
    idx = IndexSearcher(args.index, sopt)
    out, own = _open_out(args.out_file)
    if gopt.only_screening:
        out.write("query\tsubject\tminPrefix\tfracMasks\tnMasks\tsumPrefix\tavgPrefix\n")
    else:
        out.write("query\tsubject\tANI\tqAF\tsAF\tqcontigs\tqsize\tscontigs\tssize\n")
    files = list(args.files)
    if args.infile_list:
        with open(args.infile_list) as fh:
            files.extend(x.strip() for x in fh if x.strip())
    for path in files:
        q = read_genome_query(path, idx.k)
        if q is None:
            continue
        groups = gsearch_screen(idx, q, gopt)
        if gopt.only_screening:
            for codes, score in groups:
                gid = idx.id_of_code.get(codes[0], b"?").decode()
                out.write(
                    f"{q.id.decode()}\t{gid}\t{gopt.min_prefix}\t-\t-\t{score}\t-\n"
                )
            continue
        if args.OrthoANI:
            from .index.gsearch import GQuery, ortho_ani_compare
            import numpy as np

            for codes, score in groups:
                code = codes[0]
                b = code >> 17
                gi = code & ((1 << 17) - 1)
                st = idx.genome_stores[b]
                sizes = st.seq_sizes(gi)
                contigs = []
                pos = 0
                for s in sizes:
                    contigs.append(st.subseq_codes(gi, pos, pos + s - 1))
                    pos += s + idx.contig_interval
                sq = GQuery(
                    id=idx.id_of_code.get(code, b"?"),
                    seqs=contigs,
                    big_codes=np.concatenate(contigs) if contigs else np.empty(0, "u1"),
                    skip_regions=[],
                    genome_size=sum(sizes),
                )
                ani, af_q, af_s, _n = ortho_ani_compare(q, sq, gopt)
                if af_q * 100 < gopt.min_af:
                    continue
                out.write(
                    f"{q.id.decode()}\t{sq.id.decode()}\t{ani * 100:.3f}\t"
                    f"{af_q * 100:.3f}\t{af_s * 100:.3f}\t{len(q.seqs)}\t"
                    f"{q.genome_size}\t{len(sq.seqs)}\t{sq.genome_size}\n"
                )
            continue
        for gr in gsearch_align(idx, q, groups, gopt):
            out.write(
                f"{q.id.decode()}\t{gr.genome_id.decode()}\t{gr.ani * 100:.3f}\t"
                f"{gr.af_q * 100:.3f}\t{gr.af_s * 100:.3f}\t{len(q.seqs)}\t"
                f"{q.genome_size}\t{gr.num_seqs}\t{gr.genome_size}\n"
            )
    if own:
        out.close()
    return 0


def cmd_genome_pair(args) -> int:
    from .index.gsearch import genome_pairs
    from .index.search import IndexSearcher, SearchOptions

    nm = args.masks
    if nm != 0 and not (nm >= 64 and (nm & (nm - 1)) == 0 and (nm.bit_length() - 1) % 2 == 0):
        print(
            "the value of -m/--masks should be 0 (for all masks) or a power "
            "of 4 >= 64 (e.g., 64, 256, 1024, 4096, 16384)",
            file=sys.stderr,
        )
        return 1
    idx = IndexSearcher(args.index, SearchOptions())
    total = nm if nm else idx.mask_set.m
    out, own = _open_out(args.out_file)
    out.write("genome1\tgenome2\tminPrefix\tfracMasks\tnMasks\tsumPrefix\tavgPrefix\n")
    for g1, g2, n_masks, sum_prefix in genome_pairs(
        idx, args.min_prefix, args.min_mask_fraction, args.prob_threshold, nm
    ):
        id1 = idx.id_of_code.get(g1, b"?").decode()
        id2 = idx.id_of_code.get(g2, b"?").decode()
        out.write(
            f"{id1}\t{id2}\t{args.min_prefix}\t{n_masks / total:.4f}\t{n_masks}\t"
            f"{sum_prefix}\t{sum_prefix / n_masks:.2f}\n"
        )
    if own:
        out.close()
    return 0


def cmd_genome_compare(args) -> int:
    from .index.gsearch import GSearchOptions, compare_two_genomes, read_genome_query

    gopt = GSearchOptions(
        frag_size=args.frag_size,
        min_frag_size=args.min_frag_size,
        min_identity=args.align_min_match_pident,
        kmer_scale=args.kmer_scale,
    )
    queries = {}
    pairs = []
    if args.pair_file:
        # genome IDs in the first two columns; sequences read from the index
        from .index.search import IndexSearcher, SearchOptions

        idx = IndexSearcher(args.index, SearchOptions())
        name2code = {gid.decode(): code for code, gid in idx.id_of_code.items()}

        def load_from_index(name):
            if name in queries:
                return queries[name]
            from .index.gsearch import GQuery

            code = name2code[name]
            b = code >> 17
            gi = code & ((1 << 17) - 1)
            st = idx.genome_stores[b]
            sizes = st.seq_sizes(gi)
            contigs = []
            pos = 0
            for s in sizes:
                contigs.append(st.subseq_codes(gi, pos, pos + s - 1))
                pos += s + idx.contig_interval
            import numpy as np

            q = GQuery(
                id=name.encode(),
                seqs=contigs,
                big_codes=np.concatenate(contigs) if contigs else np.empty(0, "u1"),
                skip_regions=[],
                genome_size=sum(sizes),
            )
            queries[name] = q
            return q

        with open(args.pair_file) as fh:
            lines = [l.rstrip("\n").split("\t") for l in fh if l.strip()]
        if not args.no_header_row:
            lines = lines[1:]
        for row in lines:
            if len(row) >= 2:
                pairs.append((load_from_index(row[0]), load_from_index(row[1])))
    else:
        qs = []
        for path in args.files:
            q = read_genome_query(path, 13)
            if q is not None:
                qs.append(q)
        pairs = list(itertools.combinations(qs, 2))

    out, own = _open_out(args.out_file)
    out.write(
        "genome1\tgenome2\ttANI\tANI1\tANI2\tAF1\tAF2\tcontigs1\tsize1\tcontigs2\tsize2\n"
    )
    for q1, q2 in pairs:
        r12 = compare_two_genomes(q1, q2, gopt)
        r21 = compare_two_genomes(q2, q1, gopt)
        total = q1.genome_size + q2.genome_size
        tani = (r12.aligned_matches + r21.aligned_matches) / total if total else 0.0
        out.write(
            f"{q1.id.decode()}\t{q2.id.decode()}\t{tani * 100:.3f}\t"
            f"{r12.ani * 100:.3f}\t{r21.ani * 100:.3f}\t"
            f"{r12.af_q * 100:.3f}\t{r21.af_q * 100:.3f}\t"
            f"{len(q1.seqs)}\t{q1.genome_size}\t{len(q2.seqs)}\t{q2.genome_size}\n"
        )
    if own:
        out.close()
    return 0


def register_genome(sub) -> None:
    pg = sub.add_parser("genome", help="genome-level commands (ANI/AF)")
    gsub = pg.add_subparsers(dest="genome_cmd", required=True)

    p = gsub.add_parser("search", help="search genomes against an index with ANI/AF")
    p.add_argument("files", nargs="*")
    p.add_argument("-X", "--infile-list", default="")
    p.add_argument("-d", "--index", required=True)
    p.add_argument("-o", "--out-file", default="-")
    p.add_argument("-p", "--seed-min-prefix", type=int, default=21)
    p.add_argument("--windows", type=int, default=1)
    p.add_argument("--frag-size", type=int, default=1020)
    p.add_argument("--min-frag-size", type=int, default=100)
    p.add_argument("-n", "--top-n-genomes", type=int, default=10)
    p.add_argument("-N", "--top-n-chains", type=int, default=5)
    p.add_argument("--min-af", type=float, default=15.0)
    p.add_argument("--kmer-scale", type=int, default=4)
    p.add_argument("--max-subject-genome-size", type=int, default=20, help="in Mb")
    p.add_argument("-S", "--only-genome-screening", action="store_true")
    p.add_argument(
        "--engine", choices=["host", "device"], default="host",
        help="candidate screening: host range search or one batched CUDA "
        "prefix match over the window captures (hybrid lo-word refinement "
        "for prefixes > 16)",
    )
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where --engine device screens: the GPU (default) or the CPU "
        "(the kernel's plain PyTorch twin)",
    )
    p.add_argument("-O", "--OrthoANI", action="store_true")
    p.add_argument("-w", "--load-whole-seeds", action="store_true")
    p.add_argument("-i", "--align-min-match-pident", type=float, default=70.0)
    p.add_argument("-l", "--align-min-match-len", type=int, default=30)
    p.add_argument("--align-max-gap", type=int, default=100)
    p.add_argument("--align-band", type=int, default=100)
    p.add_argument("-T", "--taxdump", default="")
    p.add_argument("-G", "--genome2taxid", default="")
    p.add_argument("-t", "--taxids", action="append", default=[])
    p.add_argument("--taxid-file", default="")
    p.add_argument("-K", "--keep-genomes-without-taxid", action="store_true")
    p.set_defaults(func=cmd_genome_search)

    p = gsub.add_parser("pair", help="find similar genome pairs in the index")
    p.add_argument("-d", "--index", required=True)
    p.add_argument("-o", "--out-file", default="-")
    p.add_argument("-p", "--min-prefix", type=int, default=21)
    p.add_argument(
        "-m", "--masks", type=int, default=1024,
        help="number of masks to use (0 for all; power of 4, >= 64)",
    )
    p.add_argument(
        "-f", "--min-mask-fraction", type=float, default=0.25,
        help="minimum fraction of masks with seeds sharing >= min-prefix",
    )
    p.add_argument(
        "-s", "--prob-threshold", type=float, default=0.001,
        help="binomial-probability pruning threshold (0 disables pruning)",
    )
    p.set_defaults(func=cmd_genome_pair)

    p = gsub.add_parser("compare", help="pairwise ANI/AF of explicit genome pairs")
    p.add_argument("files", nargs="*")
    p.add_argument("-d", "--index", default="")
    p.add_argument("-i", "--pair-file", default="")
    p.add_argument("-H", "--no-header-row", action="store_true")
    p.add_argument("-o", "--out-file", default="-")
    p.add_argument("--frag-size", type=int, default=1020)
    p.add_argument("--min-frag-size", type=int, default=100)
    p.add_argument("--kmer-scale", type=int, default=4)
    p.add_argument("--align-min-match-pident", type=float, default=70.0)
    p.set_defaults(func=cmd_genome_compare)
