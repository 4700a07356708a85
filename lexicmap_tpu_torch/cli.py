"""Command-line interface of the port: `index`, `search`, `genome
search / pair / compare`, `utils` (16 subcommands, `cli_utils.py`) and
`autocompletion`.

    python -m lexicmap_tpu_torch.cli index -O db.lmt genomes/*.fa.gz
    python -m lexicmap_tpu_torch.cli search -d db.lmt q.fasta -o out.tsv
    python -m lexicmap_tpu_torch.cli genome search -d db.lmt g.fasta --engine device
    python -m lexicmap_tpu_torch.cli utils export-index -d db.lmt -O ref.lmi
    python -m lexicmap_tpu_torch.cli autocompletion --shell bash

`index --engine device` captures each genome's seeds on the GPU through
the CUDA capture kernels (`--device cpu`: their plain PyTorch twin).

`search --engine device` (the default) matches seeds (phase 2a) and
pseudo-aligns candidate windows (phase 4) on the GPU through the CUDA
kernels; `--chain device` adds the chain1 forward DP of phase 3 and `--wfa
device` the base-level WFA of phase 5.  `--device cpu` runs the kernels'
plain PyTorch twins instead, `--engine host` the host engine, and `--engine
auto` the device engine when a CUDA device is present, else the host one.
The TSV is byte-compatible with the reference's 20/24-column search output
(ref: search.go:427-519).  Root flags: `--quiet`, `--log FILE` (stderr is
also written to FILE).
"""

from __future__ import annotations

import argparse
import gzip
import sys
import time

from .cli_utils import no_cuda
from .constants import IndexDefaults, SearchDefaults


def _out_stream(path: str):
    if path == "-" or not path:
        return sys.stdout.buffer, False
    if path.endswith(".gz"):
        return gzip.open(path, "wb"), True
    return open(path, "wb"), True


# --------------------------------------------------------------------------
# index


def cmd_index(args) -> int:
    from .index.build import BuildOptions, build_index
    from .utils.fasta import find_fastx_files

    files = list(args.files)
    if args.in_dir:
        files.extend(find_fastx_files(args.in_dir))
    if args.infile_list:
        with open(args.infile_list) as fh:
            files.extend(line.strip() for line in fh if line.strip())
    if not files:
        print("no input files", file=sys.stderr)
        return 1
    opt = BuildOptions(
        k=args.kmer,
        n_masks=args.masks,
        rand_seed=args.rand_seed,
        mask_file=args.mask_file or None,
        batch_size=args.batch_size,
        chunks=args.chunks,
        partitions=args.partitions,
        max_genome_size=args.max_genome,
        min_seq_len=args.min_seq_len,
        contig_interval=args.contig_interval,
        seed_max_desert=args.seed_max_desert,
        seed_in_desert_dist=args.seed_in_desert_dist,
        disable_desert_filling=args.no_desert_filling,
        max_kmer_freq=args.max_kmer_freq,
        soft_masking=args.soft_masking,
        save_seed_pos=args.save_seed_pos,
        seq_name_filters=args.seq_name_filter or [],
        big_genome_file=args.big_genomes or None,
        force=args.force,
        verbose=not args.quiet,
        threads=args.threads,
        engine=args.engine,
        device=args.device,
    )
    if (args.engine == "device" and args.device == "cuda"
            and no_cuda("run the device capture on the CPU, or --engine host")):
        return 1
    if not args.quiet:
        # parameter echo (ref: index.go:454-495 verbose run summary)
        print(
            "build parameters:\n"
            f"  input: {len(files)} file(s)\n"
            f"  k-mer size: {opt.k}, masks: {opt.n_masks}, seed: {opt.rand_seed}"
            + (f", mask file: {opt.mask_file}" if opt.mask_file else "")
            + "\n"
            f"  batch size: {opt.batch_size}, seed chunks: {opt.chunks or 'auto'}, "
            f"partitions: {opt.partitions}\n"
            f"  max genome size: {opt.max_genome_size}, contig interval: {opt.contig_interval}\n"
            f"  seed desert: max {opt.seed_max_desert}, in-desert dist {opt.seed_in_desert_dist}"
            + (" (desert filling disabled)" if opt.disable_desert_filling else "")
            + "\n"
            f"  output: {args.out_dir}",
            file=sys.stderr,
        )
    t0 = time.time()
    info = build_index(args.out_dir, files, opt)
    if not args.quiet:
        print(
            f"indexed {info.genomes} genomes ({info.input_bases} bases) "
            f"with {info.masks} masks in {time.time() - t0:.2f}s -> {args.out_dir}",
            file=sys.stderr,
        )
    return 0


# --------------------------------------------------------------------------
# search

# worker-pool state, inherited across fork() (host engine only)
_POOL_IDX = None
_POOL_ALL = False
_POOL_SSEQ_IDX = False


def _pool_search_one(item):
    qid, seq = item
    idx = _POOL_IDX
    if len(seq) < idx.k:
        return qid, 0, []
    results = idx.search_bytes(seq)
    return (
        qid,
        len(seq),
        list(format_hit_rows(qid, len(seq), results, _POOL_ALL, _POOL_SSEQ_IDX)),
    )


TSV_HEADER = (
    "query\tqlen\thits\tsgenome\tsseqid\tqcovGnm\tcls\thsp\tqcovHSP\t"
    "alenHSP\tpident\tgaps\tqstart\tqend\tsstart\tsend\tsstr\tslen\tevalue\tbitscore"
)


def format_hit_rows(query_id: str, qlen: int, results, all_columns=False, show_sseq_idx=False):
    """Yield TSV rows for one query (ref: printResult, search.go:438-535)."""
    targets = len(results)
    for r in results:
        c_idx = 1
        j = 1
        for sd in r.details:
            for c in sd.chains:
                strand = "-" if sd.rc else "+"
                sseqid = sd.seq_id.decode()
                if show_sseq_idx:
                    sseqid = (
                        f"c{sd.chunk_idx + 1}/{sd.n_chunks}:"
                        f"s{sd.seq_idx + 1}/{sd.n_seqs}:{sseqid}"
                    )
                row = (
                    f"{query_id}\t{qlen}\t{targets}\t{r.genome_id.decode()}\t"
                    f"{sseqid}\t{r.aligned_fraction:.3f}\t{c_idx}\t{j}\t"
                    f"{c.aligned_fraction:.3f}\t{c.aligned_length}\t{c.pident:.3f}\t"
                    f"{c.gaps}\t{c.qbegin + 1}\t{c.qend + 1}\t{c.tbegin + 1}\t"
                    f"{c.tend + 1}\t{strand}\t{sd.seq_len}\t{c.evalue:.2e}\t{c.bit_score}"
                )
                if all_columns:
                    row += (
                        f"\t{c.cigar.decode()}\t{c.qseq.decode()}"
                        f"\t{c.tseq.decode()}\t{c.alignment.decode()}"
                    )
                yield row
                j += 1
            c_idx += 1


def print_spans(spans, n_queries: int):
    """--debug: the span recorder's totals, whole and a query: the device
    stages' times, waits and counters."""
    from .utils.spans import COUNTERS

    per = 1 / max(n_queries, 1)
    print(f"  [debug] device engine phase times (s; ms a query over {n_queries} queries; "
          "spans), then counters (items; a query; calls):", file=sys.stderr)
    for key, v in spans.totals.items():
        if key in COUNTERS:  # items, whole and a query, and the calls that added them
            print(f"    {key:<20} {v:10.0f} {v * per:10.4f} {spans.counts[key]:8d}",
                  file=sys.stderr)
            continue
        print(f"    {key:<20} {v:10.4f} {v * per * 1e3:10.4f} {spans.counts[key]:8d}",
              file=sys.stderr)


def cmd_search(args) -> int:
    import os

    from .index.search import IndexSearcher, SearchOptions
    from .utils.fasta import read_fastx

    if not os.path.exists(os.path.join(args.index, "info.json")):
        print(f"error: index not found: {args.index}", file=sys.stderr)
        return 1
    auto = args.engine == "auto"
    if auto:  # resolved once, here: the card when there is one
        import torch

        args.engine = "device" if torch.cuda.is_available() else "host"
    if "device" in (args.engine, args.chain, args.wfa):
        if args.device == "cuda" and no_cuda("run the device stages on the CPU, or "
                                              "--engine host (and --chain / --wfa host)"):
            return 1
        if args.max_query_conc > 1:
            # the -J pool forks, and CUDA does not survive a fork after init
            print("error: the device stages run in one process; use -J 1 "
                  "(or host engines for the forked query pool)", file=sys.stderr)
            return 1

    if args.engine == "host" and args.chain == "device":
        print("warning: --chain device chains only the device engine's batches; "
              "with --engine host phase 3 runs on the host", file=sys.stderr)
    if args.engine == "host" and args.wfa == "device" and not args.all:
        print("warning: with --engine host, --wfa device aligns only for -a; "
              "phase 5 runs on the host", file=sys.stderr)

    from .utils.taxonomy import parse_taxid_args

    taxids, negative_taxids = parse_taxid_args(args.taxids or [], args.taxid_file or None)

    opt = SearchOptions(
        min_prefix=args.seed_min_prefix,
        min_single_prefix=args.seed_min_single_prefix,
        top_n=args.top_n_genomes,
        top_n_chains=args.top_n_chains,
        max_gap=args.seed_max_gap,
        max_distance=args.seed_max_dist,
        extend_length=args.align_ext_len,
        min_qcov_genome=args.min_qcov_per_genome,
        min_qcov_hsp=args.min_qcov_per_hsp,
        min_identity=args.align_min_match_pident,
        min_align_len=args.align_min_match_len,
        align_max_gap=args.align_max_gap,
        align_band=args.align_band,
        max_evalue=args.max_evalue,
        in_memory=args.load_whole_seeds,
        output_seq=args.all,
        engine=args.engine,
        device=args.device,
        wfa_engine=args.wfa,
        chain_engine=args.chain,
        debug=args.debug,
        taxdump_dir=args.taxdump or None,
        genome2taxid_file=args.genome2taxid or None,
        taxids=taxids,
        negative_taxids=negative_taxids,
        keep_genomes_without_taxid=args.keep_genomes_without_taxid,
    )
    if not args.quiet:
        print(
            "search parameters:\n"
            f"  index: {args.index}\n"
            f"  seed min prefix: {opt.min_prefix} (single-query: {opt.min_single_prefix}), "
            f"max gap: {opt.max_gap}, max dist: {opt.max_distance}\n"
            f"  align: ext-len {opt.extend_length}, band {opt.align_band}, "
            f"min len {opt.min_align_len}, min pident {opt.min_identity}, "
            f"max evalue {opt.max_evalue}\n"
            f"  filters: qcovGnm >= {opt.min_qcov_genome}, qcovHSP >= {opt.min_qcov_hsp}, "
            f"top-n genomes {opt.top_n or 'all'}, top-n chains {opt.top_n_chains or 'all'}\n"
            f"  engine: {opt.engine}"
            + (f" ({opt.device})" if opt.engine == "device" else "")
            + (" [auto]" if auto else "")
            + f", chain: {opt.chain_engine}, wfa: {opt.wfa_engine}"
            + (", in-memory seeds" if opt.in_memory else ""),
            file=sys.stderr,
        )
    t0 = time.time()
    try:
        idx = IndexSearcher(args.index, opt)
    except (OSError, ValueError, KeyError) as e:
        print(f"error: failed to load index {args.index}: {e}", file=sys.stderr)
        return 1
    if not args.quiet:
        print(f"index loaded in {time.time() - t0:.2f}s", file=sys.stderr)
    if args.debug:  # the device stages' waits and counters on this thread too
        idx.spans.bind_thread()

    out, own = _out_stream(args.out_file)
    header = TSV_HEADER + ("\tcigar\tqseq\tsseq\talign" if args.all else "")
    out.write(header.encode() + b"\n")

    qfiles = list(args.files)
    if args.infile_list:
        with open(args.infile_list) as fh:
            qfiles.extend(x.strip() for x in fh if x.strip())

    def iter_queries():
        for path in qfiles or ["-"]:
            fh = sys.stdin.buffer if path == "-" else path
            yield from read_fastx(fh)

    n = 0
    matched = 0
    t1 = time.time()
    _tick_state = [t1]

    def tick():
        now = time.time()
        if not args.quiet and now - _tick_state[0] >= 5.0:
            _tick_state[0] = now
            print(
                f"processed queries: {n}, speed: {n / (now - t1) * 60:.3f} queries per minute",
                file=sys.stderr,
            )

    def write_rows(qid: str, qlen: int, results):
        for row in format_hit_rows(qid, qlen, results, args.all, args.show_sseq_idx):
            out.write(row.encode() + b"\n")

    if args.max_query_conc > 1:
        # fork-based query worker pool (host engine; ref: search.go:537-604);
        # the index's mmap state is inherited
        import multiprocessing as mp

        global _POOL_IDX, _POOL_ALL, _POOL_SSEQ_IDX
        _POOL_IDX = idx
        _POOL_ALL = args.all
        _POOL_SSEQ_IDX = args.show_sseq_idx

        with mp.get_context("fork").Pool(args.max_query_conc) as pool:
            for qid, qlen, rows in pool.imap(
                _pool_search_one,
                ((r.id.decode(), r.seq) for r in iter_queries()),
                chunksize=1,
            ):
                n += 1
                tick()
                if rows:
                    matched += 1
                    for row in rows:
                        out.write(row.encode() + b"\n")
    elif args.engine == "device":
        # batches of 32 queries: one seed-locate launch per bucket per batch
        import itertools

        it = iter_queries()
        while True:
            batch = list(itertools.islice(it, 32))
            if not batch:
                break
            n += len(batch)
            tick()
            for rec, results in zip(batch, idx.search_many([r.seq for r in batch])):
                if results:
                    matched += 1
                    write_rows(rec.id.decode(), len(rec.seq), results)
    else:
        for rec in iter_queries():
            n += 1
            tick()
            if len(rec.seq) < idx.k:
                continue
            results = idx.search_bytes(rec.seq)
            if results:
                matched += 1
                write_rows(rec.id.decode(), len(rec.seq), results)
    if own:
        out.close()
    if args.debug and (getattr(idx, "_device_engine", None) is not None
                       or idx.device_chainer is not None or idx.device_wfa is not None):
        # how much of each device stage ran on the device this session
        print_spans(idx.spans, n)
    if not args.quiet:
        el = time.time() - t1
        print(
            f"processed {n} queries in {el:.2f}s "
            f"({n / el * 60:.1f} queries/min), {matched} matched",
            file=sys.stderr,
        )
    return 0


# --------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    from . import __version__

    p = argparse.ArgumentParser(
        prog="lexicmap-tpu-torch",
        description="LexicMap-class sequence alignment engine on PyTorch/CUDA",
    )
    # root --quiet has its own dest: a subcommand's --quiet default would
    # otherwise overwrite it
    p.add_argument("--quiet", dest="root_quiet", action="store_true")
    p.add_argument("--log", default="", metavar="FILE",
                   help="also write log messages (stderr) to FILE (ref: root.go:60-73)")
    p.add_argument("--version", action="version", version=f"lexicmap-tpu-torch {__version__}")
    sub = p.add_subparsers(dest="cmd", required=True)

    pa = sub.add_parser(
        "autocompletion",
        help="print a shell completion script (ref: autocomplete.go)",
    )
    pa.add_argument("--shell", default="bash", choices=["bash", "zsh", "fish"])
    pa.set_defaults(func=cmd_autocompletion)

    pi = sub.add_parser("index", help="build an index from genome files")
    pi.add_argument("files", nargs="*", help="input FASTA/Q files")
    pi.add_argument("-I", "--in-dir", default="")
    pi.add_argument("-X", "--infile-list", default="")
    pi.add_argument("-O", "--out-dir", required=True)
    pi.add_argument("-j", "--threads", type=int, default=0, help="0 = all CPUs")
    pi.add_argument("--quiet", action="store_true")
    pi.add_argument("-k", "--kmer", type=int, default=IndexDefaults.K)
    pi.add_argument("-m", "--masks", type=int, default=IndexDefaults.MASKS)
    pi.add_argument("-s", "--rand-seed", type=int, default=IndexDefaults.RAND_SEED)
    pi.add_argument("-M", "--mask-file", default="")
    pi.add_argument("-b", "--batch-size", type=int, default=IndexDefaults.BATCH_SIZE)
    pi.add_argument("-c", "--chunks", type=int, default=IndexDefaults.CHUNKS)
    pi.add_argument("--max-open-files", type=int, default=1024,
                    help="accepted for reference compatibility; this "
                         "implementation keeps at most #chunks files open "
                         "(ref: index.go:137)")
    pi.add_argument("--partitions", type=int, default=IndexDefaults.PARTITIONS)
    pi.add_argument("-g", "--max-genome", type=int, default=IndexDefaults.MAX_GENOME_SIZE)
    pi.add_argument("-l", "--min-seq-len", type=int, default=IndexDefaults.MIN_SEQ_LEN)
    pi.add_argument("--contig-interval", type=int, default=IndexDefaults.CONTIG_INTERVAL)
    pi.add_argument("-D", "--seed-max-desert", type=int, default=IndexDefaults.SEED_MAX_DESERT)
    pi.add_argument(
        "-d", "--seed-in-desert-dist", type=int, default=IndexDefaults.SEED_IN_DESERT_DIST
    )
    pi.add_argument("--no-desert-filling", action="store_true")
    pi.add_argument("--max-kmer-freq", type=int, default=IndexDefaults.MAX_KMER_FREQ)
    pi.add_argument("--soft-masking", action="store_true")
    pi.add_argument("--save-seed-pos", action="store_true")
    pi.add_argument("-B", "--seq-name-filter", action="append", default=[])
    pi.add_argument("-G", "--big-genomes", default="")
    pi.add_argument("--force", action="store_true")
    pi.add_argument(
        "--engine", choices=["host", "device"], default="host",
        help="capture engine: host trie co-descent or device capture on the GPU "
        "(bit-exact)",
    )
    pi.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where the device capture runs: the GPU (default) or the CPU (the "
        "kernels' plain PyTorch twin)",
    )
    pi.set_defaults(func=cmd_index)

    ps = sub.add_parser("search", help="search query sequences against an index")
    ps.add_argument("files", nargs="*", help="query FASTA/Q files")
    ps.add_argument("-X", "--infile-list", default="")
    ps.add_argument("-d", "--index", required=True)
    ps.add_argument("-o", "--out-file", default="-")
    ps.add_argument("-a", "--all", action="store_true")
    ps.add_argument("--show-sseq-idx", action="store_true")
    ps.add_argument(
        "--engine", choices=["host", "device", "auto"], default="device",
        help="seed matching and pseudo-alignment: the CUDA kernels (device, "
        "the default), the host engine, or auto (device when a CUDA device "
        "is present, else host)",
    )
    ps.add_argument(
        "--wfa", choices=["host", "device"], default="host",
        help="base-level aligner of phase 5: host wavefronts or the batched "
        "CUDA WFA (bit-exact; with --engine device, one call per batch)",
    )
    ps.add_argument(
        "--chain", choices=["host", "device"], default="host",
        help="phase-3 chainer: host DP or the CUDA chain1 forward DP "
        "(bit-exact, host backtrack; with --engine device, one launch per "
        "batch)",
    )
    ps.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where the device engine runs: the GPU (default) or the CPU "
        "(the kernels' plain PyTorch twins)",
    )
    ps.add_argument("--debug", action="store_true", help="per-phase timings")
    ps.add_argument("-J", "--max-query-conc", type=int, default=1)
    ps.add_argument("--quiet", action="store_true")
    ps.add_argument("-p", "--seed-min-prefix", type=int, default=SearchDefaults.MIN_PREFIX)
    ps.add_argument(
        "-P", "--seed-min-single-prefix", type=int, default=SearchDefaults.MIN_SINGLE_PREFIX
    )
    ps.add_argument("--seed-max-gap", type=int, default=SearchDefaults.SEED_MAX_GAP)
    ps.add_argument("--seed-max-dist", type=int, default=SearchDefaults.SEED_MAX_DIST)
    ps.add_argument("-n", "--top-n-genomes", type=int, default=SearchDefaults.TOP_N_GENOMES)
    ps.add_argument("-N", "--top-n-chains", type=int, default=SearchDefaults.TOP_N_CHAINS)
    ps.add_argument("-w", "--load-whole-seeds", action="store_true")
    ps.add_argument("--align-ext-len", type=int, default=SearchDefaults.ALIGN_EXT_LEN)
    ps.add_argument("--align-max-gap", type=int, default=SearchDefaults.ALIGN_MAX_GAP)
    ps.add_argument("--align-band", type=int, default=SearchDefaults.ALIGN_BAND)
    ps.add_argument(
        "-l", "--align-min-match-len", type=int, default=SearchDefaults.ALIGN_MIN_MATCH_LEN
    )
    ps.add_argument(
        "-i",
        "--align-min-match-pident",
        type=float,
        default=SearchDefaults.ALIGN_MIN_MATCH_PIDENT,
    )
    ps.add_argument(
        "-q", "--min-qcov-per-hsp", type=float, default=SearchDefaults.MIN_QCOV_PER_HSP
    )
    ps.add_argument(
        "-Q", "--min-qcov-per-genome", type=float, default=SearchDefaults.MIN_QCOV_PER_GENOME
    )
    ps.add_argument("-e", "--max-evalue", type=float, default=SearchDefaults.MAX_EVALUE)
    ps.add_argument("-T", "--taxdump", default="")
    ps.add_argument("-G", "--genome2taxid", default="")
    ps.add_argument("-t", "--taxids", action="append", default=[])
    ps.add_argument("--taxid-file", default="")
    ps.add_argument(
        "-K", "--keep-genomes-without-taxid", action="store_true",
        help="keep genomes lacking a taxid in the genome2taxid file",
    )
    ps.set_defaults(func=cmd_search)

    from .cli_genome import register_genome
    from .cli_utils import register_utils

    register_utils(sub)
    register_genome(sub)
    return p


class _TeeStream:
    """Duplicate writes to a second stream (for --log FILE)."""

    def __init__(self, primary, secondary):
        self._a = primary
        self._b = secondary

    def write(self, s):
        self._a.write(s)
        self._b.write(s)
        return len(s)

    def flush(self):
        self._a.flush()
        self._b.flush()

    def __getattr__(self, name):
        return getattr(self._a, name)


def _walk_parser_actions(parser):
    """(subcommand path, option strings) pairs for completion generation."""
    out = {"": []}
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            for name, sp in a.choices.items():
                for path, opts in _walk_parser_actions(sp).items():
                    out[(name + " " + path).strip()] = opts
        else:
            out[""].extend(a.option_strings)
    return out


def cmd_autocompletion(args) -> int:
    """Emit a completion script for the requested shell.

    Mirrors `lexicmap autocompletion` (ref: autocomplete.go:32-99), generated
    from the port's argparse tree instead of Cobra.
    """
    tree = _walk_parser_actions(build_parser())
    # group: path -> subcommands at that level, and path -> flags
    subs: dict[str, list[str]] = {}
    for path in tree:
        if not path:
            continue
        parts = path.split()
        parent = " ".join(parts[:-1])
        subs.setdefault(parent, []).append(parts[-1])
    if args.shell == "bash":
        # case patterns must be UNQUOTED for globs to match; spaces in
        # multi-word paths are replaced by '*'; deeper paths first so that
        # e.g. "genome search" wins over "search"
        def _depth_first(items):
            return sorted(items, key=lambda kv: (len(kv[0].split()), kv[0]), reverse=True)

        cases = []
        for parent, names in _depth_first(subs.items()):
            pat = "*" if not parent else "*" + parent.replace(" ", "*") + "*"
            cases.append(f'        {pat}) words="{" ".join(sorted(set(names)))}" ;;')
        flag_cases = []
        for path, opts in _depth_first(tree.items()):
            if not path or not opts:
                continue
            pat = "*" + path.replace(" ", "*") + "*"
            flag_cases.append(
                f'        {pat}) flags="{" ".join(sorted(set(opts)))}" ;;'
            )
        print(f"""# bash completion for lexicmap-tpu-torch; source this file
_lexicmap_tpu_torch() {{
    local cur words flags
    cur="${{COMP_WORDS[COMP_CWORD]}}"
    words="" flags=""
    case "${{COMP_WORDS[*]}}" in
{chr(10).join(flag_cases)}
    esac
    case "${{COMP_WORDS[*]}}" in
{chr(10).join(cases)}
    esac
    if [[ "$cur" == -* ]]; then
        COMPREPLY=($(compgen -W "$flags" -- "$cur"))
    else
        COMPREPLY=($(compgen -W "$words" -- "$cur"))
    fi
}}
complete -o default -F _lexicmap_tpu_torch lexicmap-tpu-torch""")
    elif args.shell == "zsh":
        print("# zsh: use bashcompinit\nautoload -U +X bashcompinit && bashcompinit")
        print("# then source the bash script: lexicmap-tpu-torch autocompletion --shell bash")
    else:
        names = sorted(set(n for ns in subs.values() for n in ns))
        print(f"complete -c lexicmap-tpu-torch -a \"{' '.join(names)}\"")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.quiet = getattr(args, "quiet", False) or args.root_quiet  # `genome` has no --quiet
    if not args.log:
        return args.func(args)
    saved = sys.stderr
    with open(args.log, "a") as fh:
        sys.stderr = _TeeStream(saved, fh)
        try:
            return args.func(args)
        finally:
            sys.stderr = saved


if __name__ == "__main__":
    sys.exit(main())
