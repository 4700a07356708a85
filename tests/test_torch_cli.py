"""The port's CLI against the JAX package's: every argv line the JAX
parser accepts for `search` and `index` (root --quiet / --log, --wfa,
--chain, --engine auto, index --max-open-files), `genome`, `utils` and
`autocompletion` parses under the port's parser too, the completion script
has the JAX script's subcommand paths, and the new flags do what they say
on the CPU."""

import re

import pytest

jax = pytest.importorskip("jax")

from torch_parity import mutated_queries, tree_bytes, write_genomes
from torch_parity import one_intra_op_thread  # noqa: F401  (autouse fixture)

from lexicmap_tpu import cli as jcli
from lexicmap_tpu.index.build import BuildOptions, build_index
from lexicmap_tpu_torch import cli as tcli

ARGV = [
    ["--quiet", "search", "-d", "db", "q.fa"],
    ["--log", "f.log", "search", "-d", "db", "q.fa"],
    ["--quiet", "--log", "f.log", "search", "-d", "db", "q.fa", "-o", "o.tsv"],
    ["index", "--max-open-files", "512", "-O", "o.lmt", "g.fa"],
    ["--quiet", "index", "-O", "o.lmt", "--max-open-files", "64", "g.fa"],
    ["search", "--wfa", "host", "-d", "db", "q.fa"],
    ["search", "--wfa", "device", "-d", "db", "q.fa"],
    ["search", "--chain", "host", "-d", "db", "q.fa"],
    ["search", "--chain", "device", "-d", "db", "q.fa"],
    ["search", "--engine", "auto", "-d", "db", "q.fa"],
    ["search", "--engine", "device", "--chain", "device", "--wfa", "device", "-d", "db", "q.fa"],
    ["search", "-a", "--engine", "host", "--wfa", "device", "--debug", "-d", "db", "q.fa"],
    ["index", "--engine", "device", "-O", "o.lmt", "g.fa"],
    ["genome", "search", "-d", "db", "g.fa"],
    ["genome", "search", "--engine", "device", "-d", "db", "-o", "o.tsv", "g.fa"],
    ["genome", "pair", "-d", "db", "-m", "256", "-f", "0.1"],
    ["genome", "compare", "a.fa", "b.fa", "-o", "o.tsv"],
    ["autocompletion", "--shell", "bash"],
    ["utils", "masks", "-d", "db", "-o", "m.tsv", "--mask", "3"],
    ["utils", "kmers", "-d", "db", "-m", "2", "-f"],
    ["utils", "genomes", "-d", "db", "-e"],
    ["utils", "genome-seqs", "-d", "db", "-n", "g1", "-o", "g.fa"],
    ["utils", "genome-details", "-d", "db", "-a"],
    ["utils", "subseq", "-d", "db", "-n", "g1", "-s", "c0", "-r", "1:100", "-R", "-U", "5"],
    ["utils", "merge-search-results", "a.tsv", "b.tsv", "-q", "q1", "-o", "m.tsv"],
    ["utils", "edit-genome-ids", "-d", "db", "-p", "^G", "-r", "g", "--dry-run"],
    ["utils", "recount-bases", "-d", "db"],
    ["utils", "reindex-seeds", "-d", "db", "--partitions", "512"],
    ["utils", "remerge", "-d", "db"],
    ["utils", "seed-pos", "-d", "db", "--histogram", "-O", "plots"],
    ["utils", "2blast", "r.tsv", "-w", "50", "-g", "kv.tsv"],
    ["utils", "import-index", "-d", "ref.lmi", "-O", "o.lmt", "-M", "masks.tsv"],
    ["utils", "export-index", "-d", "db", "-O", "ref.lmi"],
    ["utils", "2sam", "r.tsv", "--no-x", "-o", "r.sam"],
]


@pytest.mark.parametrize("argv", ARGV, ids=[" ".join(a[:4]) for a in ARGV])
def test_argv_parses_under_both_parsers(argv):
    j = jcli.build_parser().parse_args(argv)
    t = tcli.build_parser().parse_args(argv)
    assert t.cmd == j.cmd
    # the default engine differs on purpose (the port's is device)
    keys = ("wfa", "chain", "log", "max_open_files", "genome_cmd", "masks", "min_mask_fraction",
            "out_file", "files", "utils_cmd", "shell", "index", "out_dir", "mask_file", "mask",
            "histogram", "plot_dir", "no_x", "line_width", "partitions", "up_stream",
            "revcom") + (("engine",) if "--engine" in argv else ())
    for key in keys:
        if hasattr(j, key):
            assert getattr(t, key) == getattr(j, key), key


def test_new_flags_default_like_jax():
    t = tcli.build_parser().parse_args(["search", "-d", "db"])
    assert (t.wfa, t.chain, t.engine, t.log, t.root_quiet) == ("host", "host", "device", "", False)


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    d = tmp_path_factory.mktemp("clirefs")
    files, seqs = write_genomes(d)
    out = str(tmp_path_factory.mktemp("clidb") / "d.lmt")
    build_index(out, files, BuildOptions(k=31, n_masks=512, chunks=2))
    q = d / "q.fasta"
    qs = mutated_queries(seqs, ["D0", "D1", "D2"], 20000, 2000, 20, 3)
    q.write_bytes(b"".join(f">q{i}\n".encode() + s + b"\n" for i, s in enumerate(qs)))
    return out, str(q), files


def run(db, tmp_path, name, argv, root=()):
    o = tmp_path / f"{name}.tsv"
    rc = tcli.main([*root, "search", "-d", db[0], db[1], "-o", str(o), *argv])
    assert rc == 0
    return o.read_bytes()


def test_engine_auto_resolves_to_host_without_cuda(db, tmp_path, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    got = run(db, tmp_path, "auto", ["--engine", "auto"])
    err = capsys.readouterr().err
    assert "engine: host [auto]" in err
    assert got == run(db, tmp_path, "host", ["--engine", "host"])
    assert got.count(b"\n") > 3


def test_engine_auto_resolves_to_device_with_cuda(db, monkeypatch):
    """With a card present, auto is the device engine (stopped before the
    index loads: the CPU has no card to run it on)."""
    import torch

    from lexicmap_tpu_torch.index import search as S

    seen = {}

    class Stop(Exception):
        pass

    def fake(path, opt):
        seen["engine"], seen["device"] = opt.engine, opt.device
        raise Stop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(S, "IndexSearcher", fake)
    with pytest.raises(Stop):
        tcli.main(["--quiet", "search", "-d", db[0], db[1], "--engine", "auto"])
    assert seen == {"engine": "device", "device": "cuda"}


def test_root_quiet_and_log(db, tmp_path, capsys):
    log = tmp_path / "run.log"
    run(db, tmp_path, "quiet", ["--engine", "host"], root=["--quiet"])
    assert capsys.readouterr().err == ""
    run(db, tmp_path, "log", ["--engine", "host"], root=["--log", str(log)])
    err = capsys.readouterr().err
    assert "search parameters" in err and "processed" in err
    assert log.read_text() == err  # stderr also written to the file


def test_debug_prints_device_stage_stats(db, tmp_path, capsys):
    run(db, tmp_path, "debug", ["--engine", "device", "--device", "cpu", "--chain", "device",
                                "--wfa", "device", "--debug"], root=["--quiet"])
    err = capsys.readouterr().err
    assert "device engine phase times" in err
    # each device stage's counters, from the span recorder (the only account)
    lines = {ln.split()[0]: ln.split()[1:] for ln in err.splitlines() if ln.startswith("    ")}
    for key in ("chain.genomes", "wfa.card_pairs", "pseudo.card_windows"):
        assert float(lines[key][0]) > 0, key


@pytest.mark.parametrize("argv", [["--chain", "device"], ["--wfa", "device"],
                                  ["--chain", "device", "--wfa", "device"]],
                         ids=["chain", "wfa", "both"])
def test_cli_device_stages_equal_host(db, tmp_path, argv):
    got = run(db, tmp_path, "dev", ["--engine", "device", "--device", "cpu", *argv],
              root=["--quiet"])
    assert got == run(db, tmp_path, "host", ["--engine", "host"], root=["--quiet"])


def test_index_accepts_max_open_files(db, tmp_path):
    out = tmp_path / "x.lmt"
    rc = tcli.main(["--quiet", "index", "-O", str(out), "-m", "64", "--max-open-files", "8",
                    db[2][0]])
    assert rc == 0 and (out / "info.json").exists()


@pytest.mark.parametrize("extra", [(), ("-c", "2", "-b", "2", "--no-desert-filling")],
                         ids=["defaults", "chunks_batch_no_desert"])
def test_index_prints_jax_build_parameters(db, tmp_path, capsys, extra):
    """`index` without --quiet prints the JAX CLI's "build parameters:"
    block to stderr before the build: both CLIs' stderr are equal up to the
    closing "indexed N genomes" line (the same output path for both)."""
    out = str(tmp_path / "p.lmt")
    argv = ["index", "-O", out, "-m", "64", "--force", *extra, *db[2]]
    errs = []
    for cli in (jcli, tcli):
        assert cli.main(argv) == 0
        errs.append(capsys.readouterr().err)
    heads = [e.split("indexed 3 genomes")[0] for e in errs]
    assert all(len(h) < len(e) for h, e in zip(heads, errs))
    assert heads[0] == heads[1]
    assert heads[0].startswith("build parameters:\n  input: 3 file(s)\n")
    assert f"  output: {out}\n" in heads[0]
    assert ("(desert filling disabled)" in heads[0]) == bool(extra)
    assert tcli.main(["--quiet", *argv]) == 0
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("argv, warned", [
    (["--chain", "device"], "--chain device chains only the device engine's batches"),
    (["--wfa", "device"], "--wfa device aligns only for -a"),
    (["--wfa", "device", "-a"], None),
], ids=["chain", "wfa", "wfa_with_a"])
def test_host_engine_device_stage_warns(db, tmp_path, capsys, monkeypatch, argv, warned):
    """A device stage the host engine does not run is named on stderr, and
    no device chainer is built for it; the rows are the host engine's."""
    from lexicmap_tpu_torch.index import search as S

    built = []
    real = S.IndexSearcher.__init__

    def init(self, *a, **k):
        real(self, *a, **k)
        built.append(self.device_chainer)

    monkeypatch.setattr(S.IndexSearcher, "__init__", init)
    extra = ["-a"] if "-a" in argv else []
    got = run(db, tmp_path, "dev", ["--engine", "host", "--device", "cpu", *argv],
              root=["--quiet"])
    err = capsys.readouterr().err
    assert built == [None]
    assert (warned in err) if warned else ("warning" not in err)
    assert got == run(db, tmp_path, "host", ["--engine", "host", *extra], root=["--quiet"])


def test_index_engine_device_on_cpu_equals_host(db, tmp_path):
    """`index --engine device --device cpu` (the capture kernels' plain
    twin) writes the host engine's tree, byte for byte."""
    trees = []
    for engine in ("device", "host"):
        out = tmp_path / f"{engine}.lmt"
        argv = ["--quiet", "index", "-O", str(out), "-m", "256", "-c", "2", "--engine", engine,
                *(["--device", "cpu"] if engine == "device" else []), *db[2]]
        assert tcli.main(argv) == 0
        trees.append(tree_bytes(str(out)))
    assert trees[0] == trees[1] and len(trees[0]) > 5


def test_genome_search_engine_device_on_cpu_equals_host(db, tmp_path):
    """`genome search --engine device --device cpu` (screening through the
    device matcher's plain twin) writes the host engine's rows."""
    got = []
    for engine in ("device", "host"):
        o = tmp_path / f"g_{engine}.tsv"
        assert tcli.main(["--quiet", "genome", "search", "-d", db[0], "-o", str(o), "--engine",
                          engine, "--device", "cpu", *db[2][:2]]) == 0
        got.append(o.read_text())
    assert got[0] == got[1]
    rows = got[0].splitlines()[1:]
    assert [r.split("\t")[:2] for r in rows[:1]] == [["D0", "D0"]]


def test_genome_search_engine_device_refused_without_cuda(db, tmp_path, monkeypatch, capsys):
    """`genome search --engine device` on the card is refused without a
    CUDA device (the same refusal as `index` and `search`), and runs on the
    CPU only when `--device cpu` asks for it."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    o = tmp_path / "g.tsv"
    assert tcli.main(["--quiet", "genome", "search", "-d", db[0], "-o", str(o), "--engine",
                      "device", db[2][0]]) == 1
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--device cpu" in err and not o.exists()


def completion(cli, shell, capsys):
    assert cli.main(["autocompletion", "--shell", shell]) == 0
    return capsys.readouterr().out


def script_cases(script, var):
    """{case pattern: its words} of the bash script's `var="..."` cases."""
    return {pat: val.split() for pat, val in
            re.findall(rf'^ +(\S+)\) {var}="([^"]*)" ;;$', script, re.M)}


@pytest.mark.parametrize("shell", ["bash", "zsh", "fish"])
def test_autocompletion_like_jax(capsys, shell):
    """The port's script is the JAX script with `lexicmap-tpu` renamed: the
    same subcommand paths, in the same order; in bash each subcommand's
    case lists every flag of the port's own parser for it."""
    def rename(s):
        return s.replace("lexicmap-tpu", "lexicmap-tpu-torch").replace(
            "_lexicmap_tpu", "_lexicmap_tpu_torch")

    want = rename(completion(jcli, shell, capsys))
    got = completion(tcli, shell, capsys)
    if shell != "bash":
        assert got == want and "lexicmap-tpu-torch" in got
        if shell == "fish":
            assert {"2blast", "autocompletion", "utils"} <= set(got.replace('"', " ").split())
        return
    words = script_cases(got, "words")
    assert words == script_cases(want, "words")
    assert "utils" in words["*"] and "export-index" in words["*utils*"]
    flags = script_cases(got, "flags")
    assert list(flags) == list(script_cases(want, "flags"))
    case = re.compile(r"^ +\S+\) (words|flags)=")
    assert ([s for s in got.splitlines() if not case.match(s)]
            == [s for s in want.splitlines() if not case.match(s)])
    tree = tcli._walk_parser_actions(tcli.build_parser())
    paths = [p for p, opts in tree.items() if p and opts]
    assert len(paths) == len(flags) > 20
    for path in paths:
        assert flags["*" + path.replace(" ", "*") + "*"] == sorted(set(tree[path])), path
    assert "--device" in flags["*search*"] and "--plot-dir" in flags["*utils*seed-pos*"]
