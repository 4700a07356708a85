"""The port's `utils` subcommands against the JAX package's, in process:
for each of the 16 subcommands the same argv runs under both CLIs on the
same index, and the port's stdout and every file it writes must be
byte-equal to the JAX subcommand's.  The subcommands that edit an index in
place run on a copy of it for each CLI.  Twins of tests/test_cli_utils.py's
ten tests, plus `remerge`, `import-index` and `export-index`."""

import os
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from torch_parity import tree_bytes
from torch_parity import one_intra_op_thread  # noqa: F401  (autouse fixture)

from lexicmap_tpu import cli as jcli
from lexicmap_tpu.index.build import BuildOptions, build_index
from lexicmap_tpu_torch import cli as tcli
from lexicmap_tpu_torch.utils.kmers import revcomp_seq


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """tests/test_cli_utils.py's index: two genomes of two contigs each."""
    rng = np.random.default_rng(31)
    d = tmp_path_factory.mktemp("urefs")
    files, genomes = [], {}
    for i in range(2):
        name = f"U{i:03d}"
        contigs = [
            bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=20000)),
            bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=10000)),
        ]
        genomes[name] = contigs
        p = d / f"{name}.fasta"
        with open(p, "wb") as fh:
            for j, s in enumerate(contigs):
                fh.write(b">" + f"seq{j}".encode() + b"\n" + s + b"\n")
        files.append(str(p))
    out = str(tmp_path_factory.mktemp("udb") / "u.lmt")
    build_index(out, files, BuildOptions(k=31, n_masks=256, chunks=2, save_seed_pos=True))
    return out, genomes, files


def twin(capsys, tmp_path, argv, index=None):
    """Run `argv(d, db)` under the JAX CLI and then the port's, each with
    its own directory `d` for what it writes and, with `index`, its own copy
    `db` of that index (or index plus its `.tmp`) inside `d`.  Asserts that
    the exit codes, stdout (with `d` written as <d>) and every file under
    `d` are equal, and returns the port's."""
    got = []
    for name, cli in (("jax", jcli), ("torch", tcli)):
        d = tmp_path / name
        d.mkdir(parents=True)
        db = None
        if index is not None:
            db = str(d / os.path.basename(index))
            shutil.copytree(index, db)
            if os.path.isdir(index + ".tmp"):
                shutil.copytree(index + ".tmp", db + ".tmp")
        rc = cli.main(argv(str(d), db))
        out = capsys.readouterr().out.replace(str(d), "<d>")
        got.append((rc, out, tree_bytes(str(d))))
    assert got[0][0] == got[1][0]
    assert got[0][1] == got[1][1]
    assert sorted(got[0][2]) == sorted(got[1][2])
    for path in got[0][2]:
        assert got[0][2][path] == got[1][2][path], path
    return got[1]


def test_utils_genomes(db, tmp_path, capsys):
    out, _, _ = db
    rc, stdout, _ = twin(capsys, tmp_path / "a", lambda d, _: ["utils", "genomes", "-d", out])
    assert rc == 0 and stdout.split() == ["U000", "U001"]
    _, _, files = twin(capsys, tmp_path / "e",
                       lambda d, _: ["utils", "genomes", "-d", out, "-e", "-o", f"{d}/g.tsv"])
    assert files["g.tsv"].decode().splitlines()[0].split("\t") == ["U000", "30000", "2"]


def test_utils_genome_seqs(db, tmp_path, capsys):
    out, genomes, _ = db
    rc, stdout, _ = twin(capsys, tmp_path / "a",
                         lambda d, _: ["utils", "genome-seqs", "-d", out, "-n", "U001"])
    lines = stdout.split("\n")
    assert rc == 0 and lines[0] == ">seq0"
    seq = "".join(s for s in lines[1:] if s and not s.startswith(">"))
    assert seq.encode() == genomes["U001"][0] + genomes["U001"][1]
    _, _, files = twin(capsys, tmp_path / "o", lambda d, _: [
        "utils", "genome-seqs", "-d", out, "-n", "U000", "-o", f"{d}/g.fa.gz"])
    assert len(files["g.fa.gz"]) > 1000
    rc, _, _ = twin(capsys, tmp_path / "x",
                    lambda d, _: ["utils", "genome-seqs", "-d", out, "-n", "nope"])
    assert rc == 1


@pytest.mark.parametrize("more", [[], ["-a"]], ids=["default", "more_columns"])
def test_utils_genome_details(db, tmp_path, capsys, more):
    out, _, _ = db
    _, _, files = twin(capsys, tmp_path, lambda d, _: [
        "utils", "genome-details", "-d", out, "-o", f"{d}/g.tsv", *more])
    lines = files["g.tsv"].decode().strip().split("\n")
    assert lines[0].startswith("ref\tgenome_size")
    f = lines[1].split("\t")
    assert f[0] == "U000" and f[1] == "30000" and f[7] == "2"
    if more:
        assert f[8:] == ["20000,10000", "seq0,seq1"]


@pytest.mark.parametrize("argv", [
    ["-n", "U000", "-s", "seq1", "-r", "101:150"],
    ["-n", "U000", "-s", "seq1", "-r", "101:150", "-R"],
    ["-n", "U001", "-s", "seq0", "-r", "19950:-1", "-U", "30", "-D", "70", "-w", "25"],
    ["-n", "U001", "-r", "5:40"],
    ["-n", "U001", "-r", "50:40"],
    ["-n", "U001", "-s", "seqX", "-r", "1:40"],
], ids=["region", "revcom", "flanks_to_end", "whole_genome", "start_after_end", "bad_seq_id"])
def test_utils_subseq(db, tmp_path, capsys, argv):
    out, genomes, _ = db
    rc, stdout, _ = twin(capsys, tmp_path, lambda d, _: ["utils", "subseq", "-d", out, *argv])
    lines = stdout.strip().split("\n")
    body = "".join(lines[1:]).encode()
    if argv[-1] == "101:150":
        assert rc == 0 and lines[0] == ">seq1:101-150:+"
        assert body == genomes["U000"][1][100:150]
    elif argv[-1] == "-R":
        assert rc == 0 and body == revcomp_seq(genomes["U000"][1][100:150])
    elif "-U" in argv:
        assert rc == 0 and lines[0] == ">seq0:19920-20000:+"
        assert body == genomes["U001"][0][19919:]
    elif argv[-1] == "5:40":
        assert rc == 0 and body == genomes["U001"][0][4:40]
    else:
        assert rc == 1 and stdout == ""


def test_utils_masks(db, tmp_path, capsys):
    out, _, _ = db
    rc, stdout, _ = twin(capsys, tmp_path / "i", lambda d, _: ["utils", "masks", "-d", out])
    lines = stdout.strip().split("\n")
    assert rc == 0 and len(lines) == 256
    assert lines[0].split("\t")[0] == "1" and len(lines[0].split("\t")[1]) == 31
    # generated masks, one of them alone, and to a file
    rc, stdout, _ = twin(capsys, tmp_path / "g", lambda d, _: [
        "utils", "masks", "-k", "21", "-m", "300", "-s", "5", "-p", "2", "--mask", "7"])
    assert rc == 0 and stdout.startswith("7\t") and len(stdout.split("\t")[1].strip()) == 21
    _, _, files = twin(capsys, tmp_path / "f", lambda d, _: [
        "utils", "masks", "-m", "64", "-o", f"{d}/m.tsv"])
    assert files["m.tsv"].count(b"\n") == 64


@pytest.mark.parametrize("argv", [["-m", "3"], ["-m", "200", "-f"], ["-m", "256"]],
                         ids=["mask3", "only_forward", "last_mask"])
def test_utils_kmers(db, tmp_path, capsys, argv):
    out, _, _ = db
    _, _, files = twin(capsys, tmp_path, lambda d, _: [
        "utils", "kmers", "-d", out, "-o", f"{d}/k.tsv", *argv])
    lines = files["k.tsv"].decode().strip().split("\n")
    assert lines[0].startswith("mask\tkmer\tprefix") and len(lines) > 1
    f = lines[1].split("\t")
    assert f[0] == argv[1] and len(f[1]) == 31
    assert f[6] in ("+", "-") and f[7] in ("yes", "no")
    if "-f" in argv:
        assert all(r.split("\t")[7] == "no" for r in lines[1:])


@pytest.mark.parametrize("argv", [["-n", "U000"], [], ["--histogram"],
                                  ["-n", "U001", "--plot-dir", "plots"]],
                         ids=["one_genome", "all", "histogram", "plot_dir"])
def test_utils_seed_pos(db, tmp_path, capsys, argv):
    """The TSVs are equal; with --plot-dir the plots have the same names
    (their PNG bytes are not compared)."""
    out, _, _ = db
    got = []
    for name, cli in (("jax", jcli), ("torch", tcli)):
        d = tmp_path / name
        d.mkdir()
        a = [str(d / x) if x == "plots" else x for x in argv]
        rc = cli.main(["utils", "seed-pos", "-d", out, "-o", str(d / "s.tsv"), *a])
        assert rc == 0 and capsys.readouterr().out == ""
        got.append(((d / "s.tsv").read_bytes(), sorted(os.listdir(d))))
        if "--plot-dir" in argv:
            got[-1] += (sorted(os.listdir(d / "plots")),)
    assert got[0] == got[1]
    lines = got[1][0].decode().strip().split("\n")
    if "--histogram" in argv:
        assert lines[0] == "ref\tdist_bin\tcount" and len(lines) > 4
    else:
        assert lines[0] == "ref\tpos\tstrand\tafter_interval" and len(lines) > 50
    if "--plot-dir" in argv:
        assert got[1][2] == ["U001.png", "U001.seed_number.png"]


def test_utils_seed_pos_without_positions(tmp_path, capsys, db):
    """An index built without --save-seed-pos: both exit 1 with the header
    written."""
    src = str(tmp_path / "n.lmt")
    build_index(src, db[2], BuildOptions(k=31, n_masks=64, chunks=1))
    rc, _, files = twin(capsys, tmp_path, lambda d, _: [
        "utils", "seed-pos", "-d", src, "-o", f"{d}/s.tsv"])
    assert rc == 1 and files["s.tsv"] == b"ref\tpos\tstrand\tafter_interval\n"


def test_utils_edit_genome_ids(db, tmp_path, capsys):
    out, _, _ = db
    rc, stdout, files = twin(capsys, tmp_path / "dry", lambda d, db: [
        "utils", "edit-genome-ids", "-d", db, "-p", "^U", "-r", "G", "--dry-run"], index=out)
    assert rc == 0 and stdout == "U000 -> G000\nU001 -> G001\n"
    assert files == {os.path.join("u.lmt", p): b for p, b in tree_bytes(out).items()}
    rc, _, files = twin(capsys, tmp_path / "edit", lambda d, db: [
        "utils", "edit-genome-ids", "-d", db, "-p", "^U(\\d)", "-r", "G\\1x"], index=out)
    assert rc == 0 and b"G0x00\t" in files[os.path.join("u.lmt", "genomes.map.tsv")]
    rc = tcli.main(["utils", "genomes", "-d", str(tmp_path / "edit" / "torch" / "u.lmt")])
    assert rc == 0 and capsys.readouterr().out.split() == ["G0x00", "G0x01"]


def test_utils_recount_and_reindex(db, tmp_path, capsys):
    import json

    out, _, _ = db
    rc, _, files = twin(capsys, tmp_path / "recount",
                        lambda d, db: ["utils", "recount-bases", "-d", db], index=out)
    info = json.loads(files[os.path.join("u.lmt", "info.json")])
    assert rc == 0 and info["input_bases"] == 60000
    rc, _, files = twin(capsys, tmp_path / "reindex", lambda d, db: [
        "utils", "reindex-seeds", "-d", db, "--partitions", "512"], index=out)
    assert rc == 0 and json.loads(files[os.path.join("u.lmt", "info.json")])["partitions"] == 512
    # the rebuilt lookup tables are the built ones
    for path, b in tree_bytes(out).items():
        if path.endswith("mask_offsets.npy"):
            assert files[os.path.join("u.lmt", path)] == b, path


def test_utils_remerge(db, tmp_path, capsys, monkeypatch):
    """An index whose merge was interrupted (the build's tmp directory kept)
    is merged by `utils remerge` into the same tree under both CLIs, and
    that tree is the uninterrupted build's; without a tmp directory both
    exit 1."""
    import lexicmap_tpu.index.merge as MG

    opt = BuildOptions(k=31, n_masks=256, chunks=2, batch_size=1)
    whole = str(tmp_path / "whole" / "r.lmt")
    build_index(whole, db[2], opt)
    broken = str(tmp_path / "broken" / "r.lmt")

    def crash(tmp_dir, outdir, n_chunks):
        raise RuntimeError("simulated crash during merge")

    with monkeypatch.context() as m:
        m.setattr(MG, "merge_batches", crash)
        with pytest.raises(RuntimeError):
            build_index(broken, db[2], opt)
    assert os.path.isdir(broken + ".tmp")
    rc, _, files = twin(capsys, tmp_path / "run",
                        lambda d, db: ["utils", "remerge", "-d", db], index=broken)
    assert rc == 0 and not any(p.startswith("r.lmt.tmp") for p in files)
    assert files == {os.path.join("r.lmt", p): b for p, b in tree_bytes(whole).items()}
    rc, _, _ = twin(capsys, tmp_path / "again",
                    lambda d, db: ["utils", "remerge", "-d", db], index=whole)
    assert rc == 1


def test_utils_import_export_index(db, tmp_path, capsys):
    """`utils export-index`, then `utils import-index` of the JAX export,
    with and without the exported masks text file: equal trees."""
    out, _, _ = db
    _, stdout, files = twin(capsys, tmp_path / "exp", lambda d, _: [
        "utils", "export-index", "-d", out, "-O", f"{d}/ref.lmi"])
    assert "exported seed chunk 1" in stdout and os.path.join("ref.lmi", "info.toml") in files
    ref = str(tmp_path / "exp" / "jax" / "ref.lmi")
    for masks in ([], ["-M", f"{ref}/masks.tsv"]):
        _, stdout, files = twin(capsys, tmp_path / f"imp{len(masks)}", lambda d, _: [
            "utils", "import-index", "-d", ref, "-O", f"{d}/n.lmt", *masks])
        assert "imported genome batch 0 (2 genomes)" in stdout
        for path, b in tree_bytes(out).items():
            if path.startswith("seeds") or path == "masks.bin":
                assert files[os.path.join("n.lmt", path)] == b, path


@pytest.fixture(scope="module")
def tsvs(db, tmp_path_factory):
    """`search -a` TSVs of two queries (one over both contigs' ends): the
    port's host and device engines (device on the CPU) and the JAX host
    engine, which must be equal."""
    out, genomes, _ = db
    d = tmp_path_factory.mktemp("utsv")
    q = d / "q.fa"
    q.write_bytes(b">q1\n" + genomes["U000"][0][2000:3000] + b"\n>q2\n"
                  + genomes["U001"][0][-700:] + genomes["U001"][1][:600] + b"\n")
    got = {}
    for name, cli, engine in (("jax", jcli, ["--engine", "host"]),
                              ("host", tcli, ["--engine", "host"]),
                              ("device", tcli, ["--engine", "device", "--device", "cpu"])):
        path = str(d / f"{name}.tsv")
        assert cli.main(["search", "--quiet", "-d", out, str(q), "-o", path, "-a",
                         *engine]) == 0
        got[name] = path
    texts = {n: open(p).read() for n, p in got.items()}
    assert texts["jax"] == texts["host"] == texts["device"]
    assert texts["host"].count("\n") >= 4
    short = str(d / "short.tsv")  # 20 columns: refused by 2blast and 2sam
    with open(short, "w") as fh:
        fh.writelines("\t".join(r.split("\t")[:20]) + "\n"
                      for r in texts["host"].splitlines())
    kv = str(d / "kv.tsv")
    with open(kv, "w") as fh:
        fh.write("U000\tEscherichia coli\nU001\tsome genome\n")
    return got, short, kv


@pytest.mark.parametrize("tool, extra", [
    ("2blast", []), ("2blast", ["-w", "37", "-g", "KV"]), ("2sam", []), ("2sam", ["--no-x"]),
    ("subseq", ["-d", "DB", "-t"]), ("subseq", ["-d", "DB", "-U", "5", "-w", "50", "-t"]),
    ("merge-search-results", []), ("merge-search-results", ["-q", "q2"]),
], ids=["2blast", "2blast_width_kv", "2sam", "2sam_no_x", "subseq_tsv", "subseq_tsv_flanks",
        "merge", "merge_one_query"])
def test_search_then_2blast_2sam_and_subseq_tsv(db, tsvs, tmp_path, capsys, tool, extra):
    """The TSV tools on the device engine's TSV (which equals both host
    engines'); merge-search-results over two TSVs and an -X list of one."""
    got, short, kv = tsvs
    a = [{"DB": db[0], "KV": kv}.get(x, x) for x in extra]
    if tool == "merge-search-results":
        lst = tmp_path / "list.txt"
        lst.write_text(got["host"] + "\n")
        argv = lambda d, _: ["utils", tool, got["device"], got["jax"], "-X", str(lst), *a]
    else:
        argv = lambda d, _: ["utils", tool, *a, got["device"]]
    rc, stdout, _ = twin(capsys, tmp_path, argv)
    assert rc == 0
    if tool == "2blast":
        assert "Query = q1" in stdout and "Sbjct" in stdout
        assert ("Escherichia coli" in stdout) == ("-g" in extra)
    elif tool == "2sam":
        assert stdout.startswith("@HD")
        body = [r for r in stdout.split("\n") if r and not r.startswith("@")]
        f = body[0].split("\t")
        assert f[0] == "q1" and f[2] == "seq0" and "NM:i:" in body[0]
    elif tool == "subseq":
        assert stdout.startswith(">seq0:") and " query=q1 " in stdout
    else:
        lines = stdout.split("\n")
        assert lines[0].startswith("query\t")
        assert {r.split("\t")[0] for r in lines[1:] if r} == ({"q2"} if extra else {"q1", "q2"})
    if tool in ("2blast", "2sam"):
        rc, stdout, _ = twin(capsys, tmp_path / "short", lambda d, _: ["utils", tool, short])
        assert rc == 1
