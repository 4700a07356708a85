"""TaxId-filtered search in the port against the JAX package, on
tests/test_taxid.py's synthetic NCBI-style taxdump: the port's taxonomy
(lineage, LCA, taxid arguments) equals JAX's, and under each filter the
port's host engine and its device engine (the kernels' plain twins on the
CPU; the filter runs in phase 2b's numpy tail on the device matcher's
triples) give the JAX host engine's rows."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from torch_parity import rows_of
from torch_parity import one_intra_op_thread  # noqa: F401  (autouse fixture)

from lexicmap_tpu.cli import format_hit_rows as jax_rows
from lexicmap_tpu.index.build import BuildOptions, build_index
from lexicmap_tpu.index.search import IndexSearcher as JaxSearcher
from lexicmap_tpu.index.search import SearchOptions as JaxOptions
from lexicmap_tpu.utils import taxonomy as jtax
from lexicmap_tpu_torch.index.search import IndexSearcher, SearchOptions
from lexicmap_tpu_torch.utils.kmers import seq_to_codes
from lexicmap_tpu_torch.utils.taxonomy import Taxonomy, parse_taxid_args


def test_taxonomy_lineage_lca(tmp_path):
    nodes = tmp_path / "nodes.dmp"
    #      1
    #     / \
    #    2   3
    #   / \    \
    #  4   5    6
    nodes.write_text(
        "1\t|\t1\t|\tno rank\t|\n"
        "2\t|\t1\t|\tsuperkingdom\t|\n"
        "3\t|\t1\t|\tsuperkingdom\t|\n"
        "4\t|\t2\t|\tspecies\t|\n"
        "5\t|\t2\t|\tspecies\t|\n"
        "6\t|\t3\t|\tspecies\t|\n"
    )
    tax = Taxonomy.from_taxdump(str(tmp_path))
    jt = jtax.Taxonomy.from_taxdump(str(tmp_path))
    assert tax.lineage(4) == [4, 2, 1]
    assert tax.is_descendant_or_self(4, 2)
    assert tax.is_descendant_or_self(4, 4)
    assert not tax.is_descendant_or_self(4, 3)
    assert tax.lca(4, 5) == 2
    assert tax.lca(4, 6) == 1
    for a in range(1, 7):
        assert tax.lineage(a) == jt.lineage(a)
        for b in range(1, 7):
            assert tax.lca(a, b) == jt.lca(a, b)
            assert tax.is_descendant_or_self(a, b) == jt.is_descendant_or_self(a, b)


def test_parse_taxid_args(tmp_path):
    f = tmp_path / "taxids.txt"
    f.write_text("7\n-8\n")
    pos, neg = parse_taxid_args(["1,2", "-3", "2"], str(f))
    assert pos == [1, 2, 7]
    assert neg == [3, 8]
    for args in (["1,2", "-3", "2"], [], ["-5,-6", "5"]):
        assert parse_taxid_args(args, str(f)) == jtax.parse_taxid_args(args, str(f))


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """tests/test_taxid.py's index: three genomes sharing a 1.5 kb region,
    two genera of two and one species."""
    rng = np.random.default_rng(55)
    genomes = {}
    for i in range(3):
        genomes[f"T{i:03d}"] = bytes(
            rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=40000))
    common = genomes["T000"][1000:2500]
    d = tmp_path_factory.mktemp("trefs")
    files = []
    for name, seq in genomes.items():
        seq = bytearray(seq)
        seq[5000:5000 + len(common)] = common
        p = d / f"{name}.fasta"
        p.write_bytes(b">c0\n" + bytes(seq) + b"\n")
        files.append(str(p))
    out = str(tmp_path_factory.mktemp("tdb") / "t2.lmt")
    build_index(out, files, BuildOptions(k=31, n_masks=256, chunks=2))
    taxdir = tmp_path_factory.mktemp("taxdump")
    (taxdir / "nodes.dmp").write_text(
        "1\t|\t1\t|\tno rank\t|\n"
        "10\t|\t1\t|\tgenus\t|\n"
        "11\t|\t10\t|\tspecies\t|\n"
        "12\t|\t10\t|\tspecies\t|\n"
        "20\t|\t1\t|\tgenus\t|\n"
        "21\t|\t20\t|\tspecies\t|\n"
    )
    g2t = taxdir / "g2t.tsv"
    g2t.write_text("T000\t11\nT001\t12\nT002\t21\n")
    return out, common, dict(taxdump_dir=str(taxdir), genome2taxid_file=str(g2t))


def genomes_hit(out, query, **opt):
    """The genomes of the JAX host engine's rows under `opt`, after holding
    the port's host and device engines' rows equal to them."""
    want = list(jax_rows("q", 0, JaxSearcher(out, JaxOptions(engine="host", **opt))
                         .search_bytes(query)))
    host = IndexSearcher(out, SearchOptions(engine="host", **opt))
    dev = IndexSearcher(out, SearchOptions(engine="device", device="cpu", **opt))
    assert rows_of(host.search_bytes(query)) == want
    assert rows_of(dev.search_many([query])[0]) == want
    assert rows_of(dev.search_bytes(query)) == want  # the single-query matcher
    return {r.split("\t")[3] for r in want}


def test_taxid_whitelist(db):
    out, common, base = db
    assert genomes_hit(out, common) == {"T000", "T001", "T002"}
    assert genomes_hit(out, common, taxids=[10], **base) == {"T000", "T001"}
    assert genomes_hit(out, common, taxids=[21], **base) == {"T002"}
    assert genomes_hit(out, common, taxids=[10], negative_taxids=[12], **base) == {"T000"}


def test_taxid_blacklist(db):
    out, common, base = db
    assert genomes_hit(out, common, negative_taxids=[10], keep_genomes_without_taxid=True,
                       **base) == {"T002"}
    assert genomes_hit(out, common, negative_taxids=[11, 21], keep_genomes_without_taxid=True,
                       **base) == {"T001"}


def test_genome_codes_whitelist(db):
    out, common, _ = db
    codes = seq_to_codes(common)
    jidx = JaxSearcher(out, JaxOptions(engine="host"))
    for allowed in ({1}, {0, 2}):
        want = list(jax_rows("q", 0, jidx.search(codes, genome_codes=allowed)))
        for opt in (SearchOptions(engine="host"), SearchOptions(engine="device", device="cpu")):
            assert rows_of(IndexSearcher(out, opt).search(codes, genome_codes=allowed)) == want
        assert {int(r.split("\t")[3][1:]) for r in want} == allowed
