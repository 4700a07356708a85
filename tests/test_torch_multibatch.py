"""Multi-batch indexes in the port against the JAX package, on
tests/test_multibatch.py's genomes: the port's multi-batch build is JAX's
byte for byte, its search through the host engine and the device engine
(the kernels' plain twins on the CPU) gives JAX's rows, equal to the
one-batch index's, and the port's `remerge` resumes an interrupted merge."""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from torch_parity import rows_of, tree_bytes
from torch_parity import one_intra_op_thread  # noqa: F401  (autouse fixture)

from lexicmap_tpu.cli import format_hit_rows as jax_rows
from lexicmap_tpu.index.build import BuildOptions as JaxBuildOptions
from lexicmap_tpu.index.build import build_index as jax_build
from lexicmap_tpu.index.search import IndexSearcher as JaxSearcher
from lexicmap_tpu.index.search import SearchOptions as JaxOptions
from lexicmap_tpu_torch.index.build import BuildOptions, build_index
from lexicmap_tpu_torch.index.search import IndexSearcher, SearchOptions
from lexicmap_tpu_torch.index.store import read_genome_map


def random_contigs(rng, sizes):
    return [bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=n)) for n in sizes]


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    rng = np.random.default_rng(21)
    d = tmp_path_factory.mktemp("mrefs")
    files, genomes = [], {}
    for i in range(5):
        name = f"M{i:03d}"
        contigs = random_contigs(rng, [30000, 20000])
        genomes[name] = contigs
        p = d / f"{name}.fasta"
        with open(p, "wb") as fh:
            for j, s in enumerate(contigs):
                fh.write(b">" + f"c{j}".encode() + b"\n" + s + b"\n")
        files.append(str(p))
    base = tmp_path_factory.mktemp("mdb")
    single, multi, jmulti = (str(base / n) for n in ("single.lmt", "multi.lmt", "jmulti.lmt"))
    build_index(single, files, BuildOptions(k=31, n_masks=512, rand_seed=1, chunks=2,
                                            batch_size=100))
    info2 = build_index(multi, files, BuildOptions(k=31, n_masks=512, rand_seed=1, chunks=2,
                                                   batch_size=2))
    assert info2.genome_batches == 3
    jax_build(jmulti, files, JaxBuildOptions(k=31, n_masks=512, rand_seed=1, chunks=2,
                                             batch_size=2))
    return single, multi, jmulti, genomes


def test_multibatch_search_equivalent(dbs):
    """Three batches against one: the same genomes and first chains, and
    rows equal to the JAX host engine's on the multi-batch index through
    both of the port's engines (the device engine's batch of queries spans
    every genome batch)."""
    single, multi, _, genomes = dbs
    queries = [genomes[n][0][5000:6500] for n in ["M000", "M002", "M004"]]
    queries.append(genomes["M001"][1][100:1300] + genomes["M003"][0][9000:10200])
    idx1 = IndexSearcher(single, SearchOptions(engine="host"))
    idx2 = IndexSearcher(multi, SearchOptions(engine="host"))
    dev2 = IndexSearcher(multi, SearchOptions(engine="device", device="cpu"))
    jidx = JaxSearcher(multi, JaxOptions(engine="host"))
    dev_res = dev2.search_many(queries)
    for i, q in enumerate(queries):
        r1, r2 = idx1.search_bytes(q), idx2.search_bytes(q)
        assert [h.genome_id for h in r1] == [h.genome_id for h in r2]
        for h1, h2 in zip(r1, r2):
            c1 = h1.details[0].chains[0]
            c2 = h2.details[0].chains[0]
            assert (c1.qbegin, c1.qend, c1.tbegin, c1.tend, c1.pident) == (
                c2.qbegin, c2.qend, c2.tbegin, c2.tend, c2.pident
            )
        want = list(jax_rows("q", 0, jidx.search_bytes(q)))
        assert rows_of(r2) == want and rows_of(dev_res[i]) == want and want
    assert [h.genome_id for h in dev_res[3]][:2] in ([b"M001", b"M003"], [b"M003", b"M001"])


def test_multibatch_genome_map(dbs):
    single, multi, jmulti, _ = dbs
    m1 = read_genome_map(os.path.join(single, "genomes.map.tsv"))
    m2 = read_genome_map(os.path.join(multi, "genomes.map.tsv"))
    assert [e[0] for e in m1] == [e[0] for e in m2]
    # batch codes differ: multi spreads genomes across batches
    assert {e[1] >> 17 for e in m2} == {0, 1, 2}
    got, want = tree_bytes(multi), tree_bytes(jmulti)
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path] == want[path], path


def test_remerge_resume(dbs, tmp_path, monkeypatch):
    """The port's build, its merge interrupted (the port's merge_batches
    raising), leaves its tmp directory; the port's remerge() finishes it
    into the uninterrupted build's tree, and both engines search it."""
    import lexicmap_tpu_torch.index.merge as MG

    rng = np.random.default_rng(3)
    d = tmp_path / "refs"
    d.mkdir()
    files = []
    for i in range(4):
        p = d / f"R{i}.fasta"
        p.write_bytes(b">c0\n" + random_contigs(rng, [20000])[0] + b"\n")
        files.append(str(p))
    opt = BuildOptions(k=31, n_masks=256, chunks=2, batch_size=2)
    out = str(tmp_path / "resume.lmt")

    def failing_merge(tmp_dir, outdir, n_chunks):
        raise RuntimeError("simulated crash during merge")

    with monkeypatch.context() as m:
        m.setattr(MG, "merge_batches", failing_merge)
        with pytest.raises(RuntimeError):
            build_index(out, files, opt)
    assert os.path.isdir(out + ".tmp")
    MG.remerge(out)
    assert not os.path.isdir(out + ".tmp")
    whole = str(tmp_path / "whole.lmt")
    build_index(whole, files, opt)
    assert tree_bytes(out) == tree_bytes(whole)
    q = open(files[1], "rb").read().split(b"\n")[1][2000:3200]
    host = IndexSearcher(out, SearchOptions(engine="host")).search_bytes(q)
    dev = IndexSearcher(out, SearchOptions(engine="device", device="cpu")).search_many([q])[0]
    assert host and host[0].genome_id == b"R1"
    assert rows_of(dev) == rows_of(host)
