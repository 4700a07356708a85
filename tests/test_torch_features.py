"""Host features of the port against the JAX package, on
tests/test_features.py's cases: the shared-k-mer threshold, degenerate
query bases, soft-masking, in-memory mode and a cross-contig query, each
through the port's host engine and its device engine (the kernels' plain
twins on the CPU) with the JAX host engine's rows; and the port's CLI:
`search --engine auto` without a CUDA device, the default device engine
with `--device cpu`, and `index --engine device --device cpu`."""

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
from lexicmap_tpu_torch import cli as tcli
from lexicmap_tpu_torch.index.build import BuildOptions, build_index
from lexicmap_tpu_torch.index.search import IndexSearcher, SearchOptions


def random_seq(rng, n):
    return bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=n))


def write_fasta(path, records):
    with open(path, "wb") as fh:
        for name, seq in records:
            fh.write(b">" + name + b"\n" + seq + b"\n")
    return str(path)


def engines_hits(db, query, **opt):
    """The port's host engine's hits, after holding its rows and the device
    engine's equal to the JAX host engine's."""
    want = list(jax_rows("q", 0, JaxSearcher(db, JaxOptions(engine="host", **opt))
                         .search_bytes(query)))
    hits = IndexSearcher(db, SearchOptions(engine="host", **opt)).search_bytes(query)
    dev = IndexSearcher(db, SearchOptions(engine="device", device="cpu", **opt))
    assert rows_of(hits) == want and want
    assert rows_of(dev.search_many([query])[0]) == want
    return hits


def test_min_shared_kmers_threshold():
    from lexicmap_tpu.index.gsearch import min_shared_kmers_threshold as jax_threshold
    from lexicmap_tpu_torch.index.gsearch import min_shared_kmers_threshold

    # mu = (1020-13+1)*0.95^13/4 = 252*0.513 ≈ 129; T = 129 - 1.645*11.4 ≈ 110
    t = min_shared_kmers_threshold(1020, 13, 4, 0.95)
    assert 100 < t < 125
    assert min_shared_kmers_threshold(50, 13, 1000, 0.5) == 1  # clamped
    for args in ((1020, 13, 4, 0.95), (50, 13, 1000, 0.5), (5000, 21, 16, 0.9),
                 (100_000, 31, 1, 0.99), (12, 13, 4, 0.95)):
        assert min_shared_kmers_threshold(*args) == jax_threshold(*args), args


def test_degenerate_base_query(tmp_path):
    rng = np.random.default_rng(8)
    seq = random_seq(rng, 40000)
    db = str(tmp_path / "g.lmt")
    build_index(db, [write_fasta(tmp_path / "g.fasta", [(b"c0", seq)])],
                BuildOptions(k=31, n_masks=256, chunks=2))
    # query with N's and degenerate codes still matches (N -> A like the ref)
    q = bytearray(seq[5000:6200])
    q[100] = ord("N")
    q[200] = ord("R")
    q[300] = ord("y")
    hits = engines_hits(db, bytes(q))
    assert hits[0].details[0].chains[0].aligned_fraction > 95


def test_soft_masking_build(tmp_path):
    """The port's soft-masked build is JAX's, byte for byte; a query over
    the masked region aligns through both engines."""
    rng = np.random.default_rng(9)
    seq = bytearray(random_seq(rng, 40000))
    seq[10000:12000] = bytes(seq[10000:12000]).lower()
    fa = write_fasta(tmp_path / "s.fasta", [(b"c0", bytes(seq))])
    db, jdb = str(tmp_path / "soft.lmt"), str(tmp_path / "jsoft.lmt")
    build_index(db, [fa], BuildOptions(k=31, n_masks=256, chunks=2, soft_masking=True))
    jax_build(jdb, [fa], JaxBuildOptions(k=31, n_masks=256, chunks=2, soft_masking=True))
    assert tree_bytes(db) == tree_bytes(jdb)
    assert IndexSearcher(db, SearchOptions()).info.soft_masking
    hits = engines_hits(db, bytes(seq[9000:13000]).upper())
    assert hits[0].aligned_fraction > 90  # qcovGnm via the union of HSPs
    for sd in hits[0].details:
        for c in sd.chains:
            assert c.pident > 99.0


def test_in_memory_mode(tmp_path):
    rng = np.random.default_rng(10)
    seq = random_seq(rng, 30000)
    db = str(tmp_path / "m.lmt")
    build_index(db, [write_fasta(tmp_path / "m.fasta", [(b"c0", seq)])],
                BuildOptions(k=31, n_masks=256, chunks=2))
    assert isinstance(IndexSearcher(db, SearchOptions(in_memory=True)).chunks[0].kmers,
                      np.ndarray)
    q = seq[2000:3500]
    want = rows_of(engines_hits(db, q, in_memory=False))
    assert rows_of(engines_hits(db, q, in_memory=True)) == want


def test_cross_contig_query_splits_hsps(tmp_path):
    """A query stitched from the end of contig0 + start of contig1 gives
    HSPs on BOTH contigs with in-contig coordinates (ref:
    lib-index-search.go:2113-2158)."""
    rng = np.random.default_rng(12)
    c0, c1 = random_seq(rng, 30000), random_seq(rng, 30000)
    db = str(tmp_path / "x.lmt")
    build_index(db, [write_fasta(tmp_path / "x.fasta", [(b"ctgA", c0), (b"ctgB", c1)])],
                BuildOptions(k=31, n_masks=256, chunks=2))
    hits = engines_hits(db, c0[-1500:] + c1[:1500])
    assert {sd.seq_id for sd in hits[0].details} == {b"ctgA", b"ctgB"}
    for sd in hits[0].details:
        for c in sd.chains:
            assert c.pident > 99.0
            assert 0 <= c.tbegin <= c.tend < 30000
            if sd.seq_id == b"ctgA":
                assert c.tbegin >= 28000
            else:
                assert c.tend <= 2000
    assert hits[0].aligned_fraction > 95


def test_cli_engine_auto_and_device_build(tmp_path, capsys, monkeypatch):
    """`index --engine device --device cpu` builds the host build's tree,
    byte for byte; without a CUDA device `search --engine auto` is the
    host engine, and the default engine (device) with `--device cpu`
    writes the same TSV."""
    import torch

    rng = np.random.default_rng(41)
    seq = random_seq(rng, 60000)
    f = write_fasta(tmp_path / "g.fasta", [(b"c0", seq)])
    db_h, db_d = str(tmp_path / "h.lmt"), str(tmp_path / "d.lmt")
    assert tcli.main(["--quiet", "index", "-O", db_h, "--force", "-m", "256", f]) == 0
    assert tcli.main(["--quiet", "index", "-O", db_d, "--force", "-m", "256", "--engine",
                      "device", "--device", "cpu", f]) == 0
    assert tree_bytes(db_h) == tree_bytes(db_d)

    q = write_fasta(tmp_path / "q.fasta", [(b"q", seq[10000:11500])])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    capsys.readouterr()
    out = str(tmp_path / "r.tsv")
    assert tcli.main(["search", "-d", db_h, q, "-o", out, "--engine", "auto"]) == 0
    assert "engine: host [auto]" in capsys.readouterr().err
    rows = open(out).read().strip().splitlines()
    assert len(rows) >= 2 and "\tg\t" in rows[1]
    out2 = str(tmp_path / "r2.tsv")
    assert tcli.main(["search", "-d", db_h, q, "-o", out2, "--device", "cpu"]) == 0
    assert "engine: device" in capsys.readouterr().err
    assert open(out2).read() == open(out).read()
