"""The port's search path end to end (engine='device', device='cpu', with
phases 2a and 4 through the kernels' plain twins) vs the JAX package's host
engine and its DeviceSearchEngine: the TSV rows must be identical.  Also
single-query search with the device matcher, and the port's CLI."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from torch_parity import mutated_queries, rows_of, write_genomes
from torch_parity import one_intra_op_thread  # noqa: F401  (autouse fixture)

from lexicmap_tpu.index.build import BuildOptions, build_index
from lexicmap_tpu.index.search import IndexSearcher as JaxSearcher
from lexicmap_tpu.index.search import SearchOptions as JaxOptions
from lexicmap_tpu_torch import cli as tcli
from lexicmap_tpu_torch.index.search import IndexSearcher, SearchOptions
from lexicmap_tpu_torch.kernels import pseudo_align as PA
from lexicmap_tpu_torch.kernels import reverse_dispatch as RD
from lexicmap_tpu_torch.kernels.seed_locate import seed_locate, seed_locate_batch


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    files, seqs = write_genomes(tmp_path_factory.mktemp("erefs"))
    out = str(tmp_path_factory.mktemp("edb") / "d.lmt")
    build_index(out, files, BuildOptions(k=31, n_masks=512, chunks=2))
    return out, seqs, files


@pytest.fixture(scope="module")
def jax_host(db):
    return JaxSearcher(db[0], JaxOptions(engine="host"))


def queries8(seqs):
    qs = mutated_queries(seqs, ["D0", "D1", "D2"], 20000, 2000, 20, 3)
    qs += mutated_queries(seqs, ["D2", "D0"], 5000, 1500, 40, 4)
    # chimera with an indel: two genomes, two windows
    qs.append(seqs["D0"][1000:2200] + b"ACGT" * 3 + seqs["D2"][30000:31200])
    qs.append(b"ACGT")  # shorter than k: empty slot
    qs.append(bytes(np.random.default_rng(1).choice(np.frombuffer(b"ACGT", np.uint8), 1200)))
    return qs


def all_rows(results):
    return [rows_of(r, f"q{i}") for i, r in enumerate(results)]


def test_engine_matches_jax_host_and_jax_device(db, jax_host):
    _, seqs, _ = db
    qs = queries8(seqs)
    port = IndexSearcher(db[0], SearchOptions(engine="device", device="cpu"))
    before = (seed_locate_batch.launches, PA.pseudo_probe.launches, PA.pseudo_chain.launches)
    got = all_rows(port.search_many(qs))
    # CPU: the plain twins, no launch
    assert (seed_locate_batch.launches, PA.pseudo_probe.launches,
            PA.pseudo_chain.launches) == before
    want_host = all_rows([jax_host.search_bytes(q) for q in qs])
    want_dev = all_rows(JaxSearcher(db[0], JaxOptions(engine="device")).search_many(qs))
    assert got == want_host
    assert got == want_dev
    assert sum(map(len, got)) >= 6
    assert got[0] and got[0][0].split("\t")[3] == "D0"
    eng = port._device_engine
    t = eng.times
    # phase 4 answered on the device path: every window of this set
    assert t["pseudo.card_windows"] >= 6 and t["pseudo.host_windows"] == 0, t
    assert eng.blob.words.numel() > 0 and eng.pseudo.blob is eng.blob
    for key in ("match", "winprep", "pseudo", "align"):
        assert eng.times[key] > 0, key


def test_engine_across_batch_boundary(db, jax_host):
    """33 queries: two engine batches, overlapped through the finish pool."""
    _, seqs, _ = db
    qs = []
    for s in range(11):
        qs += mutated_queries(seqs, ["D0", "D1", "D2"], 2000 + 4000 * s, 1000, 10, 100 + s)
    assert len(qs) == 33
    port = IndexSearcher(db[0], SearchOptions(engine="device", device="cpu"))
    got = all_rows(port.search_many(qs))
    assert got == all_rows([jax_host.search_bytes(q) for q in qs])
    assert all(got)
    t = port._device_engine.times
    assert t["pseudo.card_windows"] >= 33 and t["pseudo.host_windows"] == 0, t


def test_reversed_dispatch_a_batch_equals_host_engine(db, jax_host):
    """Phase 2b's reversed dispatch in the device engine (its plain twin on
    the CPU; queries8 has one shorter than k and one random): the TSV rows
    equal the JAX package's host engine's over two batches, with one
    match.reverse a batch, every query's arrays taken from it (one
    anchors.reverse a query) and none dispatched on the host."""
    _, seqs, _ = db
    qs = queries8(seqs) * 5
    port = IndexSearcher(db[0], SearchOptions(engine="device", device="cpu"))
    before = RD.reverse_dispatch.launches
    got = all_rows(port.search_many(qs))
    assert got == all_rows([jax_host.search_bytes(q) for q in queries8(seqs)] * 5)
    assert sum(map(len, got)) >= 24
    c = port.spans.counts
    assert c["match.reverse"] == 2 and c["anchors.reverse_host"] == 0
    assert c["anchors.reverse"] == sum(len(q) >= 31 for q in qs)
    assert port.spans.totals["match.reverse"] <= port.spans.totals["match"]
    assert RD.reverse_dispatch.launches == before  # CPU: the plain version


def test_single_query_search_with_device_matcher(db, jax_host):
    """IndexSearcher.search (one query at a time) with the device matcher:
    the single-query kernel's plain twin per bucket; rows == host."""
    _, seqs, _ = db
    qs = queries8(seqs)
    port = IndexSearcher(db[0], SearchOptions(engine="device", device="cpu"))
    calls = []
    match = port.device_matcher.match
    port.device_matcher.match = lambda *a: calls.append(1) or match(*a)
    before = seed_locate.launches
    got = all_rows([port.search_bytes(q) for q in qs])
    assert got == all_rows([jax_host.search_bytes(q) for q in qs])
    assert len(calls) == sum(len(q) >= 31 for q in qs)
    assert seed_locate.launches == before


@pytest.mark.parametrize("starve", ["argument", "card"])
def test_store_over_budget_uploads_windows(db, jax_host, monkeypatch, starve):
    """A genome store over the device budget is not made resident: phase 4
    packs and uploads each batch's windows for the same kernels (here their
    plain twins); every window is still answered on the device path and the
    rows stay the host's.  The budget is the engine's argument, or by
    default what the card has free once the seed table is on it."""
    from lexicmap_tpu_torch.parallel import engine as E
    from lexicmap_tpu_torch.parallel.resident import store_bytes

    _, seqs, _ = db
    qs = queries8(seqs)
    port = IndexSearcher(db[0], SearchOptions(engine="device", device="cpu"))
    need = store_bytes(port.genome_stores)
    if starve == "argument":
        eng = E.DeviceSearchEngine(port, hbm_budget=need - 1)
    else:
        monkeypatch.setattr(E, "default_budget", lambda d: need - 1)
        eng = E.DeviceSearchEngine(port)
    assert eng.blob is None and eng.pseudo.blob is None
    port._device_engine = eng
    got = all_rows(port.search_many(qs))
    assert got == all_rows([jax_host.search_bytes(q) for q in qs])
    t = eng.times
    assert t["pseudo.card_windows"] >= 6 and t["pseudo.host_windows"] == 0, t
    assert E.DeviceSearchEngine(port, hbm_budget=need).blob.hbm_bytes == need


def test_many_hit_batch_path_takes_device_rows(db):
    """The threaded native call for queries with many genome hits
    (_phase4_batch_native) consumes the device chain rows: with the device
    aligner's rows it equals the per-genome path, and with every window
    answered 'none' it aligns nothing."""
    from lexicmap_tpu_torch.parallel.engine import DeviceSearchEngine

    _, seqs, _ = db
    port = IndexSearcher(db[0], SearchOptions(engine="device", device="cpu"))
    eng = DeviceSearchEngine(port)
    chimera = queries8(seqs)[-3]
    codes, valid, hits_of, pmaps, cprs, wins = eng.prepare_batch([chimera])
    hits, pmap, cpr = hits_of[0], pmaps[0], cprs[0]
    assert len(hits) == 2 and all(r[0] == "rows" for v in pmap.values() for r in v)
    batch = port._phase4_batch_native(codes[0], hits, cpr, pseudo_map=pmap, wins_map=wins[0])
    got = rows_of(port._assemble_results(codes[0], batch))
    per = [port._align_genome(codes[0], *h, cpr, pmap[g]) for g, h in enumerate(hits)]
    assert got == rows_of(port._assemble_results(codes[0], [r for r in per if r]))
    assert len(got) >= 2
    none = {g: [("none", None)] * len(v) for g, v in pmap.items()}
    assert port._phase4_batch_native(codes[0], hits, cpr, pseudo_map=none) == []


def test_blob_failure_raises(db, monkeypatch):
    """A store within budget whose resident blob cannot be built all the
    same raises out of search_many: a failure never sends the engine to
    uploading windows or to the host."""
    import torch

    from lexicmap_tpu_torch.parallel import engine as E

    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")

    monkeypatch.setattr(E, "DeviceGenomeBlob", oom)
    port = IndexSearcher(db[0], SearchOptions(engine="device", device="cpu"))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        port.search_many(queries8(db[1])[:2])


def test_pseudo_failure_propagates(db, monkeypatch):
    import torch

    _, seqs, _ = db
    port = IndexSearcher(db[0], SearchOptions(engine="device", device="cpu"))
    port.search_many(queries8(seqs)[:1])

    def boom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")

    monkeypatch.setattr(port._device_engine.pseudo, "run_batch", boom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        port.search_many(queries8(seqs)[:4])


def test_device_failure_propagates_from_search_many(db, monkeypatch):
    """A device failure in seed matching surfaces from search_many: no
    batch is answered by host bisection instead."""
    import torch

    _, seqs, _ = db
    qs = queries8(seqs)[:4]
    port = IndexSearcher(db[0], SearchOptions(engine="device", device="cpu"))

    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")

    monkeypatch.setattr(port.device_matcher, "match_batch", oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        port.search_many(qs)


DEVICE_STAGES = [{"chain_engine": "device"}, {"wfa_engine": "device"},
                 {"chain_engine": "device", "wfa_engine": "device"}]


@pytest.mark.parametrize("opt", DEVICE_STAGES, ids=["chain", "wfa", "both"])
def test_device_stages_match_host_and_jax(db, jax_host, opt):
    """--chain device (chain1 DP) and --wfa device (WFA) through their
    kernels' plain twins: rows == the host engine's and the JAX device
    engine's with the same stages; every genome and span on the device
    path."""
    _, seqs, _ = db
    qs = queries8(seqs)
    port = IndexSearcher(db[0], SearchOptions(engine="device", device="cpu", **opt))
    got = all_rows(port.search_many(qs))
    assert got == all_rows([jax_host.search_bytes(q) for q in qs])
    assert got == all_rows(JaxSearcher(db[0], JaxOptions(engine="device", **opt)).search_many(qs))
    assert (port.device_chainer is None) == ("chain_engine" not in opt)
    assert (port.device_wfa is None) == ("wfa_engine" not in opt)
    t = port._device_engine.times
    if port.device_chainer is not None:
        assert t["chain.genomes"] >= 6 and t["chain.flagged_genomes"] == 0, t
    if port.device_wfa is not None:
        assert t["wfa.card_pairs"] >= 6 and t["wfa.host_pairs"] == 0, t
        assert t["wfa"] > 0


def test_device_stages_across_batch_boundary(db, jax_host):
    """33 queries, two engine batches: one chain1 batch and one WFA batch
    per engine batch."""
    from lexicmap_tpu_torch.parallel import wfa_device as WD

    _, seqs, _ = db
    qs = []
    for s in range(11):
        qs += mutated_queries(seqs, ["D0", "D1", "D2"], 2000 + 4000 * s, 1000, 10, 100 + s)
    port = IndexSearcher(db[0], SearchOptions(engine="device", device="cpu",
                                              chain_engine="device", wfa_engine="device"))
    calls = {"chain": 0, "wfa": 0}
    chain_batch, align_batch = port.device_chainer.chain_batch, port.device_wfa.align_batch

    def count(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    port.device_chainer.chain_batch = count("chain", chain_batch)
    port.device_wfa.align_batch = count("wfa", align_batch)
    got = all_rows(port.search_many(qs))
    assert got == all_rows([jax_host.search_bytes(q) for q in qs])
    assert calls == {"chain": 2, "wfa": 2}
    assert isinstance(port.device_wfa, WD.DeviceWFA)


def test_output_seq_with_device_wfa_byte_identical(db, tmp_path, monkeypatch):
    """-a (24 columns) with --wfa device: the group's WFA runs through the
    device aligner and the cigar/qseq/sseq/align text is byte-identical to
    the host engine's and to the JAX package's host rows."""
    from lexicmap_tpu.cli import format_hit_rows as jax_rows
    from lexicmap_tpu_torch.parallel.wfa_device import DeviceWFA

    _, seqs, _ = db
    qs = queries8(seqs)
    q = tmp_path / "q.fasta"
    q.write_bytes(b"".join(f">q{i}\n".encode() + s + b"\n" for i, s in enumerate(qs)))
    calls = []
    real = DeviceWFA.align_batch
    monkeypatch.setattr(DeviceWFA, "align_batch", lambda self, p: calls.append(1) or real(self, p))
    outs = {}
    for name, argv in (("device", ["--engine", "device", "--device", "cpu", "--wfa", "device"]),
                       ("host", ["--engine", "host"])):
        o = tmp_path / f"{name}.tsv"
        assert tcli.main(["--quiet", "search", "-a", "-d", db[0], str(q), "-o", str(o), *argv]) == 0
        outs[name] = o.read_bytes()
    assert calls, "-a never reached the device WFA"
    assert outs["device"] == outs["host"]
    lines = outs["device"].decode().splitlines()
    assert len(lines) > 6 and all(line.count("\t") == 23 for line in lines)
    js = JaxSearcher(db[0], JaxOptions(engine="host", output_seq=True))
    want = [r for i, s in enumerate(qs) if len(s) >= 31
            for r in jax_rows(f"q{i}", len(s), js.search_bytes(s), True)]
    assert lines[1:] == want


def test_cli_search_device_cpu_equals_host(db, tmp_path):
    _, seqs, _ = db
    q = tmp_path / "q.fasta"
    with open(q, "wb") as fh:
        for i, s in enumerate(queries8(seqs)):
            fh.write(f">q{i}\n".encode() + s + b"\n")
    outs = {}
    for engine in ("device", "host"):
        o = tmp_path / f"{engine}.tsv"
        rc = tcli.main(["search", "--quiet", "-d", db[0], str(q), "-o", str(o),
                        "--engine", engine, "--device", "cpu"])
        assert rc == 0
        outs[engine] = o.read_bytes()
    assert outs["device"] == outs["host"]
    assert outs["device"].count(b"\n") > 5


@pytest.mark.parametrize("argv, msg", [
    (["--engine", "device"], "no CUDA device"),
    (["--engine", "device", "--device", "cpu", "-J", "2"], "-J 1"),
    (["--engine", "host", "--wfa", "device"], "no CUDA device"),
    (["--engine", "host", "--chain", "device", "--device", "cpu", "-J", "2"], "-J 1"),
], ids=["no_cuda", "fork_pool", "host_wfa_no_cuda", "host_chain_fork_pool"])
def test_cli_refuses(db, tmp_path, monkeypatch, capsys, argv, msg):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = tmp_path / "q.fasta"
    q.write_bytes(b">q\n" + db[1]["D0"][:500] + b"\n")
    assert tcli.main(["search", "--quiet", "-d", db[0], str(q), *argv]) == 1
    assert msg in capsys.readouterr().err


def test_cli_index_device_engine_refused(db, tmp_path, capsys, monkeypatch):
    """`index --engine device` runs on the card (B10); without a CUDA
    device it is refused unless `--device cpu` asks for the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "x.lmt"
    rc = tcli.main(["index", "--quiet", "-O", str(out), "-m", "64", "--engine", "device",
                    db[2][0]])
    assert rc == 1 and not out.exists()
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--device cpu" in err
