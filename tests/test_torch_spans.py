"""The search path's span recorder (lexicmap_tpu_torch/utils/spans.py): exact
totals under two threads, no profiler range while the profiler is off,
every key seeded and the phases' parts inside their phases on a CPU
device-engine search, the card waits of a batch, and the ranges on the
profiler's clock in the threads that ran them; --debug prints the recorder
alone."""

import json
import sys
import threading

import pytest
import torch

from torch_parity import mutated_queries, write_genomes
from torch_parity import one_intra_op_thread  # noqa: F401  (autouse fixture)

from lexicmap_tpu_torch.index.build import BuildOptions, build_index
from lexicmap_tpu_torch.index.search import IndexSearcher, SearchOptions
from lexicmap_tpu_torch.utils import spans as S

PHASES = ("mask", "match", "anchors", "chain", "winprep", "pseudo", "align", "wfa")


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    files, seqs = write_genomes(tmp_path_factory.mktemp("srefs"))
    out = str(tmp_path_factory.mktemp("sdb") / "d.lmt")
    build_index(out, files, BuildOptions(k=31, n_masks=512, chunks=2, threads=2))
    return out, seqs


def queries35(seqs):
    qs = []
    for s in range(7):
        qs += mutated_queries(seqs, ["D0", "D1", "D2", "D0", "D1"], 1000 + 6000 * s, 900, 9,
                              50 + s)
    return qs


def searcher(db):
    return IndexSearcher(db[0], SearchOptions(engine="device", device="cpu",
                                              chain_engine="device", wfa_engine="device"))


@pytest.fixture(scope="module")
def searched(db):
    """One searcher after a search of 35 queries (two engine batches), with
    the recorder's counts before it."""
    s = searcher(db)
    qs = queries35(db[1])
    before = dict(s.spans.counts)
    res = s.search_many(qs)
    return s, qs, res, before


def test_totals_exact_under_two_threads():
    rec = S.SpanRecorder()
    n = 100_000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                rec.add("mask", 0.5)
                with rec.span("finish_wait"):
                    pass

        ts = [threading.Thread(target=work) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert rec.counts["mask"] == rec.counts["finish_wait"] == 2 * n
    assert rec.totals["mask"] == 0.5 * 2 * n
    assert rec.totals["finish_wait"] > 0


def test_no_range_while_the_profiler_is_off(db, monkeypatch):
    def forbidden(*a, **kw):
        raise AssertionError("record_function entered with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    assert not S.profiling()
    s = searcher(db)
    got = s.search_many(queries35(db[1])[:3])
    assert any(got)
    assert s.spans.counts["mask"] == 3 and s.spans.counts["card_wait"] > 0


def test_keys_seeded_and_parts_inside_their_phases(searched):
    s, qs, res, counts0 = searched
    eng = s._device_engine
    assert eng.times is s.spans.totals
    assert tuple(eng.times)[:8] == PHASES and set(eng.times) == set(S.KEYS)
    assert set(s.spans.counts) == set(S.KEYS)
    assert all(isinstance(v, float) for v in eng.times.values())
    assert sum(map(bool, res)) >= 30
    t, c = s.spans.totals, s.spans.counts
    for key in ("mask", "match", "anchors", "chain", "winprep", "pseudo", "align",
                "mask.capture", "mask.filter", "match.reverse", "anchors.prefix",
                "anchors.reverse", "anchors.gather", "finish_wait", "card_wait"):
        assert t[key] > 0, key
    assert t["anchors.prefix"] + t["anchors.reverse"] + t["anchors.suffix"] \
        + t["anchors.gather"] <= t["anchors"]
    assert t["mask.capture"] + t["mask.filter"] <= t["mask"]
    assert t["match.reverse"] <= t["match"]
    assert t["anchors.reverse_host"] <= t["anchors.reverse"]
    assert t["wfa"] <= t["align"]
    # one span a query for phase 1, 2b and their parts; one a batch for the
    # rest; the client thread waited on the finish thread once a batch
    n = len(qs)
    for key in ("mask", "anchors", "mask.capture", "mask.filter", "anchors.prefix",
                "anchors.reverse", "anchors.suffix", "anchors.gather"):
        assert c[key] - counts0[key] == n, key
    for key in ("match", "match.reverse", "chain", "winprep", "pseudo", "align", "wfa",
                "finish_wait"):
        assert c[key] - counts0[key] == 2, key
    # every query's reversed dispatch served by the batch's (the card's, here
    # its plain twin): none on the host
    assert c["anchors.reverse_host"] == counts0["anchors.reverse_host"]
    # seed matching 2, pseudo-align 2, chain DP 1, and the WFA 2 (its size
    # read, then its outputs) a launch, a batch
    assert c["card_wait"] - counts0["card_wait"] >= 2 * 7
    # every genome chained and every pair aligned on the card
    assert t["chain.genomes"] > 0 and t["chain.flagged_genomes"] == 0
    assert t["wfa.card_pairs"] > 0 and t["wfa.host_pairs"] == 0


def test_ranges_on_the_profilers_clock(db, tmp_path):
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ExecutionTraceObserver

    s = searcher(db)
    qs = queries35(db[1])
    s.search_many(qs[:2])  # the finish pool's thread starts before the profiler
    et_path = tmp_path / "et.json"
    et = ExecutionTraceObserver().register_callback(str(et_path))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=_ExperimentalConfig(profile_all_threads=True),
            execution_trace_observer=et) as prof:
        s.search_many(qs)
    threads = {}
    for e in prof.events():
        if e.name.startswith(S.PREFIX):
            threads.setdefault(e.name, set()).add(e.thread)
            assert e.is_user_annotation, e.name
    assert threads["lexicmap.mask"] == threads["lexicmap.anchors"]
    main = next(iter(threads["lexicmap.mask"]))
    assert len(threads["lexicmap.mask"]) == 1
    assert threads["lexicmap.align"] and main not in threads["lexicmap.align"]
    assert main in threads["lexicmap.finish_wait"]
    for key in ("mask.capture", "mask.filter", "anchors.reverse", "anchors.gather", "match",
                "chain", "winprep", "pseudo", "card_wait"):
        assert S.PREFIX + key in threads, key
    # the per-chunk parts and the reversed dispatch's two parts are counters only
    assert "lexicmap.anchors.prefix" not in threads
    assert "lexicmap.match.reverse" not in threads
    # the execution trace keeps each range's arguments: the query's index in
    # its batch, a card wait's stage label
    nodes = json.loads(et_path.read_text())["nodes"]
    args = {}
    for nd in nodes:
        if nd["name"].startswith(S.PREFIX):
            args.setdefault(nd["name"], []).append(nd["inputs"]["values"])
    assert args["lexicmap.mask"] == [[str(i)] for i in range(32)] + [[str(i)] for i in range(3)]
    assert sorted(args["lexicmap.anchors"]) == sorted(args["lexicmap.mask"])
    assert ["device seed matching"] in args["lexicmap.card_wait"]


def test_debug_prints_spans_and_transport_a_query(db, tmp_path, capsys):
    from lexicmap_tpu_torch import cli as tcli

    q = tmp_path / "q.fa"
    q.write_bytes(b"".join(b">q%d\n%s\n" % (i, s) for i, s in enumerate(queries35(db[1])[:4])))
    rc = tcli.main(["--quiet", "search", "-d", db[0], str(q), "-o", str(tmp_path / "o.tsv"),
                    "--engine", "device", "--device", "cpu", "--wfa", "device", "--debug"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "ms a query over 4 queries" in err
    lines = {ln.split()[0]: ln.split()[1:] for ln in err.splitlines() if ln.startswith("    ")}
    for key in S.KEYS:
        assert len(lines[key]) == 3, key  # seconds, ms a query, spans
    assert lines["mask"][2] == "4" and float(lines["card_wait"][0]) > 0
    assert float(lines["wfa.card_pairs"][0]) > 0
    # the recorder is the only account printed
    assert set(lines) == set(S.KEYS) and "transport" not in err
