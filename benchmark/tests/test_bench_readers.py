"""The metric readers and the trace reduction, on a made-up run."""

import importlib

import pytest

from benchmark.lib.harness import RunRecord, read_metrics
from benchmark.lib.tracing import REQUEST, WINDOW, Trace


def made_up_trace():
    # window 0..1,000,000 us; kernels at 100-300 and 250-400 (overlapping),
    # a copy at 600-700, a kernel half outside the window at 950-1,100
    return Trace(
        window=(0.0, 1_000_000.0),
        device=[("seed_locate", 100_000.0, 300_000.0), ("wfa_forward", 250_000.0, 400_000.0),
                ("Memcpy DtoH (Device -> Pinned)", 600_000.0, 700_000.0),
                ("chain1_kernel", 950_000.0, 1_100_000.0)],
        # the client's thread (1): the request, layers' calls inside it (two
        # short anchors calls outweigh one longer match call); another
        # thread (2) finishing a batch over the last gap
        host=[(WINDOW, 0.0, 1_000_000.0, 1), (REQUEST, 0.0, 900_000.0, 1),
              ("bench.anchors", 400_000.0, 480_000.0, 1),
              ("bench.anchors", 500_000.0, 590_000.0, 1),
              ("bench.match", 420_000.0, 520_000.0, 1), ("bench.mask", 0.0, 90_000.0, 1),
              ("bench.finish", 650_000.0, 990_000.0, 2)],
    )


def record(**kw):
    base = dict(setup_s=61.5, window_s=2.0, latencies_s=[0.5, 0.7, 0.8],
                n_queries=96, eng_times={"mask": 0.48, "match": 0.096, "anchors": 0.96,
                                         "chain": 0.1, "winprep": 0.05, "pseudo": 0.01,
                                         "align": 0.3, "wfa": 0.02},
                trace=made_up_trace())
    base.update(kw)
    return RunRecord(**base)


def read(name, rec):
    return importlib.import_module(f"benchmark.metrics.{name}").read(rec)


def test_trace_union_gaps_and_breakdown():
    tr = made_up_trace()
    assert tr.busy_intervals() == [[100_000.0, 400_000.0], [600_000.0, 700_000.0],
                                   [950_000.0, 1_000_000.0]]
    assert tr.busy_s() == pytest.approx(0.45)
    assert tr.idle_gaps() == [(0.0, 100_000.0), (400_000.0, 600_000.0),
                              (700_000.0, 950_000.0)]
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["seed_locate", pytest.approx(0.2)]
    assert len(bd["device_ops"]) == 4  # the last kernel clipped to the window
    assert bd["device_ops"][-1] == ["chain1_kernel", pytest.approx(0.05)]
    assert bd["idle_gaps"] == [["request, between layers", pytest.approx(0.25)],
                               ["anchors", pytest.approx(0.2)],
                               ["mask", pytest.approx(0.1)]]
    assert [k[0] for k in tr.kernels()] == ["seed_locate", "wfa_forward", "chain1_kernel"]


def test_host_metrics():
    rec = record()
    assert read("queries_per_min", rec) == pytest.approx(96 / 2.0 * 60)
    assert read("setup_s", rec) == 61.5
    assert read("front_ms_per_query", rec) == pytest.approx((0.48 + 0.96) / 96 * 1e3)
    assert read("match_ms_per_query", rec) == pytest.approx(1.0)
    assert read("hits_ms_per_query", rec) == pytest.approx(0.46 / 96 * 1e3)
    one = record(latencies_s=[i / 1000 for i in range(1, 101)])
    assert read("query_p95_ms", one) == pytest.approx(95.05)
    assert read("query_p95_ms", record(latencies_s=[])) is None


def test_memory_and_traced_rate():
    rec = record(memory_peak_bytes=136_577_024)
    assert read("device_memory_peak_mib", rec) == pytest.approx(130.25)
    assert read("device_memory_peak_mib", record()) is None  # a run without a card
    assert read("queries_per_min_traced", rec) == read("queries_per_min", rec)
    assert read("queries_per_min_traced", record(n_queries=0)) is None


def test_device_metrics():
    rec = record()
    # kernels inside the window: 200 + 150 + 50 ms of kernel time; copies left out
    assert read("kernel_us_per_query", rec) == pytest.approx((200_000 + 150_000 + 50_000) / 96)
    assert read("device_idle_pct", rec) == pytest.approx(55.0)


def test_readers_return_nothing_without_a_trace_or_work():
    bare = record(trace=None)
    assert read("kernel_us_per_query", bare) is None
    assert read("device_idle_pct", bare) is None
    empty = record(trace=Trace(window=(0.0, 1e6), device=[], host=[]))
    assert read("kernel_us_per_query", empty) is None
    assert read("device_idle_pct", empty) is None
    none = record(n_queries=0, eng_times={})
    assert read("queries_per_min", none) is None and read("front_ms_per_query", none) is None
    got = read_metrics([{"name": "device_idle_pct", "unit": "%"},
                        {"name": "setup_s", "unit": "s"}], bare)
    assert got == {"setup_s": {"value": 61.5, "unit": "s"}}
