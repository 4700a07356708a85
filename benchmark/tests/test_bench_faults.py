"""Whole runs of test-sized cells on the CPU (the port's plain twins of
its kernels; the harness's look for a card skipped): a sound run comes
out correct, and each fault planted under the timed path, and the
ungapped control, come out not correct; with 20-40 kb queries too."""

import os

import pytest

from benchmark.lib.harness import run_cell
from benchmark.reference.align import LONG
from benchmark.tests.tinyspec import DATA, LONG_SPEC, SPEC

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(fault=None, control=False, seed=2**31 + 77):
    return run_cell(SPEC, "tiny.genes", seed, 0.5, False, device="cpu", root=ROOT,
                    bench_dir=DATA, control=control, fault=fault)


def run_long(fault=None, control=False, seed=2**31 + 77, device="cpu"):
    return run_cell(LONG_SPEC, "tiny.long", seed, 0.5, False, device=device, root=ROOT,
                    bench_dir=DATA, control=control, fault=fault)


@pytest.fixture(scope="module")
def sound():
    return run(control=True)


def test_sound_run_is_correct(sound):
    assert sound["correct"], sound["checks"]
    assert sound["attempted"] >= 4 and sound["failed"] == 0
    assert set(sound["metrics"]) == {"queries_per_min", "setup_s"}
    assert list(sound)[-1] == "checks"  # the compared numbers come last


def test_control_is_not_correct(sound):
    ctl = sound["control_checks"]
    assert any(c["value"] > c["limit"] for c in ctl.values())
    assert ctl["pident_gap"]["value"] > 10 * max(sound["checks"]["pident_gap"]["value"], 0.01)


@pytest.mark.parametrize("fault, number", [("half", "missed_pct"), ("strand", None),
                                           ("first_hsp", "missed_copies_pct")])
def test_fault_is_not_correct(fault, number):
    r = run(fault=fault)
    assert not r["correct"]
    if number:
        assert r["checks"][number]["value"] > r["checks"][number]["limit"]


@pytest.fixture(scope="module")
def sound_long():
    return run_long(control=True)


def test_long_queries_are_judged(sound_long):
    """Queries of 20-40 kb: the sample holds stretches over 16 kb, the
    run is correct and the control is not."""
    assert sound_long["correct"], sound_long["checks"]
    assert sound_long["judged"]["realigned_max_bp"] >= LONG
    ctl = sound_long["control_checks"]
    assert any(c["value"] > c["limit"] for c in ctl.values())


@pytest.mark.parametrize("fault", ["half", "strand"])
def test_fault_on_long_queries_is_not_correct(fault):
    r = run_long(fault=fault)
    assert r["judged"]["realigned_max_bp"] >= LONG
    assert not r["correct"]


def test_traced_run_reads_host_layers():
    r = run_cell(SPEC, "tiny.genes", 5, 0.5, True, device="cpu", root=ROOT, bench_dir=DATA)
    assert r["correct"]
    assert {"front_ms_per_query", "match_ms_per_query", "hits_ms_per_query"} <= set(r["metrics"])
    # no card: no device op, so no kernel or idle metric (never a made-up 0)
    assert "kernel_us_per_query" not in r["metrics"] and "device_idle_pct" not in r["metrics"]
    assert r["device"]["window_s"] > 0 and r["breakdown"]["device_ops"] == []


@pytest.mark.cuda
def test_tiny_cell_on_the_card(card):
    r = run_cell(SPEC, "tiny.genes", 3, 1.0, True, device="cuda", root=ROOT, bench_dir=DATA)
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0 and "kernel_us_per_query" in r["metrics"]


@pytest.mark.cuda
def test_tiny_long_cell_on_the_card(card):
    r = run_long(device="cuda")
    assert r["correct"], r["checks"]
    assert r["judged"]["realigned_max_bp"] >= LONG
