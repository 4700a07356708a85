"""A test-sized cell of the gtdb_r214_repr_rrna layout (`tiny.rrna`): four
species of one genome each, every genome with 1-3 copies of its species'
1.5 kb rRNA-like variant, requests of two whole-gene queries that hit
every copy of every genome.  On the CPU (the port's plain twins): the run
is judged correct against the reference, the ungapped control is not, and
the traced run reads the per-hit stages' counters."""

import os

import pytest

from benchmark.lib.harness import run_cell
from benchmark.tests.tinyspec import DATA

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RRNA_SPEC = {
    "configs": [{"name": "tiny_rrna_clades", "file": "benchmark/tests/data/tiny_rrna_clades.json"}],
    "workloads": [{"name": "tiny.rrna", "config": "tiny_rrna_clades", "traffic": "tiny_rrna_mix",
                   "chips": 1}],
    "end_to_end": [{"name": "setup_s", "unit": "s"}],
    "per_layer": [{"name": "hits_ms_per_query", "unit": "ms/query"},
                  {"name": "wfa_host_ms_per_query", "unit": "ms/query"},
                  {"name": "wfa_host_pairs_pct", "unit": "%"},
                  {"name": "pseudo_host_windows_pct", "unit": "%"}],
}
COUNTERS = ("wfa_host_ms_per_query", "wfa_host_pairs_pct", "pseudo_host_windows_pct")


def run(seed, device="cpu", control=False):
    return run_cell(RRNA_SPEC, "tiny.rrna", seed, 0.5, True, device=device, root=ROOT,
                    bench_dir=DATA, control=control)


@pytest.fixture(scope="module")
def sound():
    return run(2**31 + 91, control=True)


def test_rrna_cell_is_correct(sound):
    assert sound["correct"], sound["checks"]
    assert sound["attempted"] >= 2 and sound["failed"] == 0
    j = sound["judged"]
    # 1 + 2 + 3 + 1 copies: each query's own genome's, and the other
    # species' copies, all found
    assert j["must_copies"] + j["cross_copies"] == 7 * j["queries"]
    assert j["rows"] >= 7 * j["queries"]
    assert sound["checks"]["missed_cross_copies_pct"]["value"] == 0


def test_rrna_control_is_not_correct(sound):
    ctl = sound["control_checks"]
    assert any(c["value"] > c["limit"] for c in ctl.values())


def test_rrna_traced_run_reads_the_counters(sound):
    m = sound["metrics"]
    assert set(COUNTERS) <= set(m)
    # every window and pair of whole-gene hits on the card's side (here the
    # plain twins)
    assert m["wfa_host_pairs_pct"]["value"] == 0 and m["pseudo_host_windows_pct"]["value"] == 0


@pytest.mark.cuda
def test_tiny_rrna_cell_on_the_card(card):
    r = run(3, device="cuda")
    assert r["correct"], r["checks"]
    assert set(COUNTERS) <= set(r["metrics"]) and r["device"]["busy_s"] > 0
