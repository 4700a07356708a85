"""The readers of the per-hit stages' span `wfa.host` and counters
`wfa.card_pairs`, `wfa.host_pairs`, `pseudo.card_windows`,
`pseudo.host_windows`, on a made-up run: ms a query and host shares,
nothing without queries, without work, or without the keys (a program
that lacks them)."""

import pytest

from benchmark.lib.harness import RunRecord
from benchmark.metrics import pseudo_host_windows_pct, wfa_host_ms_per_query, wfa_host_pairs_pct

PHASES = {"mask": 0.48, "match": 0.096, "anchors": 0.96, "chain": 0.1, "winprep": 0.05,
          "pseudo": 0.01, "align": 0.3, "wfa": 0.02}
NEW = {"wfa.host": 0.0096, "wfa.card_pairs": 7470.0, "wfa.host_pairs": 18.0,
       "pseudo.card_windows": 7480.0, "pseudo.host_windows": 20.0}


def run(n_queries=96, **keys):
    return RunRecord(n_queries=n_queries, eng_times=dict(PHASES, **keys))


def test_wfa_host_ms_a_query():
    assert wfa_host_ms_per_query.read(run(**NEW)) == pytest.approx(0.1)
    assert wfa_host_ms_per_query.read(run(**dict(NEW, **{"wfa.host": 0.0}))) == 0.0
    assert wfa_host_ms_per_query.read(run(0, **NEW)) is None


@pytest.mark.parametrize("reader, card, host", [
    (wfa_host_pairs_pct, "wfa.card_pairs", "wfa.host_pairs"),
    (pseudo_host_windows_pct, "pseudo.card_windows", "pseudo.host_windows")])
def test_host_shares(reader, card, host):
    got = reader.read(run(**NEW))
    assert got == pytest.approx(100.0 * NEW[host] / (NEW[card] + NEW[host]))
    assert reader.read(run(**dict(NEW, **{host: 0.0}))) == 0.0
    assert reader.read(run(**dict(NEW, **{card: 0.0}))) == 100.0
    # no pair or window in the window: no share (never a made-up 0)
    assert reader.read(run(**dict(NEW, **{card: 0.0, host: 0.0}))) is None


@pytest.mark.parametrize("reader", [wfa_host_ms_per_query, wfa_host_pairs_pct,
                                    pseudo_host_windows_pct])
def test_nothing_without_the_keys(reader):
    """The parent of the change that adds the keys has none of them."""
    assert reader.read(run()) is None
    assert reader.read(RunRecord(n_queries=96, eng_times={})) is None
