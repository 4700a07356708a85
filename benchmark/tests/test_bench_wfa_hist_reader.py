"""The reader of the WFA history scratch a pair, on a made-up run: KiB a
card pair from the counters `wfa.hist_bytes` and `wfa.card_pairs`, nothing
without the history counter (a program that lacks it) or without card
pairs."""

import pytest

from benchmark.lib.harness import RunRecord
from benchmark.metrics import wfa_hist_kib_per_pair

COUNTS = {"wfa": 0.02, "wfa.card_pairs": 7470.0, "wfa.host_pairs": 18.0}


def run(**keys):
    return RunRecord(n_queries=96, eng_times=dict(COUNTS, **keys))


@pytest.mark.parametrize("hist_bytes, kib", [
    (7470 * 794628.0, 776.00390625),  # room for every score at the full window
    (7470 * 20480.0, 20.0)])
def test_kib_a_card_pair(hist_bytes, kib):
    assert wfa_hist_kib_per_pair.read(run(**{"wfa.hist_bytes": hist_bytes})) == pytest.approx(kib)


def test_nothing_without_the_counter_or_card_pairs():
    assert wfa_hist_kib_per_pair.read(run()) is None
    assert wfa_hist_kib_per_pair.read(RunRecord(n_queries=96, eng_times={})) is None
    assert wfa_hist_kib_per_pair.read(run(**{"wfa.hist_bytes": 0.0, "wfa.card_pairs": 0.0})) is None
    keys = dict(COUNTS, **{"wfa.hist_bytes": 1024.0})
    del keys["wfa.card_pairs"]
    assert wfa_hist_kib_per_pair.read(RunRecord(n_queries=96, eng_times=keys)) is None
