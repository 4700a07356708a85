"""The reader of the program's span `match.reverse` (the reversed-k-mer
dispatch on the card), on a made-up run: ms a query from the window's
seconds, nothing without queries or without the span."""

import pytest

from benchmark.lib.harness import RunRecord
from benchmark.metrics import match_reverse_ms_per_query as reader


def test_ms_a_query():
    t = {"mask": 0.48, "match": 0.096, "anchors": 0.96, "match.reverse": 0.0288}
    assert reader.read(RunRecord(n_queries=96, eng_times=t)) == pytest.approx(0.3)
    assert reader.read(RunRecord(n_queries=0, eng_times=t)) is None
    # a program without the span (the parent of the change that adds it)
    del t["match.reverse"]
    assert reader.read(RunRecord(n_queries=96, eng_times=t)) is None
    assert reader.read(RunRecord(n_queries=96, eng_times={})) is None
