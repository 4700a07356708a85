"""The readers of the program's spans (phases 1 and 2b split, the wait on
the finish thread, the waits on the card), on a made-up run: ms a query
from the window's seconds, nothing without queries or without the span."""

import importlib

import pytest

from benchmark.lib.harness import RunRecord

READERS = {
    "mask_capture_ms_per_query": "mask.capture",
    "mask_filter_ms_per_query": "mask.filter",
    "anchors_prefix_ms_per_query": "anchors.prefix",
    "anchors_reverse_ms_per_query": "anchors.reverse",
    "anchors_suffix_ms_per_query": "anchors.suffix",
    "anchors_gather_ms_per_query": "anchors.gather",
    "finish_wait_ms_per_query": "finish_wait",
    "card_wait_ms_per_query": "card_wait",
}


def times(**extra):
    t = {"mask": 0.48, "match": 0.096, "anchors": 0.96, "chain": 0.1, "winprep": 0.05,
         "pseudo": 0.01, "align": 0.3, "wfa": 0.02}
    t.update(extra)
    return t


@pytest.mark.parametrize("name", sorted(READERS))
def test_ms_a_query(name):
    reader = importlib.import_module(f"benchmark.metrics.{name}")
    spans = {key: 0.01 * (i + 1) for i, key in enumerate(READERS.values())}
    run = RunRecord(n_queries=96, eng_times=times(**spans))
    assert reader.read(run) == pytest.approx(spans[READERS[name]] / 96 * 1e3)
    assert reader.read(RunRecord(n_queries=0, eng_times=times(**spans))) is None
    # a program without the span (the parent of the change that adds it)
    assert reader.read(RunRecord(n_queries=96, eng_times=times())) is None
    assert reader.read(RunRecord(n_queries=96, eng_times={})) is None
