"""Test-sized cells: the atb_hq_slice layout at 5 genomes of 40-60 kb,
2,000 masks, requests of 4 gene and rRNA-like queries (`tiny.genes`); and
at 5 genomes of 200-300 kb, requests of two 20-40 kb gene queries, so the
judge re-aligns stretches over 16 kb (`tiny.long`)."""

import os

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SPEC = {
    "configs": [{"name": "tiny_clades", "file": "benchmark/tests/data/tiny_clades.json"}],
    "workloads": [{"name": "tiny.genes", "config": "tiny_clades", "traffic": "tiny_mix",
                   "chips": 1}],
    "end_to_end": [{"name": "queries_per_min", "unit": "queries/min"},
                   {"name": "setup_s", "unit": "s"}],
    "per_layer": [{"name": "front_ms_per_query", "unit": "ms/query"},
                  {"name": "match_ms_per_query", "unit": "ms/query"},
                  {"name": "hits_ms_per_query", "unit": "ms/query"},
                  {"name": "kernel_us_per_query", "unit": "us/query"},
                  {"name": "device_idle_pct", "unit": "%"}],
}
LONG_SPEC = {
    "configs": [{"name": "tiny_long_clades", "file": "benchmark/tests/data/tiny_long_clades.json"}],
    "workloads": [{"name": "tiny.long", "config": "tiny_long_clades", "traffic": "tiny_long_mix",
                   "chips": 1}],
    "end_to_end": SPEC["end_to_end"],
    "per_layer": SPEC["per_layer"],
}
