"""BENCHMARK.json and the files it names: every configuration, mix, limit
and metric parses and is found by name, within the contract's limits."""

import importlib
import json
import os
import re

import pytest

from benchmark.reference.judge import NUMBERS

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level_keys_and_sizes():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= s["run_seconds"] <= 51 and isinstance(s["run_seconds"], int)
    assert s["paths"] == ["benchmark"] and s["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= len(s["configs"]) <= 24 and 1 <= len(s["workloads"]) <= 24
    assert 1 <= len(s["end_to_end"]) <= 16 and 1 <= len(s["per_layer"]) <= 128
    # a full check of 24 cells (2 + 14 runs a cell) fits in 43,200 s
    assert 1200 + (2 + 14 * 24) * (s["run_seconds"] + 60) + 24 * 180 <= 43200


def test_names_units_and_whys():
    s = spec()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in s[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for x in s["configs"] + s["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len({(w["config"], w["traffic"]) for w in s["workloads"]}) == len(s["workloads"])


@pytest.mark.parametrize("i", range(len(spec()["configs"])))
def test_config_files(i):
    c = spec()["configs"][i]
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("benchmark/") and len(c["source"]) <= 200
    with open(os.path.join(ROOT, c["file"])) as fh:
        cfg = json.load(fh)
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"] and all(NAME.match(k) for k in c["reduced"])
    gen = importlib.import_module(f"benchmark.data.{cfg['kind']}")
    assert callable(gen.generate)
    for key in ("k", "masks", "rand_seed", "seed_max_desert", "batch_size"):
        assert key in cfg["index"]
    assert cfg["search"] == {"engine": "device", "chain_engine": "device", "wfa_engine": "device"}


@pytest.mark.parametrize("i", range(len(spec()["workloads"])))
def test_workload_files(i):
    s = spec()
    w = s["workloads"][i]
    assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    assert w["config"] in {c["name"] for c in s["configs"]}
    with open(os.path.join(BENCH, "traffic", f"{w['traffic']}.json")) as fh:
        mix = json.load(fh)
    assert mix["request_queries"] >= 1 and mix["warm_requests"] >= 1
    for c in mix["classes"]:
        assert callable(importlib.import_module(f"benchmark.queries.{c['kind']}").make)
    with open(os.path.join(BENCH, "limits", f"{w['name']}.json")) as fh:
        limits = json.load(fh)
    assert set(limits) == set(NUMBERS)
    reports = [m for m in s["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
    assert "setup_s" in [m["name"] for m in reports] and len(reports) >= 2
    layers = [m for m in s["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
    assert layers


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(group):
    s = spec()
    e2e = {m["name"] for m in s["end_to_end"]}
    for m in s[group]:
        reader = importlib.import_module(f"benchmark.metrics.{m['name']}")
        assert callable(reader.read)
        if group == "end_to_end":
            assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
            assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        else:
            assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
            assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
            assert m["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
    assert "setup_s" in e2e
