"""One run of one cell: set-up, the measured window, the metrics, and the
comparison that decides `correct`.

Everything a cell is made of is found by name: its configuration file
(BENCHMARK.json's `file`), its database generator (data/<kind>.py), its
traffic mix (traffic/<name>.json, read by lib/traffic.py), its limits
(limits/<workload>.json) and each metric's reader (metrics/<name>.py).
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # benchmark/
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "lexicmap_tpu")


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list


@dataclass
class RunRecord:
    setup_s: float = 0.0
    window_s: float = 0.0
    latencies_s: list = field(default_factory=list)
    n_queries: int = 0
    eng_times: dict = field(default_factory=dict)
    trace: object = None
    memory_peak_bytes: int = 0


def _load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _reported(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(spec: dict, workload: str, root: str = ROOT, bench_dir: str = HERE) -> Cell:
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in the benchmark (have {sorted(cells)})")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return Cell(
        name=workload,
        config=_load_json(os.path.join(root, cfg_entry["file"])),
        mix=_load_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json")),
        limits=_load_json(os.path.join(bench_dir, "limits", f"{workload}.json")),
        end_to_end=[m for m in spec["end_to_end"] if _reported(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _reported(m, workload)],
    )


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def write_fasta(db, outdir: str) -> list[str]:
    from benchmark.lib.seqgen import to_ascii

    os.makedirs(outdir, exist_ok=True)
    files = []
    for g in db.genomes:
        path = os.path.join(outdir, f"{g.name}.fa")
        with open(path, "wb") as fh:
            fh.write(b">" + g.name.encode() + b"_c1\n")
            fh.write(to_ascii(g.codes))
            fh.write(b"\n")
        files.append(path)
    return files


def build_index(cfg: dict, files: list[str], out: str) -> None:
    """The port's `index` with the configuration's index parameters."""
    from lexicmap_tpu_torch.index.build import BuildOptions, build_index as _build

    ix = cfg["index"]
    _build(out, files, BuildOptions(
        k=ix["k"], n_masks=ix["masks"], rand_seed=ix["rand_seed"],
        seed_max_desert=ix["seed_max_desert"], batch_size=ix["batch_size"],
        force=True, verbose=False, engine=ix["engine"]))


def open_searcher(cfg: dict, dbdir: str, device: str):
    from lexicmap_tpu_torch.index.search import IndexSearcher, SearchOptions

    s = cfg["search"]
    return IndexSearcher(dbdir, SearchOptions(
        engine=s["engine"], chain_engine=s["chain_engine"], wfa_engine=s["wfa_engine"],
        device=device))


def request(searcher, queries: list) -> list:
    """One request as the CLI serves it: search_many over the queries, then
    each query's TSV rows."""
    from lexicmap_tpu_torch.cli import format_hit_rows

    results = searcher.search_many([q.seq for q in queries])
    return [list(format_hit_rows(q.qid, q.codes.shape[0], r)) for q, r in zip(queries, results)]


def run_window(searcher, stream, rq: int, seconds: float, record: RunRecord, done: list,
               trace: bool):
    """The closed loop: one client sends a request, waits for its rows, and
    sends the next, until `seconds` have passed since the first."""
    import torch

    eng0 = dict(getattr(searcher, "_device_engine").times)
    attempted = failed = 0
    if trace:
        from benchmark.lib.tracing import REQUEST, WINDOW, layer_spans

        spans = layer_spans()
        spans.__enter__()
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
        win_span = torch.profiler.record_function(WINDOW)
        win_span.__enter__()
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            qs = stream.take(rq)
            attempted += len(qs)
            t = time.perf_counter()
            try:
                if trace:
                    with torch.profiler.record_function(REQUEST):
                        rows = request(searcher, qs)
                else:
                    rows = request(searcher, qs)
            except Exception as e:  # a failed request counts against the run
                failed += len(qs)
                print(f"request failed: {type(e).__name__}: {e}", file=sys.stderr)
                continue
            record.latencies_s.append(time.perf_counter() - t)
            done.extend(zip(qs, rows))
        record.window_s = time.perf_counter() - t0
    finally:
        if trace:
            win_span.__exit__(None, None, None)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            spans.__exit__(None, None, None)
    eng1 = getattr(searcher, "_device_engine").times
    record.eng_times = {k: eng1[k] - eng0.get(k, 0.0) for k in eng1}
    record.n_queries = attempted - failed
    lat = sorted(record.latencies_s)
    if lat:
        half = len(record.latencies_s) // 2
        print(f"window: {len(lat)} requests in {record.window_s:.3f} s; latency (s) "
              f"p10 {lat[len(lat) // 10]:.4f} p50 {lat[len(lat) // 2]:.4f} "
              f"p90 {lat[len(lat) * 9 // 10]:.4f} max {lat[-1]:.4f}; halves' sums "
              f"{sum(record.latencies_s[:half]):.3f} {sum(record.latencies_s[half:]):.3f}; "
              f"engine (s) " + ", ".join(f"{k} {v:.3f}" for k, v in record.eng_times.items()),
              file=sys.stderr)
    if trace:
        from benchmark.lib.tracing import from_profiler

        record.trace = from_profiler(prof)
    return attempted, failed


def read_metrics(metrics: list, record: RunRecord) -> dict:
    out = {}
    for m in metrics:
        reader = importlib.import_module(f"benchmark.metrics.{m['name']}")
        v = reader.read(record)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None, root: str = ROOT,
             bench_dir: str = HERE, control: bool = False, fault: str | None = None) -> dict:
    """One run; returns the result object (without printing it).  With
    control=True the same rows are judged a second time after the
    control's change (reference/judge.py::ungapped_rows), under
    `control_checks`; `fault` plants one of reference/faults.py's faults
    under the window's requests.  The benchmark's own runs use neither.
    The judge re-aligns its sample on `device`, once the searcher is
    freed."""
    import torch

    from benchmark.lib.traffic import QueryStream
    from benchmark.reference.faults import planted
    from benchmark.reference.judge import judge, ungapped_rows

    t_start = time.time() if t_start is None else t_start
    cell = load_cell(spec, workload, root, bench_dir)
    gen = importlib.import_module(f"benchmark.data.{cell.config['kind']}")
    rq = int(cell.mix["request_queries"])
    record = RunRecord()
    tmp = tempfile.mkdtemp(prefix="lexicmap-bench-")
    parts = {"start": time.time() - t_start}
    try:
        t = time.time()
        db = gen.generate(cell.config, seed)
        parts["generate"] = time.time() - t
        t = time.time()
        files = write_fasta(db, os.path.join(tmp, "genomes"))
        parts["fasta"] = time.time() - t
        t = time.time()
        dbdir = os.path.join(tmp, "db.lmi")
        build_index(cell.config, files, dbdir)
        shutil.rmtree(os.path.join(tmp, "genomes"))
        os.sync()  # the index on disk, as a searched one is, not in dirty pages
        parts["index"] = time.time() - t
        t = time.time()
        searcher = open_searcher(cell.config, dbdir, device)
        parts["open"] = time.time() - t
        t = time.time()
        stream = QueryStream(db, cell.mix, seed)
        for _ in range(int(cell.mix["warm_requests"])):
            request(searcher, stream.take(rq))
        if device != "cpu":
            torch.cuda.synchronize()
        parts["warm"] = time.time() - t
        record.setup_s = time.time() - t_start
        print("setup parts (s): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()),
              file=sys.stderr)

        done: list = []
        with planted(fault):
            attempted, failed = run_window(searcher, stream, rq, seconds, record, done, trace)
        peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
        record.memory_peak_bytes = int(peak)
        del searcher
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()

        t = time.time()
        numbers, counts = judge(db, done, seed, device)
        counts["judge_s"] = time.time() - t
        if control:
            control_numbers, _ = judge(db, ungapped_rows(db, done), seed, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    checks = {k: {"value": numbers[k], "limit": cell.limits[k]} for k in numbers}
    correct = (attempted > 0 and failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, record)
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = record.trace.busy_s()
        dev["window_s"] = record.trace.window_s
        out["breakdown"] = record.trace.breakdown()
    out["setup_parts_s"] = parts
    out["judged"] = counts
    if fault:
        out["fault"] = fault
    if control:
        out["control_checks"] = {k: {"value": v, "limit": cell.limits[k]}
                                 for k, v in control_numbers.items()}
    out["checks"] = checks
    return out
