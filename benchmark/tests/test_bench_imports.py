"""The import check: JAX and the JAX package are refused by whole
top-level name; the port, whose name begins with the JAX package's, is
not.  The harness and the port load neither."""

import os
import subprocess
import sys
import types

from benchmark.lib import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_forbidden_by_whole_top_level_name(monkeypatch):
    for name in ("jax.numpy", "jaxlib", "flax.linen", "lexicmap_tpu.index.search",
                 "lexicmap_tpu_torch.cli", "jaxtyping", "lexicmap_tpux"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    bad = harness.forbidden_modules()
    for name in ("jax.numpy", "jaxlib", "flax.linen", "lexicmap_tpu.index.search"):
        assert name in bad
    for name in ("lexicmap_tpu_torch.cli", "jaxtyping", "lexicmap_tpux"):
        assert name not in bad


def test_harness_and_port_load_no_jax():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import benchmark.lib.harness as h, benchmark.lib.tracing, benchmark.reference.judge\n"
        "import benchmark.reference.faults, benchmark.data.clades, benchmark.queries.gene\n"
        "import benchmark.queries.rrna\n"
        "import lexicmap_tpu_torch.index.search, lexicmap_tpu_torch.index.build\n"
        "import lexicmap_tpu_torch.parallel.engine, lexicmap_tpu_torch.cli\n"
        "print(h.forbidden_modules())\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_run_refuses_without_a_card_or_the_port(tmp_path):
    # only BENCHMARK.json and the benchmark's files: no port to import
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "gtdb.genes",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0
    assert r.stdout.strip() == ""
