"""The port's multi-process search (parallel/multiproc.py) and its sharded
matcher across ranks, on the CPU with gloo: the merged TSV of 2 and of 4
workers byte-identical to the single-process host search's, and 4 ranks
with L = 2 local shards each (make_mesh's dp = 2 x tp = 4, the layout of the
JAX package's make_mesh(8)) against the JAX package's sharded step and
matcher.  Every spawned process has a timeout."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from torch_dist import ROOT, rank_env, run_ranks
from torch_parity import host_triples, screening_case, sharded_db
from torch_parity import one_intra_op_thread  # noqa: F401  (autouse fixture)

from lexicmap_tpu.index.search import IndexSearcher as JaxSearcher
from lexicmap_tpu.index.search import SearchOptions as JaxOptions
from lexicmap_tpu.parallel import sharded as JS
from lexicmap_tpu_torch import cli as tcli
from lexicmap_tpu_torch.index.search import IndexSearcher, SearchOptions
from lexicmap_tpu_torch.parallel import multiproc
from lexicmap_tpu_torch.parallel import sharded as TS
from lexicmap_tpu_torch.utils.kmers import seq_to_codes


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The 4-genome index, a FASTA of its queries (with a short one and a
    random one) and the host engine's TSV of them, from the port's CLI."""
    d = tmp_path_factory.mktemp("mp")
    db, _, queries = sharded_db(d)
    rnd = bytes(np.random.default_rng(4).choice(np.frombuffer(b"ACGT", np.uint8), 1200))
    qs = queries + [b"ACGTACGT", rnd]
    qpath = d / "q.fasta"
    with open(qpath, "wb") as fh:
        for i, q in enumerate(qs):
            fh.write(b">q%d\n%s\n" % (i, q))
    host = d / "host.tsv"
    assert tcli.main(["--quiet", "search", "-d", db, str(qpath), "-o", str(host),
                      "--engine", "host"]) == 0
    with open(host) as fh:
        want = fh.read()
    assert want.count("\n") > 5
    return db, str(qpath), want, qs


def launch(tmp_path, db, qpath, *extra, timeout=420, limit=None):
    """The launcher as a user runs it; its own time limit (`limit`, by
    default a minute under the test's) stops its workers."""
    out = tmp_path / "mp.tsv"
    r = subprocess.run(
        [sys.executable, "-m", "lexicmap_tpu_torch.parallel.multiproc", "--db", db, "-q", qpath,
         "-o", str(out), "--device", "cpu", "--batch", "3", "--workdir", str(tmp_path / "w"),
         "--timeout", str(limit or timeout - 60), *extra],
        cwd=ROOT, env=rank_env(), capture_output=True, text=True, timeout=timeout)
    return r, out


def test_multiproc_relative_paths_from_another_directory(case, tmp_path):
    """Launched from a directory that is not the repository's, with every
    path relative to it: the TSV and summary.json land where the caller
    named them, and the workers find the index, the queries and the
    group's store."""
    db, qpath, want, _ = case
    run = tmp_path / "run"
    run.mkdir()
    r = subprocess.run(
        [sys.executable, "-m", "lexicmap_tpu_torch.parallel.multiproc",
         "--db", os.path.relpath(db, run), "-q", os.path.relpath(qpath, run), "-o", "mp.tsv",
         "--device", "cpu", "--batch", "3", "--nprocs", "2", "--workdir", "w",
         "--timeout", "360"],
        cwd=run, env=rank_env(), capture_output=True, text=True, timeout=420)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(run / "mp.tsv") as fh:
        assert fh.read() == want
    assert (run / "w" / "summary.json").exists()


@pytest.mark.parametrize("extra", [("--nprocs", "2"),
                                   ("--nprocs", "4", "--local-devices", "2", "--twins", "device")],
                         ids=["2x1_host", "4x2_device"])
def test_multiproc_tsv_equals_host(case, tmp_path, extra):
    db, qpath, want, qs = case
    r, out = launch(tmp_path, db, qpath, *extra)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(out) as fh:
        assert fh.read() == want
    with open(tmp_path / "w" / "summary.json") as fh:
        summary = json.load(fh)
    n = int(extra[1])
    assert summary["nprocs"] == n and summary["device"] == "cpu"
    assert summary["queries"] == sum(len(q) >= 31 for q in qs)
    assert len(summary["per_proc_queries"]) == n and min(summary["per_proc_queries"]) >= 1


def test_multiproc_failing_worker_fails_launch(case, tmp_path):
    """A worker that fails (here: no index) ends the launch with a non-zero
    code and leaves no worker behind."""
    _, qpath, _, _ = case
    r, out = launch(tmp_path, str(tmp_path / "missing.lmt"), qpath, "--nprocs", "2",
                    timeout=180)
    assert r.returncode != 0
    assert not out.exists()


def test_multiproc_time_limit_stops_workers(case, tmp_path):
    """Over its time limit the launcher stops the workers and exits 124."""
    db, qpath, _, _ = case
    r, out = launch(tmp_path, db, qpath, "--nprocs", "2", timeout=180, limit=0.5)
    assert r.returncode == 124, r.stderr[-2000:]
    assert "over the 0.5 s limit" in r.stderr
    assert not out.exists()


def test_multiproc_refuses_more_workers_than_cards(case, tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="needs 2 CUDA devices"):
        multiproc.main(["--db", case[0], "-q", case[1], "-o", str(tmp_path / "x.tsv"),
                        "--nprocs", "2", "--device", "cuda"])


def test_step_dp2_across_ranks_equals_jax(tmp_path):
    """4 gloo ranks with L = 2 (dp = 2, tp = 4) against JAX's step on
    make_mesh(8): every rank holds the same scores, JAX's."""
    table, qarr = screening_case(tmp_path)
    np.save(tmp_path / "seeds.npy", table)
    np.save(tmp_path / "queries.npy", qarr)
    mesh = JS.make_mesh(8)
    want = np.asarray(JS.make_sharded_search_step(mesh, k=16, min_prefix=15)(
        *JS.shard_arrays(mesh, table, qarr)))
    res = run_ranks(tmp_path, 4, "step", local_shards=2, k=16, p=15)
    assert sorted((r["mesh"]["dp_index"], r["mesh"]["tp_rank"]) for r in res) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in res:
        assert (r["mesh"]["dp"], r["mesh"]["tp"]) == (2, 4)
        assert np.array_equal(r["out"], want)


def test_matcher_dp2_across_ranks_equals_jax(case, tmp_path, monkeypatch):
    """The matcher's triples on 4 gloo ranks with L = 2 against JAX's
    ShardedSeedMatcher on make_mesh(8), on a batch of 5 queries (padded to
    dp), at a capacity that some queries overflow: JAX declines them, the
    port's second pass keeps them, so every rank returns JAX's triples
    where JAX keeps a query and the host bisection's where it declines."""
    db, _, _, qs = case
    idx = IndexSearcher(db, SearchOptions())
    kmers = np.stack([idx._mask_query(seq_to_codes(q))[0] for q in qs if len(q) >= 31])
    np.save(tmp_path / "kmers.npy", kmers)
    jidx = JaxSearcher(db, JaxOptions())
    full = JS.ShardedSeedMatcher(jidx, JS.make_mesh(8)).match_batch(kmers, 15)
    h = min(int(np.bincount(t[0] % 4, minlength=4).max()) for t in full if t[0].size)
    monkeypatch.setattr(JS.ShardedSeedMatcher, "H_SHARD", h)
    want = JS.ShardedSeedMatcher(jidx, JS.make_mesh(8)).match_batch(kmers, 15)
    assert any(w is None for w in want) and any(w is not None for w in want)
    res = run_ranks(tmp_path, 4, "matcher", local_shards=2, db=db, h_shard=h)
    for r in res:
        got = r["out"]["triples"]
        assert len(got) == len(want)
        assert r["out"]["stats"]["second_pass_queries"] == sum(w is None for w in want)
        for b, (g, w) in enumerate(zip(got, want)):
            ref = w if w is not None else host_triples(idx, kmers[b], 15)
            assert g is not None and all(np.array_equal(x, y) for x, y in zip(g, ref))


def test_matcher_second_pass_when_one_rank_overflows(case, tmp_path):
    """2 gloo ranks with L = 1 (tp = 2) at a capacity that some query's
    hits pass on one rank's shard and no query's on the other's: the
    second pass is decided from the gathered counts, so both ranks run it
    (and make its collectives) and return the host bisection's triples."""
    db, _, _, qs = case
    idx = IndexSearcher(db, SearchOptions())
    kmers = np.stack([idx._mask_query(seq_to_codes(q))[0] for q in qs if len(q) >= 31])
    np.save(tmp_path / "kmers.npy", kmers)
    want = [host_triples(idx, km, idx.opt.min_prefix) for km in kmers]
    with TS.make_mesh(local_shards=2, device="cpu") as mesh:  # the shards of 2 ranks x 1
        buckets = TS.ShardedSeedMatcher(idx, mesh).buckets
    most = [max(int(np.isin(w[0], bk.ids_per_shard[s]).sum()) for w in want for bk in buckets)
            for s in range(2)]
    hot = int(np.argmax(most))
    assert most[hot] > most[1 - hot], most
    res = run_ranks(tmp_path, 2, "matcher", local_shards=1, db=db, h_shard=most[1 - hot])
    assert sorted(r["mesh"]["tp_rank"] for r in res) == [0, 1]
    for r in res:
        assert r["out"]["stats"]["second_passes"] >= 1
        assert r["out"]["stats"]["second_pass_queries"] >= 1
        for g, w in zip(r["out"]["triples"], want):
            assert all(np.array_equal(x, y) for x, y in zip(g, w))
