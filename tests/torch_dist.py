"""Runs a task of the port's sharded code on n gloo ranks on the CPU, one
subprocess each, for tests/test_torch_sharded.py and
tests/test_torch_multiproc.py.  Imports nothing of JAX.

    results = run_ranks(workdir, n, "step", k=16, p=15, local_shards=2)

The test writes the task's inputs under `workdir` (numpy files); each rank
joins a process group through a file store there (with a timeout), runs the
task and pickles its result to rank<r>.pkl.  A rank that fails or outlives
`timeout` seconds stops the others and fails the call."""

from __future__ import annotations

import datetime
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def rank_env() -> dict:
    """The subprocesses' environment: the repo importable, one intra-op
    thread (the test workers share the machine's cores)."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, HERE]), OMP_NUM_THREADS="1")


def task_step(workdir, mesh, k, p):
    from lexicmap_tpu_torch.parallel.sharded import make_sharded_search_step, shard_arrays

    seeds = np.load(os.path.join(workdir, "seeds.npy"))
    queries = np.load(os.path.join(workdir, "queries.npy"))
    step = make_sharded_search_step(mesh, k=k, min_prefix=p)
    return step(*shard_arrays(mesh, seeds, queries)).numpy()


def task_matcher(workdir, mesh, db, h_shard):
    from lexicmap_tpu_torch.index.search import IndexSearcher, SearchOptions
    from lexicmap_tpu_torch.parallel.sharded import ShardedSeedMatcher
    from lexicmap_tpu_torch.utils.spans import SpanRecorder

    idx = IndexSearcher(db, SearchOptions())
    m = ShardedSeedMatcher(idx, mesh)
    m.H_SHARD = h_shard
    kmers = np.load(os.path.join(workdir, "kmers.npy"))
    rec = SpanRecorder()
    rec.bind_thread()
    triples = m.match_batch(kmers, idx.opt.min_prefix)
    # the matcher's counters, by the names after `match.`
    stats = {k: rec.totals["match." + k] for k in ("second_passes", "second_pass_queries")}
    return {"triples": triples, "stats": stats}


TASKS = {"step": task_step, "matcher": task_matcher}


def rank_main(task, rank, n, workdir, local_shards, kwargs):
    import torch
    import torch.distributed as dist

    from lexicmap_tpu_torch.parallel.sharded import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(workdir, "store"),
                            rank=rank, world_size=n, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(local_shards=local_shards, device="cpu")
        out = TASKS[task](workdir, mesh, **kwargs)
        shape = {"dp": mesh.dp, "tp": mesh.tp, "dp_index": mesh.dp_index,
                 "tp_rank": mesh.tp_rank}
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump({"out": out, "mesh": shape}, fh)
    finally:
        dist.destroy_process_group()


def run_ranks(workdir, n, task, local_shards, timeout=240, **kwargs) -> list:
    """Run `task` on n ranks; returns each rank's {"out", "mesh"}."""
    workdir = os.path.abspath(str(workdir))
    store = os.path.join(workdir, "store")
    if os.path.exists(store):
        os.remove(store)
    logs = [os.path.join(workdir, f"rank{r}.log") for r in range(n)]
    procs = []
    for r in range(n):
        with open(logs[r], "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), task, str(r), str(n), workdir,
                 str(local_shards), json.dumps(kwargs)],
                cwd=ROOT, env=rank_env(), stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = []
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(logs[r], "rb") as fh:
                bad.append((r, p.returncode, fh.read().decode(errors="replace")[-3000:]))
    if bad:
        raise AssertionError(f"ranks failed: {bad}")
    res = []
    for r in range(n):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as fh:
            res.append(pickle.load(fh))
    return res


if __name__ == "__main__":
    t, r, n, w, ls, kw = sys.argv[1:7]
    rank_main(t, int(r), int(n), w, int(ls), json.loads(kw))
