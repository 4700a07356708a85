"""Multi-process search over torch.distributed: one seed table sharded
along the masks over the processes' devices.

The launcher starts `--nprocs` workers (this module again, with --procid),
which join one process group: NCCL with `--device cuda` (rank r on
cuda:r), gloo with `--device cpu`.  The mesh is ("dp" = 1, "tp" = nprocs x
--local-devices): each worker holds --local-devices tp shards of the seed
table on its device (parallel/sharded.py).  Then, as the JAX package's
lexicmap_tpu/parallel/multiproc.py:

  * phase 2a (seed matching) on the global mesh: every worker matches
    every query batch (the same batches in the same order, SPMD), and the
    per-shard hits ride an all-gather across the processes;
  * the host phases divided across the workers by query (qidx % nprocs);
    with --twins device, phases 3-5 of a worker's queries run on its own
    device through the mesh engine (parallel/engine.py), chain1 and the
    WFA included;
  * a final merge: the workers' rows, pickled into padded byte buffers,
    ride an all-gather; rank 0 writes the TSV in global query order
    (identical to the single-process TSV) and a summary.json.

Usage (the launcher starts the workers and returns non-zero if any fails,
after stopping the others):
  python -m lexicmap_tpu_torch.parallel.multiproc --db DB -q QUERY.fa -o OUT.tsv \\
      --nprocs 2 [--local-devices 1] [--twins host|device] [--device cuda|cpu] \\
      [--batch 32] [--repeat 1] [--timeout SECONDS] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import pickle
import sys
import time

#: seconds a worker waits in the group's set-up or a collective before it
#: fails instead of hanging
GROUP_TIMEOUT_S = 600


def _parse(argv):
    ap = argparse.ArgumentParser(prog="lexicmap_tpu_torch.parallel.multiproc")
    ap.add_argument("--db", required=True)
    ap.add_argument("-q", "--query", required=True)
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--procid", type=int, default=-1, help="internal: worker rank")
    ap.add_argument("--local-devices", type=int, default=1,
                    help="tp shards of the seed table each worker holds on its device")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--repeat", type=int, default=1,
                    help="search the query stream this many times (timing)")
    ap.add_argument("--twins", choices=["host", "device"], default="host",
                    help="device: phases 3-5 of each worker's queries on its own device "
                    "(the mesh engine with --chain device --wfa device); host: the host "
                    "phases")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: NCCL, worker r on cuda:r; cpu: gloo and the kernels' plain "
                    "versions")
    ap.add_argument("--timeout", type=float, default=0,
                    help="seconds after which the launcher stops every worker and exits "
                    "with 124 (0: no limit)")
    ap.add_argument("--workdir", default="",
                    help="shared scratch directory of the workers (the group's store, "
                    "summary.json); a new temporary one by default")
    return ap.parse_args(argv)


# ---------------------------------------------------------------------------
# worker


def worker_main(args) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..cli import TSV_HEADER, format_hit_rows
    from ..index.search import IndexSearcher, SearchOptions
    from ..utils.fasta import read_fastx
    from ..utils.kmers import seq_to_codes
    from .engine import DeviceSearchEngine, match_phase
    from .sharded import ShardedSeedMatcher, make_mesh

    pid, n = args.procid, args.nprocs
    t_init0 = time.time()
    if args.device == "cuda":
        dev = torch.device("cuda", pid)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method="file://" + os.path.join(args.workdir, "group_store"),
        rank=pid, world_size=n, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        mesh = make_mesh(dp=1, local_shards=args.local_devices, device=dev)
        twins = args.twins == "device"
        idx = IndexSearcher(args.db, SearchOptions(
            device=str(dev), chain_engine=args.twins, wfa_engine=args.twins))
        eng = DeviceSearchEngine(idx, mesh=mesh) if twins else None
        matcher = eng.matcher if twins else ShardedSeedMatcher(idx, mesh)
        if pid == 0:
            print(f"[multiproc] {n} processes x {args.local_devices} shards on "
                  f"{args.device}; twins={args.twins}; {matcher.describe()}",
                  file=sys.stderr)

        records = [(r.id.decode(), bytes(r.seq)) for r in read_fastx(args.query)]
        queries = records * args.repeat

        t_dev = 0.0  # phase 1 + 2a on the global mesh (every worker, every query)
        t_host = 0.0  # this worker's phases 2b-6 (its query share)
        rows_of: dict[int, list[str]] = {}
        t_run0 = time.time()
        for b0 in range(0, len(queries), args.batch):
            batch = queries[b0: b0 + args.batch]
            t0 = time.time()
            codes = [seq_to_codes(s.upper()) for _, s in batch]
            valid = [i for i, c in enumerate(codes) if c.shape[0] >= idx.k]
            if not valid:
                continue
            masked = {i: idx._mask_query(codes[i]) for i in valid}
            dev_hits = dict(zip(valid, match_phase(
                idx, matcher, np.stack([masked[i][0] for i in valid]))))
            t_dev += time.time() - t0

            t0 = time.time()
            own = [i for i in valid if (b0 + i) % n == pid]
            if twins and own:
                prepared = eng.prepare_batch([batch[i][1] for i in own],
                                             {j: (masked[i], dev_hits[i])
                                              for j, i in enumerate(own)})
                hits = dict(zip(own, eng.finish_batch(prepared)))
            else:
                hits = {i: idx.search(codes[i], premasked=masked[i], dev_hits_pre=dev_hits[i])
                        for i in own}
            for i in own:
                qid, seq = batch[i]
                rows_of[b0 + i] = list(format_hit_rows(qid, len(seq), hits[i]))
            t_host += time.time() - t0
        t_run = time.time() - t_run0

        # the merge: every worker's rows as pickled, padded byte buffers,
        # all-gathered; rank 0 writes them in global query order (the live
        # form of the reference's per-index TSV merge, merge-search-results.go)
        t_merge0 = time.time()
        payload = np.frombuffer(pickle.dumps({
            "rows_of": rows_of, "t_dev": t_dev, "t_host": t_host, "t_run": t_run,
            "t_init": t_run0 - t_init0, "n_queries": len(rows_of)}), dtype=np.uint8)
        size = torch.tensor([payload.shape[0]], dtype=torch.int64, device=dev)
        sizes = torch.empty(n, dtype=torch.int64, device=dev)
        dist.all_gather_into_tensor(sizes, size)
        sizes = sizes.cpu().numpy()
        cap = int(sizes.max())
        padded = torch.zeros(cap, dtype=torch.uint8, device=dev)
        padded[: payload.shape[0]] = torch.from_numpy(payload.copy()).to(dev)
        parts = torch.empty(n * cap, dtype=torch.uint8, device=dev)
        dist.all_gather_into_tensor(parts, padded)
        parts = parts.cpu().numpy().reshape(n, cap)
        stats = [pickle.loads(parts[p, : int(sizes[p])].tobytes()) for p in range(n)]
        t_merge = time.time() - t_merge0

        if pid == 0:
            merged: dict[int, list[str]] = {}
            for d in stats:
                merged.update(d["rows_of"])
            with open(args.out, "w") as out:
                out.write(TSV_HEADER + "\n")
                for qidx in sorted(merged):
                    for row in merged[qidx]:
                        out.write(row + "\n")
            summary = {
                "nprocs": n,
                "local_devices": args.local_devices,
                "twins": args.twins,
                "device": args.device,
                "queries": len(merged),
                "wall_s": max(d["t_run"] for d in stats),
                "merge_s": t_merge,
                "per_proc_host_s": [d["t_host"] for d in stats],
                "per_proc_dev_s": [d["t_dev"] for d in stats],
                "per_proc_queries": [d["n_queries"] for d in stats],
                "per_proc_init_s": [d["t_init"] for d in stats],
                "host_balance": min(d["t_host"] for d in stats)
                / max(max(d["t_host"] for d in stats), 1e-9),
            }
            with open(os.path.join(args.workdir, "summary.json"), "w") as fh:
                json.dump(summary, fh)
            print(f"[multiproc] {json.dumps(summary)}", file=sys.stderr)
    finally:
        dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# launcher


def launch(args) -> int:
    import subprocess
    import tempfile

    if args.nprocs < 1 or args.local_devices < 1:
        raise SystemExit("--nprocs and --local-devices must be at least 1")
    if args.device == "cuda":
        import torch

        have = torch.cuda.device_count()
        if args.nprocs > have:
            raise SystemExit(f"--nprocs {args.nprocs} with --device cuda needs {args.nprocs} "
                             f"CUDA devices (one a worker; NCCL takes no two ranks on one "
                             f"device), {have} present; use --local-devices for more shards "
                             f"on one device, or --device cpu")
    # the workers resolve no path of their own: they get absolute ones
    args.db, args.query, args.out = (os.path.abspath(p) for p in (args.db, args.query, args.out))
    args.workdir = os.path.abspath(args.workdir or tempfile.mkdtemp(prefix="lexicmap_mp_"))
    os.makedirs(args.workdir, exist_ok=True)
    store = os.path.join(args.workdir, "group_store")
    if os.path.exists(store):
        os.remove(store)  # a file store is made afresh for every group
    # the workers import this package from where the launcher found it,
    # whatever the directory they start in
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, path]) if path else root)
    procs = []
    for p in range(args.nprocs):
        cmd = [sys.executable, "-m", "lexicmap_tpu_torch.parallel.multiproc",
               "--db", args.db, "-q", args.query, "-o", args.out,
               "--nprocs", str(args.nprocs), "--procid", str(p),
               "--local-devices", str(args.local_devices), "--batch", str(args.batch),
               "--repeat", str(args.repeat), "--twins", args.twins, "--device", args.device,
               "--workdir", args.workdir]  # no --timeout: the launcher keeps the time
        procs.append(subprocess.Popen(cmd, env=env))
    # wait for all; the first failure, or the time limit, stops the rest (a
    # peer blocked in a collective would otherwise wait out the group's
    # timeout)
    rc = 0
    deadline = time.monotonic() + args.timeout if args.timeout > 0 else None
    try:
        live = list(procs)
        while live:
            for p in list(live):
                code = p.poll()
                if code is None:
                    continue
                live.remove(p)
                if code != 0 and rc == 0:
                    rc = code
                    print(f"[multiproc] a worker exited with {code}; stopping the others",
                          file=sys.stderr)
                    for q in live:
                        q.kill()
            if live and deadline is not None and time.monotonic() > deadline:
                print(f"[multiproc] over the {args.timeout} s limit; stopping the workers",
                      file=sys.stderr)
                for q in live:
                    q.kill()
                return 124
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return rc


def main(argv=None) -> int:
    args = _parse(argv if argv is not None else sys.argv[1:])
    if args.procid >= 0:
        return worker_main(args)
    return launch(args)


if __name__ == "__main__":
    sys.exit(main())
