"""Entry points: a single-device forward step and a dry run of the sharded
search on a mesh (the port's counterparts of the JAX package's
__graft_entry__.entry and dryrun_multichip).

entry(): (fn, example_args): fn is the flagship compute's device core,
batched per-mask seed matching and hit scoring over a padded seed table
(kernels/seed_match_shard.py, B11), with its example inputs on the device.

dryrun_multichip(n): a ("dp", "tp") mesh of one rank with n local shards
(parallel/sharded.py::make_mesh; over the ranks of a process group when
one exists), the seed table cut along the masks over tp and the query
batch over dp, one sharded step with the partial scores all-reduced over
tp; then the real search pipeline with its seed table sharded over the
mesh, on a synthetic index, against the host engine's rows.

    python -m lexicmap_tpu_torch.entry [--device cuda|cpu] [--shards 8]
"""

from __future__ import annotations

import numpy as np


def _example_arrays(n_masks=512, entries=64, batch=8, k=16, seed=0):
    """Toy seed tables of uint32 k-mers (k <= 16), rows sorted, and a batch
    of queries drawn from them, some lanes 0 (masks without a k-mer)."""
    rng = np.random.default_rng(seed)
    seed_kmers = np.sort(
        rng.integers(1, 1 << (2 * k), size=(n_masks, entries), dtype=np.uint32), axis=1
    )
    query = seed_kmers[np.arange(n_masks), rng.integers(0, entries, size=n_masks)]
    queries = np.tile(query, (batch, 1))
    queries[:, rng.integers(0, n_masks, size=n_masks // 8)] = 0
    return seed_kmers, queries


def entry(device=None):
    """Returns (fn, example_args): fn(seed_kmers, query_kmers) -> float32
    [B] scores, the args int32 tensors (uint32 bits) on `device` ("cuda",
    the default, or "cpu")."""
    import torch

    from .kernels.seed_match_shard import seed_match_shard
    from .parallel import resolve_device

    dev = resolve_device(device)
    k, min_prefix = 16, 12

    def fn(seed_kmers, query_kmers):
        return seed_match_shard(seed_kmers, query_kmers, k, min_prefix)[2]

    seeds, queries = _example_arrays()
    return fn, tuple(torch.from_numpy(a.view(np.int32)).to(dev) for a in (seeds, queries))


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One sharded step on a mesh of one rank with `n_devices` local shards
    on `device`, then the real pipeline on it; raises on a wrong result."""
    from .parallel.sharded import make_mesh, make_sharded_search_step, shard_arrays

    with make_mesh(local_shards=n_devices, device=device) as mesh:
        n_masks = 64 * mesh.tp
        batch = 4 * mesh.dp
        seed_kmers, queries = _example_arrays(n_masks=n_masks, entries=32, batch=batch)
        step = make_sharded_search_step(mesh, k=16, min_prefix=12)
        out = step(*shard_arrays(mesh, seed_kmers, queries)).cpu().numpy()
        if out.shape != (batch,):
            raise AssertionError(f"scores of shape {out.shape}, expected ({batch},)")
        # every query k-mer came from the table, so each query has hits
        if not (out > 0).all():
            raise AssertionError(f"a query scored nothing: {out}")
        print(f"dryrun_multichip ok: mesh dp={mesh.dp} tp={mesh.tp} on {mesh.device}, "
              f"masks={n_masks}, batch={batch}, scores={out[:4]}")
        _dryrun_real_pipeline(mesh)


def _dryrun_real_pipeline(mesh) -> None:
    """The search pipeline with its seed table sharded over the mesh (tp:
    whole masks' entry rows; dp: the query batch) gives the host engine's
    rows on a tiny synthetic index."""
    import tempfile

    from .cli import format_hit_rows
    from .index.search import IndexSearcher, SearchOptions
    from .parallel.sharded import ShardedSeedMatcher
    from .utils.kmers import seq_to_codes

    with tempfile.TemporaryDirectory(prefix="lexicmap_dryrun_") as tmp:
        db, seqs = _dryrun_tiny_index(tmp)
        idx = IndexSearcher(db, SearchOptions())
        rng = np.random.default_rng(5)
        alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
        queries = []
        for gi, seq in enumerate(seqs):
            q = bytearray(seq[3000 + 1000 * gi: 5000 + 1000 * gi])
            for pos in rng.integers(0, len(q), size=10):
                q[pos] = alphabet[rng.integers(0, 4)]
            queries.append(bytes(q))

        matcher = ShardedSeedMatcher(idx, mesh)
        codes = [seq_to_codes(q) for q in queries]
        masked = [idx._mask_query(c) for c in codes]
        dev = matcher.match_batch(np.stack([m[0] for m in masked]), idx.opt.min_prefix)
        n_rows = 0
        for qi, c in enumerate(codes):
            host_rows = list(format_hit_rows(f"q{qi}", len(queries[qi]), idx.search(c)))
            shard_rows = list(format_hit_rows(f"q{qi}", len(queries[qi]), idx.search(
                c, premasked=masked[qi], dev_hits_pre=dev[qi])))
            if not host_rows:
                raise AssertionError(f"dryrun query {qi} found nothing")
            if shard_rows != host_rows:
                raise AssertionError(f"dryrun query {qi}: the sharded rows differ from the host's")
            n_rows += len(host_rows)
    print(f"dryrun real pipeline ok: mesh dp={mesh.dp} tp={mesh.tp}, {len(queries)} queries, "
          f"{n_rows} rows identical to the host engine's")


def _dryrun_tiny_index(root: str):
    """A 4-genome (40 kb each), 512-mask index under `root`; returns (db,
    genome sequences)."""
    import os

    from .index.build import BuildOptions, build_index

    rng = np.random.default_rng(7)
    files, seqs = [], []
    for i in range(4):
        seq = bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=40000))
        path = os.path.join(root, f"G{i}.fasta")
        with open(path, "wb") as fh:
            fh.write(b">c0\n" + seq + b"\n")
        files.append(path)
        seqs.append(seq)
    db = os.path.join(root, "tiny.lmt")
    build_index(db, files, BuildOptions(k=31, n_masks=512, chunks=2))
    return db, seqs


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="lexicmap_tpu_torch.entry", description=__doc__)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--shards", type=int, default=8, help="local shards of the dry run's mesh")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    print("entry:", fn(*example)[:4].cpu().numpy())
    dryrun_multichip(args.shards, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
