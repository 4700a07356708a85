"""Mask-sharded seed matching over torch.distributed.

The distribution axes (the JAX package's, lexicmap_tpu/parallel/sharded.py):
  dp = query batch  (the reference's per-query worker pool, search.go:585)
  tp = mask axis    (the reference's seed chunk files, kv-searcher per chunk)

A mesh is a DeviceMesh of dims ("dp", "tp") over the ranks of the default
process group, each rank holding `local_shards` (L) shards of the tp axis
on its own device: tp = (ranks along tp) x L, and global shard t*L + l is
local shard l of the rank at tp coordinate t.  One process with L shards
is the mesh of one card; several processes (NCCL on CUDA, gloo on the CPU)
spread the shards over the ranks' devices.  JAX's shard_map becomes
kernel launches over the local shards (the search step's one launch serves
them all) and a collective over the ranks: psum becomes all_reduce over
the tp group, the tiled all_gather an all-gather of fixed-shape slabs over
tp, then over dp, so that every rank holds every query's result.

Every rank calls the collective functions here (the search step,
ShardedSeedMatcher.match_batch) on the same batches in the same order;
only host work after them may be divided.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.seed_locate import seed_locate_batch, split_kmers_hi_lo
from ..kernels.seed_match_shard import seed_match_shard
from ..kernels.shard_compact import shard_compact
from . import count_h2d, fetch_numpy, resolve_device
from .device_search import bucket_edges_for, collect_per_mask_tables, pack_bucket_rows, tile_for

#: entries above which a mask stays on the host tier (whole masks per shard
#: row; the single-card matcher column-chunks them instead)
SHARD_MAX_E = 1 << 17
#: the JAX sharded matcher's row tile request (its _shard_tile_for)
SHARD_TILE_M = 200


class Mesh:
    """A ("dp", "tp") DeviceMesh over the ranks, with `local_shards` tp
    shards on each rank's `device`."""

    def __init__(self, device_mesh, local_shards: int, device: torch.device, owns_group: bool):
        self.device_mesh = device_mesh
        self.local_shards = local_shards
        self.device = device
        self._owns_group = owns_group
        self.dp, self.tp_ranks = (int(n) for n in device_mesh.mesh.shape)
        self.dp_index, self.tp_rank = device_mesh.get_coordinate()
        self.tp = self.tp_ranks * local_shards
        #: the global tp shards this rank holds, in local order
        self.local = list(range(self.tp_rank * local_shards, (self.tp_rank + 1) * local_shards))
        self.tp_group = device_mesh.get_group("tp")
        self.dp_group = device_mesh.get_group("dp")

    def gather(self, t: torch.Tensor, dim: str) -> torch.Tensor:
        """All-gather of `t` over the `dim` ("tp" or "dp") group,
        concatenated along dim 0 in the group's order."""
        group, n = (self.tp_group, self.tp_ranks) if dim == "tp" else (self.dp_group, self.dp)
        out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t.contiguous(), group=group)
        return out

    def close(self):
        """Destroy the process group if make_mesh made it."""
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_group = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __repr__(self):
        return (f"Mesh(dp={self.dp}, tp={self.tp} = {self.tp_ranks} ranks x "
                f"{self.local_shards} local shards, device={self.device})")


def make_mesh(dp: int | None = None, local_shards: int = 1, device=None) -> Mesh:
    """The ("dp", "tp") mesh over the ranks of the default process group,
    `local_shards` tp shards a rank.

    With no process group yet, one of world size 1 is made here, NCCL for
    a CUDA device and gloo for the CPU (and destroyed by Mesh.close).
    dp defaults to the JAX package's factorization of the ranks: 2 when
    their number is even and above 2, else 1.  device: "cuda" (the
    default; cuda:<rank> when no index is given) or "cpu"."""
    dev = resolve_device(device)
    if local_shards < 1:
        raise ValueError(f"local_shards must be at least 1, got {local_shards}")
    owns = False
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
        owns = True
    n, rank = dist.get_world_size(), dist.get_rank()
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank)
    if dp is None:
        dp = 2 if n % 2 == 0 and n > 2 else 1
    if dp < 1 or n % dp:
        raise ValueError(f"dp = {dp} does not divide the {n} ranks")
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev.type, (dp, n // dp), mesh_dim_names=("dp", "tp"))
    return Mesh(dm, local_shards, dev, owns)


def make_sharded_search_step(mesh: Mesh, k: int = 31, min_prefix: int = 15):
    """The sharded search step: step(s_seeds, s_queries) -> scores float32
    [B], every query's seed score (the sum of hit-weighted LCPs over all
    masks), on every rank.

    s_seeds int32 [L, M/tp, E] and s_queries int32 [L, B/dp, M/tp], this
    rank's shards as `shard_arrays` cuts them.  One seed_match_shard launch
    serves every local shard and sums the rank's partial scores; they are
    all-reduced over tp, then gathered over dp."""

    def step(s_seeds, s_queries):
        part = seed_match_shard(s_seeds, s_queries, k, min_prefix)[2]
        dist.all_reduce(part, op=dist.ReduceOp.SUM, group=mesh.tp_group)
        return mesh.gather(part, "dp")

    return step


def shard_arrays(mesh: Mesh, seed_kmers: np.ndarray, query_kmers: np.ndarray):
    """This rank's shards of the step's inputs, on the mesh's device:
    seed_kmers uint32 [M, E] cut along the masks into tp blocks, query_kmers
    uint32 [B, M] into dp blocks of queries and tp blocks of masks (JAX's
    P("tp", None) and P("dp", "tp")).  Returns int32 tensors [L, M/tp, E]
    and [L, B/dp, M/tp] holding the uint32 bits."""
    for name, a in (("seed_kmers", seed_kmers), ("query_kmers", query_kmers)):
        if a.dtype != np.uint32:
            raise TypeError(f"{name} must be uint32 (k <= 16), got {a.dtype}")
    (M, E), B = seed_kmers.shape, query_kmers.shape[0]
    if query_kmers.shape[1] != M or M % mesh.tp or B % mesh.dp:
        raise ValueError(f"[{M}, {E}] seeds and [{B}, {query_kmers.shape[1]}] queries do not "
                         f"divide over dp = {mesh.dp}, tp = {mesh.tp}")
    L, ml, bl = mesh.local_shards, M // mesh.tp, B // mesh.dp
    m0, b0 = mesh.local[0] * ml, mesh.dp_index * bl
    seeds = seed_kmers[m0: m0 + L * ml].reshape(L, ml, E)
    queries = query_kmers[b0: b0 + bl, m0: m0 + L * ml].reshape(bl, L, ml).transpose(1, 0, 2)
    return tuple(torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(mesh.device)
                 for a in (seeds, queries))


# ---------------------------------------------------------------------------
# The search pipeline's sharded seed matching


@dataclass
class ShardBucket:
    """One entry-count bucket: every shard's rows of it, this rank's packed.
    hi and gids hold the uint32 bits as int32."""

    E: int
    tile: int
    mb_pad: int  # rows a shard, padded to the tile
    ids_per_shard: list  # mask ids of each tp shard's rows (all shards)
    hi: torch.Tensor  # int32 [L, mb_pad, E], PAD_HI after cnt
    cnt: torch.Tensor  # int32 [L, mb_pad]
    gids: torch.Tensor  # int32 [L, mb_pad], -1 on padding rows


def shards_from_jax_matcher(arrays) -> list[ShardBucket]:
    """The JAX ShardedSeedMatcher's buckets, passed as numpy (each bucket's
    (E, tile, hi [tp, mb_pad, E], cnt, gids, mb_pad, ids_per_shard) with
    the arrays through np.asarray), as this matcher's tables on the CPU:
    every shard, as a one-rank mesh with L = tp holds them.  Imports
    nothing of JAX."""
    out = []
    for E, tile, hi, cnt, gids, mb_pad, ids_per_shard in arrays:
        out.append(ShardBucket(
            E=int(E), tile=int(tile), mb_pad=int(mb_pad),
            ids_per_shard=[np.asarray(ids, dtype=np.int64) for ids in ids_per_shard],
            hi=torch.from_numpy(np.asarray(hi, dtype=np.uint32).view(np.int32).copy()),
            cnt=torch.from_numpy(np.asarray(cnt, dtype=np.int32).copy()),
            gids=torch.from_numpy(np.asarray(gids, dtype=np.uint32).view(np.int32).copy()),
        ))
    return out


class ShardedSeedMatcher:
    """`match_batch` (the same triples as DeviceSeedMatcher's) over the
    index's seed table sharded along the masks over a Mesh.

    The layout is the JAX sharded matcher's: hi-word rows of whole masks in
    entry-count buckets, mask i on tp shard i % tp (round robin balances the
    repeat-heavy masks), each shard's rows padded to the JAX tile rule, and
    per query, shard and bucket H = min(H_SHARD, rows) hits compacted.
    Masks of more than SHARD_MAX_E entries stay on the host tier.  Each
    local shard is one seed_locate_batch launch (B1) and one shard_compact
    launch; the slabs of (gid, e0, n_hits) and counts are gathered over tp,
    then dp.  Where a query has more than H hits on a shard, the bucket is
    compacted again from the same B1 outputs at the largest gathered count
    (JAX's matcher declines such a query instead).  Downstream (posting
    gather, chaining, alignment) is the host code, so rows equal the host
    engine's.

    stats: batches matched, buckets compacted a second time and the
    queries that took their triples from such a pass."""

    #: per-(query, shard, bucket) compacted-hit capacity of the first pass
    H_SHARD = 1536

    def __init__(self, index_searcher, mesh: Mesh):
        self.idx = index_searcher
        self.mesh = mesh
        self.device = mesh.device
        self.k = index_searcher.k
        self.m = index_searcher.mask_set.m
        self.tp, self.dp = mesh.tp, mesh.dp
        self.stats = {"batches": 0, "second_passes": 0, "second_pass_queries": 0}

        per_mask = collect_per_mask_tables(index_searcher)
        if len(per_mask) != self.m:
            raise ValueError(f"index has {len(per_mask)} mask tables, expected {self.m}")
        counts = np.array([a.shape[0] for a in per_mask], dtype=np.int64)
        edges = bucket_edges_for(counts, cap=SHARD_MAX_E)
        shard_of = np.arange(self.m) % self.tp

        self.buckets: list[ShardBucket] = []
        self.hbm_bytes = 0  # over all shards, as the JAX matcher counts
        assigned = counts > SHARD_MAX_E
        host_ids = np.nonzero(assigned)[0]
        L = mesh.local_shards
        for E in edges:
            sel = ~assigned & (counts <= E)
            assigned |= counts <= E
            if not sel.any():
                continue
            ids_per_shard = [np.nonzero(sel & (shard_of == s))[0] for s in range(self.tp)]
            mb = max(ids.shape[0] for ids in ids_per_shard)
            tile = tile_for(E, SHARD_TILE_M)
            mb_pad = max(-(-mb // tile) * tile, tile)
            hi = np.empty((L, mb_pad, E), dtype=np.uint32)
            cnt = np.empty((L, mb_pad), dtype=np.int32)
            gids = np.empty((L, mb_pad), dtype=np.uint32)
            for l, s in enumerate(mesh.local):
                ids = ids_per_shard[s]
                if ids.shape[0] > 1 and not (np.diff(ids) > 0).all():
                    # shard_compact keeps hits in row order, JAX's gid order
                    # only where the gids rise with the row
                    raise AssertionError(f"shard {s}: mask ids do not rise with the row")
                hi[l], cnt[l], gids[l] = pack_bucket_rows(per_mask, ids, self.k, E, mb_pad)
            count_h2d("sharded seed table", hi, cnt, gids)
            d = self.device
            self.buckets.append(ShardBucket(
                E=E, tile=tile, mb_pad=mb_pad, ids_per_shard=ids_per_shard,
                hi=torch.from_numpy(hi.view(np.int32)).to(d),
                cnt=torch.from_numpy(cnt).to(d),
                gids=torch.from_numpy(gids.view(np.int32)).to(d)))
            self.hbm_bytes += self.tp * mb_pad * E * 4
        self.host_tables = {int(mi): per_mask[mi] for mi in host_ids}

    def describe(self) -> str:
        parts = [f"E={b.E} x {b.mb_pad}x{self.tp} shard rows (tile {b.tile})"
                 for b in self.buckets]
        if self.host_tables:
            parts.append(f"host: {len(self.host_tables)} masks")
        return (f"sharded seed table: {self.hbm_bytes / 1e6:.1f} MB total device memory over "
                f"tp={self.tp} ({self.mesh.tp_ranks} ranks x {self.mesh.local_shards} on "
                f"{self.device}) [" + ", ".join(parts) + "]")

    def capacity(self, bucket: ShardBucket) -> int:
        return min(self.H_SHARD, bucket.mb_pad)

    def _compact_all(self, bk: ShardBucket, located, H: int) -> torch.Tensor:
        """shard_compact of every local shard's B1 outputs at capacity H,
        gathered over tp, then dp: int32 [dp * tp, bl, 3H + 1]."""
        L, bl = self.mesh.local_shards, located[0][0].shape[0]
        slab = torch.empty((L, bl, 3 * H + 1), dtype=torch.int32, device=self.device)
        for l, (nh, e0) in enumerate(located):
            shard_compact(nh, e0, bk.gids[l], H, out=slab[l])
        return self.mesh.gather(self.mesh.gather(slab, "tp"), "dp")

    def match_batch(self, query_kmers_batch: np.ndarray, min_prefix: int):
        """query_kmers_batch [B, m] u64 (0 = no captured k-mer) -> per-query
        (hit_masks, e0, n_hits) int64 triples sorted by mask.

        Collective: every rank calls it with the same B.  The first pass
        compacts each bucket at its capacity H and gathers the slabs.  A
        bucket whose gathered counts hold an n > H is compacted again, from
        the B1 outputs kept on the card, at H2 = the largest gathered n of
        the bucket, and gathered again.  The gathered counts are the same on
        every rank, so every rank decides the second pass alike, at the same
        H2, and makes the same collectives: a decision from a rank's own
        counts would let one rank skip a gather that another makes, and hang
        the group."""
        mesh, L = self.mesh, self.mesh.local_shards
        B = query_kmers_batch.shape[0]
        b_pad = -(-B // self.dp) * self.dp
        bl = b_pad // self.dp
        sel = np.zeros((b_pad, self.m), dtype=bool)
        sel[:B] = query_kmers_batch != 0
        qh_full = np.zeros((b_pad, self.m), dtype=np.uint32)
        if sel.any():
            qh_full[sel] = split_kmers_hi_lo(query_kmers_batch[sel[:B]], self.k)[0]
        mine = slice(mesh.dp_index * bl, (mesh.dp_index + 1) * bl)
        qh_mine, sel_mine = qh_full[mine], sel[mine]

        pending, located = [], []
        for bk in self.buckets:
            qh = np.zeros((L, bl, bk.mb_pad), dtype=np.uint32)
            qv = np.zeros((L, bl, bk.mb_pad), dtype=bool)
            for l, s in enumerate(mesh.local):
                ids = bk.ids_per_shard[s]
                qh[l, :, : ids.shape[0]] = qh_mine[:, ids]
                qv[l, :, : ids.shape[0]] = sel_mine[:, ids]
            count_h2d("sharded seed matching", qh, qv)
            qh_d = torch.from_numpy(qh.view(np.int32)).to(self.device)
            qv_d = torch.from_numpy(qv).to(self.device)
            located.append([seed_locate_batch(bk.hi[l], bk.cnt[l], qh_d[l], qv_d[l], min_prefix)
                            for l in range(L)])
            pending.append(self._compact_all(bk, located[-1], self.capacity(bk)))
        fetched = fetch_numpy("sharded seed matching", *pending) if pending else []

        # the second pass, decided from the gathered counts alone
        over = np.zeros(b_pad, dtype=bool)
        again = []
        for i, (bk, a) in enumerate(zip(self.buckets, fetched)):
            H = (a.shape[2] - 1) // 3
            n = a[..., 3 * H]  # [dp * tp, bl]
            H2 = int(n.max()) if n.size else 0
            if H2 > H:
                over |= (n.reshape(self.dp, self.tp, bl) > H).any(1).reshape(-1)
                again.append((i, self._compact_all(bk, located[i], H2)))
        if again:
            for (i, _), a in zip(again, fetch_numpy("sharded seed matching",
                                                    *(g for _, g in again))):
                fetched[i] = a
        self.stats["batches"] += 1
        self.stats["second_passes"] += len(again)
        self.stats["second_pass_queries"] += int(over[:B].sum())

        per_query: list[list] = [[] for _ in range(B)]
        for a in fetched:
            W = a.shape[2]
            H = (W - 1) // 3
            # [dp, tp, bl, W] -> [b_pad, tp, W]
            a = a.reshape(self.dp, self.tp, bl, W).transpose(0, 2, 1, 3).reshape(b_pad, self.tp, W)
            keys = a[..., :H].view(np.uint32)
            for b in range(B):
                for s in range(self.tp):
                    n = int(a[b, s, 3 * H])
                    if n:
                        per_query[b].append((keys[b, s, :n], a[b, s, H: H + n],
                                             a[b, s, 2 * H: 2 * H + n]))

        # host bisection for the few masks over SHARD_MAX_E
        host_extra: list[list] = [[] for _ in range(B)]
        if self.host_tables:
            suf = np.uint64((1 << (2 * (self.k - min_prefix))) - 1)
            for mi, table in self.host_tables.items():
                col = query_kmers_batch[:, mi]
                for b in np.nonzero(col != 0)[0]:
                    q = col[b]
                    lo_i = int(np.searchsorted(table, q & ~suf, side="left"))
                    hi_i = int(np.searchsorted(table, q | suf, side="right"))
                    if hi_i > lo_i:
                        host_extra[b].append((mi, lo_i, hi_i - lo_i))

        out = []
        for b in range(B):
            parts = per_query[b] + [(np.array([m]), np.array([o]), np.array([n]))
                                    for m, o, n in host_extra[b]]
            hm, e0, nh = (np.concatenate([p[i] for p in parts]).astype(np.int64) if parts
                          else np.empty(0, dtype=np.int64) for i in range(3))
            if hm.shape[0] > 1:
                order = np.argsort(hm, kind="stable")
                hm, e0, nh = hm[order], e0[order], nh[order]
            out.append((hm, e0, nh))
        return out
