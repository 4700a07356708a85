"""Device-integrated seed matching for the search pipeline (phase 2a).

DeviceSeedMatcher packs the columnar seed index into device-resident
[rows, entries] hi-word tables and answers each query batch's per-mask
>=p-prefix range queries with one launch of the CUDA seed-locate kernel
(kernels/seed_locate.py) per bucket.  The kernel returns (n_hits, e0) per
(query, row); single-query `match` launches the same kernel at B = 1
(kernels/seed_locate.py::seed_locate).  PyTorch tensor code compacts the
rows with hits into (mask, e0, n_hits) triples on the device, shared by
both, and the host gathers the matched
entries/postings from the columnar store — results are identical to the
host path.

Layout (the same as the JAX matcher's, lexicmap_tpu/parallel/device_search.py):
  - only the HI word of each entry k-mer is resident: a p <= 16-base prefix
    range lives entirely in the top 32 bits, and the host computes exact
    LCPs on the gathered entries anyway.
  - masks with more than E_CAP entries are COLUMN-CHUNKED into rows of
    <= E_CAP contiguous entries; a range hit spanning chunk rows comes back
    as several triples with contiguous ranges, which match_batch merges.
  - rows are grouped into entry-count BUCKETS from the count distribution's
    quantiles, each its own [rows, E] table, so device memory is ~sum(count)
    rather than rows * max(count).
  - a device-memory budget (by default the card's free memory less an
    eighth for per-batch tensors and less phase 4's working set;
    `default_budget`) admits a row prefix of the buckets; the rest matches
    by vectorized host bisection (the host tier).  The seed table is sized
    before the genome store (parallel/engine.py), which takes what it
    leaves.

The suffix (reversed k-mer) search stays on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.seed_locate import PAD_HI, seed_locate, seed_locate_batch, split_kmers_hi_lo
from . import count_d2h, count_h2d, resolve_device
from .pseudo_device import WORKING_BYTES

# entry-count ceiling of one packed row; read at call time, so tests can
# shrink it to force column chunking
E_CAP = 1 << 14


@dataclass
class SeedBucket:
    """One packed [rows, E] table.  hi holds the uint32 bits as int32."""

    E: int
    row_masks: np.ndarray  # int64 [rows]: mask id per row (query routing)
    hi: torch.Tensor  # int32 [rows, E], PAD_HI after cnt
    cnt: torch.Tensor  # int32 [rows]
    gids: torch.Tensor  # int64 [rows]: mask id per row (row_masks on the device)
    base: torch.Tensor  # int64 [rows]: entry offset of the chunk in its mask


def collect_per_mask_tables(index_searcher) -> list[np.ndarray]:
    """Per-mask sorted entry k-mer arrays from the columnar seed chunks."""
    per_mask: list[np.ndarray] = []
    for rdr in index_searcher.chunks:
        kmers = np.asarray(rdr.kmers)
        off = np.asarray(rdr.mask_offsets)
        for mi in range(rdr.mask_end - rdr.mask_begin):
            per_mask.append(kmers[off[mi] : off[mi + 1]])
    return per_mask


def bucket_edges_for(counts: np.ndarray, cap: int | None = None) -> list[int]:
    """Entry-count bucket edges from the distribution's quantiles
    (p50/p90/p99/max, rounded up to a multiple of 128, capped at `cap`,
    E_CAP by default)."""
    if cap is None:
        cap = E_CAP
    qs = np.quantile(counts, [0.5, 0.9, 0.99, 1.0]) if counts.shape[0] else [128]
    edges: list[int] = []
    for q in qs:
        e = min(max(((int(q) + 127) // 128) * 128, 128), cap)
        # merge near-duplicate edges (uniform count distributions would
        # otherwise create several buckets of almost identical E)
        if edges and e <= edges[-1] * 9 // 8:
            edges[-1] = max(edges[-1], e)
            continue
        edges.append(e)
    return edges


#: bytes of TPU VMEM the JAX matcher lets a row tile's uint32 blocks take;
#: kept only because the tile rule below derives from it
VMEM_BUDGET = 8 << 20


def tile_for(E: int, tile_m: int) -> int:
    """The JAX matcher's row tile for rows of E entries
    (lexicmap_tpu/parallel/device_search.py::_tile_for).  The sharded
    matcher pads a bucket's rows to a multiple of it, which sets the
    bucket's row count and so its hit capacity: the port keeps the rule to
    keep the same queries over capacity."""
    return int(min(tile_m, max(8, (VMEM_BUDGET // (8 * E)) // 8 * 8)))


def pack_bucket_rows(per_mask, ids: np.ndarray, k: int, E: int, mb_pad: int):
    """Pack the whole masks `ids` into PAD_HI-padded [mb_pad, E] hi-word
    rows (the sharded matcher's mask-granular packing).

    Returns (hi u32 [mb_pad, E], cnt i32 [mb_pad], gids u32 [mb_pad], the
    mask ids, 0xFFFFFFFF on the padding rows)."""
    hi = np.full((mb_pad, E), PAD_HI, dtype=np.uint32)
    cnt = np.zeros(mb_pad, dtype=np.int32)
    for row, mi in enumerate(ids):
        h = split_kmers_hi_lo(per_mask[mi], k)[0]
        hi[row, : h.shape[0]] = h
        cnt[row] = h.shape[0]
    gids = np.full(mb_pad, PAD_HI, dtype=np.uint32)
    gids[: ids.shape[0]] = ids.astype(np.uint32)
    return hi, cnt, gids


def pack_vrow_bucket(per_mask, vmask, vstart, vcnt, rows, k, E):
    """Pack chunk rows `rows` (indices into vmask/vstart/vcnt) into
    PAD_HI-padded [len(rows), E] hi-word rows.

    Returns (hi u32, cnt i32, gids i64 (mask id), base i64 (entry offset of
    the chunk within its mask))."""
    n = rows.shape[0]
    hi = np.full((n, E), PAD_HI, dtype=np.uint32)
    cnt = vcnt[rows].astype(np.int32)
    gids = vmask[rows].astype(np.int64)
    base = vstart[rows].astype(np.int64)
    for row, vr in enumerate(rows):
        mi, s, c = int(vmask[vr]), int(vstart[vr]), int(vcnt[vr])
        if c:
            hi[row, :c] = split_kmers_hi_lo(per_mask[mi][s : s + c], k)[0]
    return hi, cnt, gids, base


def default_budget(device: torch.device) -> int:
    """Bytes a resident structure (the seed table, then the genome store)
    may take on `device`: on CUDA the free device memory less an eighth of
    it, left for the per-batch query, count and compaction tensors, and
    less phase 4's per-launch working set; on the CPU no cap (everything
    lives in host memory either way)."""
    if device.type != "cuda":
        return 1 << 62
    free, _total = torch.cuda.mem_get_info(device)
    return max(0, free - free // 8 - WORKING_BYTES)


def tables_from_jax_matcher(jax_matcher) -> list[SeedBucket]:
    """The JAX matcher's packed buckets (lexicmap_tpu DeviceSeedMatcher) in
    this matcher's layout, as CPU tensors: its tile padding rows dropped, hi
    as int32 bits.  Reads the arrays through numpy; imports nothing of JAX."""
    out = []
    for E, _tile, row_masks, d_hi, d_ids, _mb_pad, d_cnt, d_base in jax_matcher.buckets:
        n = row_masks.shape[0]
        hi = np.asarray(d_hi)[:n].astype(np.uint32)
        out.append(SeedBucket(
            E=int(E),
            row_masks=np.asarray(row_masks, dtype=np.int64),
            hi=torch.from_numpy(hi.view(np.int32).copy()),
            cnt=torch.from_numpy(np.asarray(d_cnt)[:n].astype(np.int32)),
            gids=torch.from_numpy(np.asarray(d_ids)[:n].astype(np.int64)),
            base=torch.from_numpy(np.asarray(d_base)[:n].astype(np.int64)),
        ))
    return out


class DeviceSeedMatcher:
    def __init__(self, index_searcher, device=None, hbm_budget: int | None = None):
        """device: "cuda" (default) or "cpu" (the kernel's plain twin).
        hbm_budget: byte cap for the device-resident seed table (default
        `default_budget`, read from the card).  When the table exceeds
        it, buckets are admitted in order of increasing E (most masks
        served per byte) down to a row prefix, and the remainder matches on
        the host (mmap) tier."""
        self.device = resolve_device(device)
        self.idx = index_searcher
        self.k = index_searcher.k
        self.m = index_searcher.mask_set.m
        if hbm_budget is None:
            hbm_budget = default_budget(self.device)
        e_cap = E_CAP

        per_mask = collect_per_mask_tables(index_searcher)
        if len(per_mask) != self.m:
            raise ValueError(f"index has {len(per_mask)} mask tables, expected {self.m}")
        counts = np.array([a.shape[0] for a in per_mask], dtype=np.int64)

        # column-chunk entry-heavy masks into rows of <= e_cap entries
        nchunk = np.maximum(1, -(-counts // e_cap))
        vmask_a = np.repeat(np.arange(self.m, dtype=np.int64), nchunk)
        first = np.repeat(np.cumsum(nchunk) - nchunk, nchunk)
        vstart_a = (np.arange(vmask_a.shape[0], dtype=np.int64) - first) * e_cap
        vcnt_a = np.minimum(counts[vmask_a] - vstart_a, e_cap)

        edges = bucket_edges_for(vcnt_a, e_cap)

        self.buckets: list[SeedBucket] = []
        self.hbm_bytes = 0
        self.budget_spill = 0  # chunk rows pushed to the host by the budget
        host_rows: list[int] = []
        assigned = np.zeros(vmask_a.shape[0], dtype=bool)
        for E in edges:
            rows = np.nonzero(~assigned & (vcnt_a <= E))[0]
            assigned |= vcnt_a <= E
            if rows.shape[0] == 0:
                continue
            if self.hbm_bytes + rows.shape[0] * E * 4 > hbm_budget:
                # over budget: admit only the row prefix that fits; the rest
                # of this bucket and everything after stays on the host tier
                fit = max(0, (hbm_budget - self.hbm_bytes) // (E * 4))
                host_rows.extend(rows[fit:].tolist())
                self.budget_spill += rows.shape[0] - fit
                rows = rows[:fit]
                if rows.shape[0] == 0:
                    continue
            hi, cnt, gids, base = pack_vrow_bucket(
                per_mask, vmask_a, vstart_a, vcnt_a, rows, self.k, E
            )
            d = self.device
            bucket = SeedBucket(
                E=E,
                row_masks=vmask_a[rows],
                hi=torch.from_numpy(hi.view(np.int32)).to(d),
                cnt=torch.from_numpy(cnt).to(d),
                gids=torch.from_numpy(gids).to(d),
                base=torch.from_numpy(base).to(d),
            )
            count_h2d("device seed table", hi, cnt, gids, base)
            self.buckets.append(bucket)
            self.hbm_bytes += rows.shape[0] * E * 4

        # host-tier chunk rows, concatenated for one vectorized bisection
        self.host_entries = int(vcnt_a[host_rows].sum()) if host_rows else 0
        self.total_entries = int(counts.sum())
        self.host_rows = len(host_rows)
        if host_rows:
            hr = np.array(host_rows, dtype=np.int64)
            self._ht_mi = vmask_a[hr]
            self._ht_start = vstart_a[hr]
            self._ht_off = np.zeros(hr.shape[0] + 1, dtype=np.int64)
            np.cumsum(vcnt_a[hr], out=self._ht_off[1:])
            self._ht_cat = np.concatenate(
                [per_mask[vmask_a[vr]][vstart_a[vr] : vstart_a[vr] + vcnt_a[vr]]
                 for vr in host_rows]
            ).astype(np.uint64)

    def describe(self) -> str:
        parts = [f"E={b.E} x {b.row_masks.shape[0]} rows" for b in self.buckets]
        if self.host_rows:
            cov = 1.0 - self.host_entries / max(self.total_entries, 1)
            parts.append(
                f"host tier: {self.host_rows} chunk rows"
                + (f" ({self.budget_spill} budget-spilled)" if self.budget_spill else "")
                + f"; device covers {cov:.1%} of entries"
            )
        return (
            f"device seed table ({self.device}): {self.hbm_bytes / 1e6:.1f} MB in "
            f"{len(self.buckets)} buckets [" + ", ".join(parts) + "]"
        )

    def _device_hits(self, qh: np.ndarray, sel: np.ndarray, min_prefix: int,
                     single: bool = False):
        """All buckets' hit triples as numpy (b, mask, e0, n_hits) columns.
        qh/sel are [B, m]; single=True (B == 1) runs the single-query
        kernel `seed_locate` instead of `seed_locate_batch`."""
        d = self.device
        qh_d = torch.from_numpy(qh.view(np.int32)).to(d)
        sel_d = torch.from_numpy(sel).to(d)
        count_h2d("device seed matching", qh, sel)
        parts = []
        for bk in self.buckets:
            qh_b = qh_d.index_select(1, bk.gids)
            qv_b = sel_d.index_select(1, bk.gids)
            if single:
                nh, e0 = seed_locate(bk.hi, bk.cnt, qh_b[0], qv_b[0], min_prefix)
                nh, e0 = nh[None], e0[None]
            else:
                nh, e0 = seed_locate_batch(bk.hi, bk.cnt, qh_b, qv_b, min_prefix)
            # compaction: the (query, row) pairs with hits, row-major, so
            # each query's triples are contiguous; e0 made mask-global
            b_idx, r_idx = torch.nonzero(nh > 0, as_tuple=True)
            parts.append(torch.stack([
                b_idx,
                bk.gids[r_idx],
                e0[b_idx, r_idx].to(torch.int64) + bk.base[r_idx],
                nh[b_idx, r_idx].to(torch.int64),
            ]))
        if not parts:
            return np.empty((4, 0), dtype=np.int64)
        out = torch.cat(parts, dim=1).cpu().numpy()
        count_d2h("device seed matching", out)
        return out

    def match_batch(self, query_kmers_batch: np.ndarray, min_prefix: int):
        """query_kmers_batch [B, m] u64 (0 = no captured k-mer) -> per-query
        (hit_masks, e0, n_hits) int64 triples, sorted by (mask, e0), one
        kernel launch per bucket.  A device failure (out of memory
        included) raises: the batch is never moved to the host."""
        return self._match(query_kmers_batch, min_prefix, single=False)

    def match(self, query_kmers: np.ndarray, min_prefix: int):
        """Single-query variant: (mask_idx, e0, n_hits) triples, one launch
        of the single-query kernel per bucket."""
        return self._match(query_kmers[None, :], min_prefix, single=True)[0]

    def _match(self, query_kmers_batch: np.ndarray, min_prefix: int, single: bool):
        B = query_kmers_batch.shape[0]
        sel = query_kmers_batch != 0
        qh = np.zeros(query_kmers_batch.shape, dtype=np.uint32)
        if sel.any():
            qh[sel] = split_kmers_hi_lo(query_kmers_batch[sel], self.k)[0]
        qb, hm_all, e0_all, nh_all = self._device_hits(qh, sel, min_prefix, single)

        # host bisection for the budget-spilled chunk rows, vectorized over
        # all (row, query) pairs
        if self.host_rows:
            from ..index.search import searchsorted_segments

            suf = np.uint64((1 << (2 * (self.k - min_prefix))) - 1)
            km = query_kmers_batch[:, self._ht_mi]  # [B, R]
            bsel, rsel = np.nonzero(km != 0)
            if bsel.shape[0]:
                q = km[bsel, rsel]
                lo0 = self._ht_off[rsel]
                hi0 = self._ht_off[rsel + 1]
                lo_i = searchsorted_segments(self._ht_cat, lo0, hi0, q & ~suf, "left")
                hi_i = searchsorted_segments(self._ht_cat, lo0, hi0, q | suf, "right")
                ok = hi_i > lo_i
                qb = np.concatenate([qb, bsel[ok]])
                hm_all = np.concatenate([hm_all, self._ht_mi[rsel[ok]]])
                e0_all = np.concatenate(
                    [e0_all, self._ht_start[rsel[ok]] + lo_i[ok] - lo0[ok]]
                )
                nh_all = np.concatenate([nh_all, (hi_i - lo_i)[ok]])

        # per query: sort by (mask, e0), then merge chunk-spanning range hits
        # (a prefix range crossing column-chunk boundaries comes back as
        # several triples of one mask with contiguous [e0, e0+n)) so that
        # downstream sees the host path's one-triple-per-mask shape
        order = np.lexsort((e0_all, hm_all, qb))
        qb, hm_all, e0_all, nh_all = qb[order], hm_all[order], e0_all[order], nh_all[order]
        bounds = np.searchsorted(qb, np.arange(B + 1))
        out = []
        for b in range(B):
            s, t = bounds[b], bounds[b + 1]
            hm, e0, nh = hm_all[s:t], e0_all[s:t], nh_all[s:t]
            if hm.shape[0] > 1:
                new_run = np.empty(hm.shape[0], dtype=bool)
                new_run[0] = True
                new_run[1:] = (hm[1:] != hm[:-1]) | (e0[1:] != e0[:-1] + nh[:-1])
                if not new_run.all():
                    starts = np.nonzero(new_run)[0]
                    hm, e0, nh = hm[starts], e0[starts], np.add.reduceat(nh, starts)
            out.append((hm.astype(np.int64), e0.astype(np.int64), nh.astype(np.int64)))
        return out
