"""The seed matcher's compaction (B4): the hand-written CUDA kernel
(`csrc/seed_compact.cu`) and its plain PyTorch twin.

Counterpart of the tail of
lexicmap_tpu/parallel/device_search.py::DeviceSeedMatcher._bucket_fn (after
B1, each query's hit rows sorted by mask id) and of the host sort and chunk
merge that DeviceSeedMatcher's batch needs after it, over every bucket of a
batch at once.  Input: B1's outputs of all buckets in one stacked int32
buffer (bucket k's [2, B, Mb_k], n_hits then e0, at element 2 * B *
starts[k]) and the matcher's static `RowOrder`.  Output: for each query, the
(mask, e0, n_hits) triples of its hit rows in (mask, e0) order, e0 made
mask-global with the row's chunk base, and the hits of one mask's
consecutive chunk rows whose ranges touch (e0 of a row = e0 + n_hits of the
row before) merged into one triple with the summed count: int64 [3, T] and
per-query offsets int64 [B + 1].  Every hit is kept (JAX keeps the first
H_CAP).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .runtime import Library, cuda_ptrs, fetch_numpy

#: ordered rows a warp of the kernel covers for one query (SPAN in the source)
SPAN = 128
#: ordered rows a block covers for one query, a tile of the kernel's scan
#: (TILE in the source, which refuses another)
TILE = 8 * SPAN


@dataclass
class RowOrder:
    """A matcher's device rows in (mask, chunk base) order, built once.

    starts int32 [nb + 1]: bucket k holds the global rows starts[k] to
    starts[k+1] - 1; perm int32 [R]: the global row of ordered row i; src
    int32 [R, 2]: the (starts[k], starts[k+1] - starts[k]) of the bucket k
    that holds ordered row i, so that the kernel finds a row's B1 outputs
    with one multiply-add; cont uint8 [R]: 1 where row i is the chunk of row
    i-1's mask that follows it; gid, base int64 [R]: ordered row i's mask id
    and chunk base."""

    starts: torch.Tensor
    perm: torch.Tensor
    src: torch.Tensor
    cont: torch.Tensor
    gid: torch.Tensor
    base: torch.Tensor


def row_order(gids, bases, cnts, device) -> RowOrder:
    """The RowOrder of buckets whose rows have mask ids `gids[k]`, chunk
    bases `bases[k]` and entry counts `cnts[k]` (numpy, one array a
    bucket), on `device`."""
    starts = np.zeros(len(gids) + 1, dtype=np.int64)
    np.cumsum([g.shape[0] for g in gids], out=starts[1:])
    if starts[-1] >= 1 << 31:
        raise ValueError(f"{starts[-1]} rows do not fit int32 row ids")
    g = np.concatenate(gids).astype(np.int64) if gids else np.zeros(0, np.int64)
    b = np.concatenate(bases).astype(np.int64) if gids else np.zeros(0, np.int64)
    c = np.concatenate(cnts).astype(np.int64) if gids else np.zeros(0, np.int64)
    perm = np.lexsort((b, g))
    g, b, c = g[perm], b[perm], c[perm]
    k = np.repeat(np.arange(len(gids)), np.diff(starts))[perm]  # each ordered row's bucket
    src = np.stack([starts[k], starts[k + 1] - starts[k]], axis=1)
    cont = np.zeros(perm.shape[0], dtype=np.uint8)
    cont[1:] = (g[1:] == g[:-1]) & (b[1:] == b[:-1] + c[:-1])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return RowOrder(starts=t(starts.astype(np.int32)), perm=t(perm.astype(np.int32)),
                    src=t(src.astype(np.int32)), cont=t(cont), gid=t(g), base=t(b))


def _check(stacked, B, order):
    if not isinstance(stacked, torch.Tensor) or stacked.dtype != torch.int32:
        raise TypeError("stacked must be an int32 torch.Tensor")
    R = order.perm.shape[0]
    for name, t, dt, shape in (
            ("starts", order.starts, torch.int32, (order.starts.shape[0],)),
            ("perm", order.perm, torch.int32, (R,)), ("src", order.src, torch.int32, (R, 2)),
            ("cont", order.cont, torch.uint8, (R,)), ("gid", order.gid, torch.int64, (R,)),
            ("base", order.base, torch.int64, (R,))):
        if t.dtype != dt:
            raise TypeError(f"order.{name} must be {dt}, got {t.dtype}")
        if t.device != stacked.device:
            raise ValueError(f"order.{name} is on {t.device}, stacked on {stacked.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"order.{name} has shape {tuple(t.shape)}")
    if B < 0 or tuple(stacked.shape) != (2 * B * R,):
        raise ValueError(f"stacked must be [{2 * B * R}] (2 x B x R), got {tuple(stacked.shape)}")


def _triples(stacked, B, order):
    """The ordered (n_hits, e0) [B, R] of the stacked buffer."""
    starts = order.starts.tolist()
    R = starts[-1]
    nh = torch.empty((B, R), dtype=torch.int32, device=stacked.device)
    e0 = torch.empty_like(nh)
    for s0, s1 in zip(starts[:-1], starts[1:]):
        blk = stacked[2 * B * s0: 2 * B * s1].view(2, B, s1 - s0)
        nh[:, s0:s1] = blk[0]
        e0[:, s0:s1] = blk[1]
    perm = order.perm.long()
    return nh[:, perm], e0[:, perm]


def seed_compact_plain(stacked, B: int, order: RowOrder):
    """The definition, on whole tensors: the ordered rows' starts (a hit
    whose row does not merge into the row before), each run's n_hits summed
    by its start.  Returns (offsets int64 [B + 1] on the CPU, triples int64
    [3, T] on stacked's device)."""
    _check(stacked, B, order)
    dev = stacked.device
    nh, e0 = _triples(stacked, B, order)
    v = nh.to(torch.int64)
    e = e0.to(torch.int64) + order.base[None, :]
    hit = v > 0
    prev_hit = torch.zeros_like(hit)
    prev_end = torch.zeros_like(e)
    prev_hit[:, 1:] = hit[:, :-1]
    prev_end[:, 1:] = (e + v)[:, :-1]
    merged = order.cont.bool()[None, :] & hit & prev_hit & (prev_end == e)
    start = hit & ~merged
    run = torch.cumsum(start.reshape(-1).to(torch.int64), 0) - 1  # each hit's run
    flat_hit = hit.reshape(-1)
    T = int(start.sum())
    n = torch.zeros(T, dtype=torch.int64, device=dev).index_add_(
        0, run[flat_hit], v.reshape(-1)[flat_hit])
    triples = torch.stack([order.gid[None, :].expand(B, -1)[start], e[start], n])
    offsets = torch.zeros(B + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(start.sum(1), 0)
    return _fetch_offsets(offsets), triples


def _fetch_offsets(offsets):
    """The per-query offsets on the host: the matcher's wait on the card."""
    return torch.from_numpy(fetch_numpy("device seed matching", offsets)[0])


LIB = Library("seed_compact", {
    "seed_compact": ([ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                     + [ctypes.c_void_p] * 3, ctypes.c_int),
})


def seed_compact(stacked, B: int, order: RowOrder):
    """Each query's hit triples in (mask, e0) order, chunk runs merged.

    stacked int32 [2 * B * R]: bucket k's seed_locate_batch outputs [2, B,
    Mb_k] at element 2 * B * order.starts[k]; order: the matcher's
    RowOrder on the same device.  Returns (offsets int64 [B + 1], on the
    host, triples int64 [3, T] of (mask, e0, n_hits), on stacked's device):
    query b's triples are columns offsets[b] to offsets[b+1] - 1.

    CUDA tensors launch the kernel (`launches` counts the calls that do):
    one launch into an output sized B * R triples (each (query, row) starts
    at most one), whose triples are the view [3, T] of T contiguous
    (mask, e0, n_hits) records, so `triples.t()` fetches in one copy; the
    host's one wait is the fetch of the offsets.  CPU tensors run the plain
    version."""
    _check(stacked, B, order)
    if stacked.device.type == "cpu":
        return seed_compact_plain(stacked, B, order)
    ptrs = cuda_ptrs(stacked=stacked, perm=order.perm, src=order.src, cont=order.cont,
                     gid=order.gid, base=order.base)
    R = order.perm.shape[0]
    dev = stacked.device
    if B * R == 0:
        return (torch.zeros(B + 1, dtype=torch.int64),
                torch.zeros((3, 0), dtype=torch.int64, device=dev))
    if B * R >= 1 << 32:
        raise ValueError(f"B x R = {B * R} (query, row) pairs: the kernel counts in 32 bits")
    tiles = B * -(-R // TILE)
    scratch = torch.empty(tiles + 1 + B + 1, dtype=torch.int64, device=dev)
    out = torch.empty((B * R, 3), dtype=torch.int64, device=dev)
    LIB.launch("seed_compact", dev, *ptrs, R, B, TILE, scratch.data_ptr(), out.data_ptr())
    seed_compact.launches += 1
    offsets = _fetch_offsets(scratch[tiles + 1:])
    return offsets, out[: int(offsets[B])].t()


seed_compact.launches = 0
