"""Phase 2b's reversed-k-mer dispatch for a batch of queries: the
hand-written CUDA kernel (`csrc/reverse_dispatch.cu`) and its plain PyTorch
twin.

It replaces no TPU kernel: the JAX package runs this step on the host, a
query at a time (lexicmap_tpu/index/search.py::_reversed_query_kmers), and
so does the port's host path (index/search.py, which stays the reference).
Input: a batch's captured k-mers [B, m] (0 = none), mask j's capture in
column j.  Output, for each query: its distinct reversed k-mers (base order
reversed, 2k bits), each dispatched to its nearest mask (the sorted mask that
minimises mask XOR k-mer, the lowest index among equal masks), sorted by
(nearest mask, reversed k-mer), each with the lowest mask that captured it:
the host's (new_mask, rev_kmer, orig_mask), bit for bit.  A query whose
largest bucket (distinct reversed k-mers of one nearest mask) holds more
than RUN_CAP is declined: the caller dispatches it on the host.  A mask
set over MAX_M masks is refused: the caller keeps such an index on the host
path.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.kmers import bitlen64
from .runtime import Library, fetch_numpy

#: the most distinct reversed k-mers one nearest mask may take in a query the
#: card serves (the kernel ranks a bucket's records by a walk over it); read
#: at call time
RUN_CAP = 1024
#: the kernel's hash slots a query (TABLE in the source)
TABLE = 1 << 15
#: the most masks the kernel takes, so that a query's table is at most 3/4
#: full (MAX_M in the source); read at call time
MAX_M = TABLE // 4 * 3
#: a tree child that is a run of equal masks (LEAF in the source)
LEAF = 1 << 28
#: the card_wait label of the dispatch's two fetches
LABEL = "reversed dispatch"

_SIGN = -(1 << 63)  # int64 bits of 1 << 63: flips unsigned order into signed order


@dataclass
class MaskTree:
    """The sorted masks on a device, with their crit-bit tree for the kernel.

    masks int64 [m]: the sorted masks' uint64 bits; tree int64 [max(u, 1)]
    for u distinct masks, node s (1 <= s < u) the split between the s-th
    and the (s+1)-th distinct mask: its critical bit (the highest bit in
    which they differ) in bits 58-63, its right and left children in bits
    29-57 and 0-28, a child either a node or LEAF | the first index of a
    run of equal masks; root the same, a node or a leaf."""

    masks: torch.Tensor
    tree: torch.Tensor
    root: int
    k: int


def mask_tree(masks: np.ndarray, k: int, device) -> MaskTree:
    """The MaskTree of the sorted `masks` of k-mers of `k` bases, on
    `device`.  The tree is the Cartesian tree (a max-heap) of the critical
    bits of neighbouring distinct masks: a node's range of masks splits at
    its critical bit, the only one in its range where they split, so the
    walk that follows a k-mer's bit there is the bit-by-bit XOR descent."""
    masks = np.ascontiguousarray(masks, dtype=np.uint64)
    if masks.shape[0] == 0:
        raise ValueError("no masks")
    if masks.shape[0] >= LEAF or np.any(masks[1:] < masks[:-1]):
        raise ValueError("masks must be sorted and fewer than 2^28")
    first = np.flatnonzero(np.r_[True, masks[1:] != masks[:-1]])  # each distinct value's
    u = first.shape[0]
    crit = np.zeros(u, dtype=np.int64)
    crit[1:] = bitlen64(masks[first[1:]] ^ masks[first[:-1]]) - 1
    left = np.full(u, -1, dtype=np.int64)
    right = np.full(u, -1, dtype=np.int64)
    stack: list[int] = []
    for s in range(1, u):
        last = -1
        while stack and crit[stack[-1]] < crit[s]:
            last = stack.pop()
        left[s] = last
        if stack:
            right[stack[-1]] = s
        stack.append(s)
    nodes = np.arange(u)
    lchild = np.where(left >= 0, left, LEAF | first[np.maximum(nodes - 1, 0)])
    rchild = np.where(right >= 0, right, LEAF | first)
    u64 = lambda a: a.astype(np.uint64)
    tree = (u64(crit) << np.uint64(58)) | (u64(rchild) << np.uint64(29)) | u64(lchild)
    tree[0] = 0
    root = stack[0] if stack else LEAF
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int64)).to(device)
    return MaskTree(masks=t(masks), tree=t(tree), root=int(root), k=int(k))


@dataclass
class Reversed:
    """A batch's dispatch on the host: query b's records are [offsets[b],
    offsets[b + 1]) of the columns new_mask int64, rev_kmer uint64 and
    orig_mask int64; declined bool [B] (a declined query has none)."""

    offsets: np.ndarray
    declined: np.ndarray
    new_mask: np.ndarray
    rev_kmer: np.ndarray
    orig_mask: np.ndarray

    def query(self, b: int):
        """Query b's (new_mask, rev_kmer, orig_mask), or None where the card
        declined it."""
        if self.declined[b]:
            return None
        s, t = self.offsets[b], self.offsets[b + 1]
        return self.new_mask[s:t], self.rev_kmer[s:t], self.orig_mask[s:t]


def _bit(b: int) -> int:
    return _SIGN if b == 63 else 1 << b


def reverse_kmers_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """utils/kmers.py::reverse_kmers on int64 tensors of the uint64 bits."""
    m2, m4 = 0x3333333333333333, 0x0F0F0F0F0F0F0F0F
    x = ((x >> 2) & m2) | ((x & m2) << 2)
    x = ((x >> 4) & m4) | ((x & m4) << 4)
    x = x.contiguous().view(torch.uint8).view(-1, 8).flip(1).reshape(-1).view(torch.int64)
    return x if k == 32 else (x >> (64 - 2 * k)) & ((1 << (2 * k)) - 1)


def nearest_mask_plain(masks: torch.Tensor, r: torch.Tensor, k: int) -> torch.Tensor:
    """masks.py::xor_argmin_sorted on int64 tensors of the uint64 bits: the
    bit-by-bit descent over the sorted masks, no tree."""
    key = masks ^ _SIGN  # sorted as signed integers
    lo = torch.zeros_like(r)
    hi = torch.full_like(r, masks.shape[0])
    prefix = torch.zeros_like(r)
    for bit in range(2 * k - 1, -1, -1):
        b = _bit(bit)
        split = torch.searchsorted(key, (prefix | b) ^ _SIGN)
        split = torch.minimum(torch.maximum(split, lo), hi)
        go1 = torch.where((r & b) != 0, hi > split, split <= lo)
        lo = torch.where(go1, split, lo)
        hi = torch.where(go1, hi, split)
        prefix = torch.where(go1, prefix | b, prefix)
    return lo


def reverse_dispatch_plain(kmers: torch.Tensor, mt: MaskTree) -> Reversed:
    """The definition, a query at a time on whole tensors (on any device):
    the non-zero captures reversed, sorted (stable) by reversed k-mer so that
    a run's first has the lowest mask, the runs' firsts dispatched by the
    bit-by-bit descent, then sorted (stable) by nearest mask."""
    _check(kmers, mt)
    B = kmers.shape[0]
    cols, offsets, declined = [], [0], []
    for b in range(B):
        row = kmers[b]
        j = torch.nonzero(row != 0).flatten()
        rk, o = torch.sort(reverse_kmers_plain(row[j], mt.k) ^ _SIGN, stable=True)
        first = torch.ones_like(rk, dtype=torch.bool)
        first[1:] = rk[1:] != rk[:-1]
        r, j = (rk ^ _SIGN)[first], j[o][first]
        nm, o = torch.sort(nearest_mask_plain(mt.masks, r, mt.k), stable=True)
        largest = int(torch.unique_consecutive(nm, return_counts=True)[1].max()) if len(nm) else 0
        over = largest > RUN_CAP
        declined.append(over)
        if not over:
            cols.append(torch.stack([nm, r[o], j[o]]))
        offsets.append(offsets[-1] + (0 if over else nm.shape[0]))
    cat = (torch.cat(cols, 1) if cols else kmers.new_zeros((3, 0))).cpu().numpy()
    return Reversed(np.array(offsets, dtype=np.int64), np.array(declined, dtype=bool),
                    cat[0].copy(), cat[1].view(np.uint64).copy(), cat[2].copy())


def _check(kmers, mt: MaskTree):
    if not isinstance(kmers, torch.Tensor) or kmers.dtype != torch.int64 or kmers.dim() != 2:
        raise TypeError("kmers must be an int64 [B, m] torch.Tensor")
    if kmers.shape[1] != mt.masks.shape[0]:
        raise ValueError(f"kmers has {kmers.shape[1]} columns for {mt.masks.shape[0]} masks")
    if kmers.shape[1] > MAX_M:
        raise ValueError(f"{kmers.shape[1]} masks: the dispatch takes at most {MAX_M}")
    if kmers.device != mt.tree.device:
        raise ValueError(f"kmers is on {kmers.device}, the mask tree on {mt.tree.device}")


LIB = Library("reverse_dispatch", {
    "reverse_dispatch": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5,
                         ctypes.c_int),
})


def _records(offsets, declined, rec) -> Reversed:
    """Reversed from the kernel's records int64 [T, 2]: the reversed k-mer,
    then the nearest mask and the lowest mask as two int32."""
    pair = np.ascontiguousarray(rec[:, 1]).view(np.int32).reshape(-1, 2)
    return Reversed(offsets, declined, pair[:, 0].astype(np.int64),
                    np.ascontiguousarray(rec[:, 0]).view(np.uint64), pair[:, 1].astype(np.int64))


def reverse_dispatch(kmers: torch.Tensor, mt: MaskTree):
    """The batch's dispatch: a function that returns its Reversed.

    kmers int64 [B, m]: the captured k-mers' uint64 bits (0 = none), on
    mt's device.  CUDA tensors launch the kernel (`launches` counts the
    calls that do) and return at once: the host waits in the function, for
    the offsets and then for the records, one copy each.  CPU tensors run
    the plain version."""
    _check(kmers, mt)
    B, m = kmers.shape
    if kmers.device.type == "cpu" or B == 0:
        res = reverse_dispatch_plain(kmers, mt)
        return lambda: res
    kmers = kmers.contiguous()
    dev = kmers.device
    scratch = torch.empty(2 * B * m, dtype=torch.int32, device=dev)
    staged = torch.empty((B * m, 2), dtype=torch.int64, device=dev)
    out = torch.empty((B * m, 2), dtype=torch.int64, device=dev)
    state = torch.empty(3 * B + 2, dtype=torch.int64, device=dev)
    LIB.launch("reverse_dispatch", dev, kmers.data_ptr(), mt.tree.data_ptr(), mt.root, m, B,
               mt.k, RUN_CAP, scratch.data_ptr(), staged.data_ptr(), state.data_ptr(),
               out.data_ptr())
    reverse_dispatch.launches += 1

    def fetch():
        head = fetch_numpy(LABEL, state[B + 1:])[0]
        T = int(head[B])
        rec = fetch_numpy(LABEL, out[:T])[0]
        return _records(head[: B + 1], head[B + 1:].astype(bool), rec)

    return fetch


reverse_dispatch.launches = 0
