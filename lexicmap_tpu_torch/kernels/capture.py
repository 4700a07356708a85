"""LexicHash capture of one genome: the hand-written CUDA kernels of
`csrc/capture.cu` and their plain PyTorch twin.

  capture  (replaces lexicmap_tpu/parallel/build_device.py::build_capture_fn):
           for every position i < L - k + 1 not excluded and both strands
           (loc = i << 1 | strand; the rc k-mer is the reverse complement
           of the same k bases), the k-mer is a candidate of the mask whose
           first p bases (the mask set's distinct prefix) it shares; each
           mask keeps the least kmer ^ mask, compared unsigned, and every
           location of that k-mer.  Exactly native capture_native with
           check_shorter = 0.

Inputs: codes uint8 [L] (0..3), exclude bool or uint8 [L - k + 1] or None,
table int32 (`bucket_table`: a dense [4^p] map from a k-mer's first p bases
to its mask's index, -1 for none, or the masks' sorted bucket ids [m] for a
bisection when 4^p is large), masks int64 [m] (the uint64 bits, ascending),
k <= 32, 2p < 32.  Outputs: kmers int64 [m] (uint64 bits; 0 = no capture),
counts int64 [m], pos int32 [sum(counts)] (uint32 locations, grouped by
mask, ascending within each).  On the card the three are views of one
buffer (`runtime.fetch_numpy` brings them back in one copy).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .runtime import Library, require

#: largest p whose bucket table is dense (4^11 int32 = 16 MB)
DENSE_MAX_P = 11
_INT64_MIN = -(1 << 63)
_LOC_BITS = 33  # a location below 2^33 (L < 2^32); the plain version's sort key

_count_lock = threading.Lock()


def bucket_table(masks: np.ndarray, k: int, p: int) -> np.ndarray:
    """The kernels' bucket -> mask table of an ascending uint64 mask array
    whose p-base prefixes are distinct: dense int32 [4^p] (mask index, -1
    for none) for p <= DENSE_MAX_P, else the masks' bucket ids int32 [m]
    (ascending, as the masks are)."""
    masks = np.asarray(masks, dtype=np.uint64)
    ids = (masks >> np.uint64(2 * (k - p))).astype(np.int64)
    if ids.shape[0] > 1 and not (np.diff(ids) > 0).all():
        raise ValueError("the masks' p-base prefixes must be distinct and ascending")
    if p > DENSE_MAX_P:
        return ids.astype(np.int32)
    table = np.full(1 << (2 * p), -1, dtype=np.int32)
    table[ids] = np.arange(ids.shape[0], dtype=np.int32)
    return table


def _dense(table, p: int) -> bool:
    return table.shape[0] == 1 << (2 * p)


def _check_args(codes, exclude, table, masks, k, p):
    dev = codes.device
    require("codes", codes, torch.uint8, dev)
    if codes.dim() != 1:
        raise ValueError("codes must be 1-D")
    if not 1 <= k <= 32 or not 1 <= p <= k or 2 * p >= 32:
        raise ValueError(f"unsupported k = {k}, p = {p} (k <= 32, p <= k, 2p < 32)")
    L = codes.shape[0]
    if L < k:
        raise ValueError(f"a genome of {L} bases has no {k}-mer")
    if L >= 1 << 31:
        raise ValueError("a genome of 2^31 bases or more does not fit uint32 locations")
    if exclude is not None:
        if exclude.dtype not in (torch.bool, torch.uint8):
            raise TypeError(f"exclude must be bool or uint8, got {exclude.dtype}")
        require("exclude", exclude, exclude.dtype, dev, (L - k + 1,))
    require("masks", masks, torch.int64, dev)
    require("table", table, torch.int32, dev)
    m = masks.shape[0]
    if masks.dim() != 1 or m == 0:
        raise ValueError("masks must be a non-empty 1-D tensor")
    if not (_dense(table, p) or tuple(table.shape) == (m,)):
        raise ValueError(f"table must be [4^p] or [m], got {tuple(table.shape)}")


# ---------------------------------------------------------------------------
# plain version


def _kmers(codes, k):
    """Forward and rc k-mers (int64 holding the uint64 bits) at every
    position, interleaved: index 2i + strand, which is the location."""
    nk = codes.shape[0] - k + 1
    c = codes.to(torch.int64)
    f = torch.zeros(nk, dtype=torch.int64, device=codes.device)
    r = torch.zeros_like(f)
    for j in range(k):
        f = (f << 2) | c[j: j + nk]
    for j in reversed(range(k)):
        r = (r << 2) | (3 - c[j: j + nk])
    return torch.stack([f, r], dim=1).reshape(-1)


def capture_plain(codes, exclude, table, masks, k: int, p: int):
    """The capture in tensor code: k-mers by shifts, the mask through the
    same table (or `searchsorted`), the per-mask minimum by
    `scatter_reduce("amin")` on kmer ^ mask with its top bit flipped (so
    that int64 order is uint64 order), and one sort of (mask << 33 | loc)
    keys.  Same arguments and outputs as `capture`."""
    _check_args(codes, exclude, table, masks, k, p)
    dev = codes.device
    m = masks.shape[0]
    km = _kmers(codes, k)
    loc = torch.arange(km.shape[0], dtype=torch.int64, device=dev)
    bucket = (km >> (2 * (k - p))) & ((1 << (2 * p)) - 1)
    tab = table.to(torch.int64)
    if _dense(table, p):
        j = tab[bucket]
    else:
        at = torch.searchsorted(tab, bucket).clamp(max=m - 1)
        j = torch.where(tab[at] == bucket, at, -1)
    keep = j >= 0
    if exclude is not None:
        keep &= ~exclude.to(torch.bool).repeat_interleave(2)
    j, km, loc = j[keep], km[keep], loc[keep]
    flip = torch.tensor(_INT64_MIN, dtype=torch.int64, device=dev)
    xs = (km ^ masks[j]) ^ flip
    best = torch.full((m,), (1 << 63) - 1, dtype=torch.int64, device=dev)
    best.scatter_reduce_(0, j, xs, "amin")
    win = xs == best[j]
    jw, lw = j[win], loc[win]
    key, _ = torch.sort((jw << _LOC_BITS) | lw)
    pos = (key & ((1 << _LOC_BITS) - 1)).to(torch.int32)
    counts = torch.bincount(jw, minlength=m)
    kmers = torch.where(counts > 0, (best ^ flip) ^ masks, 0)
    return kmers, counts, pos


# ---------------------------------------------------------------------------
# wrapper


_HEAD = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
LIB = Library("capture", {
    "capture_count_winners": (_HEAD + [ctypes.c_void_p] * 3, ctypes.c_int),
    "capture_write_winners": (_HEAD + [ctypes.c_void_p] * 9, ctypes.c_int),
    "capture_sort_cap": ([], ctypes.c_int),
    "capture_best_bytes": ([ctypes.c_int, ctypes.c_int], ctypes.c_int64),
})


def capture(codes, exclude, table, masks, k: int, p: int):
    """The LexicHash capture of one genome (see the module docstring).
    Returns (kmers int64 [m], counts int64 [m], pos int32 [total]).  CUDA
    tensors launch the kernels (`launches` counts the calls; the wrapper
    waits once, for the total that sizes the output); CPU tensors run the
    plain version."""
    dev = codes.device
    if dev.type == "cpu":
        return capture_plain(codes, exclude, table, masks, k, p)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_args(codes, exclude, table, masks, k, p)
    lib = LIB.lib()
    L, m = codes.shape[0], masks.shape[0]
    dense = int(_dense(table, p))
    ex = 0 if exclude is None else exclude.data_ptr()
    head = (codes.data_ptr(), L, ex, k, p, table.data_ptr(), dense, m, masks.data_ptr())
    nb = lib.capture_best_bytes(m, p)  # the (mask, best) pairs, then the uint16 table and keys
    work = torch.empty(20 * m + nb, dtype=torch.uint8, device=dev)
    cnt = work[: 8 * m].view(torch.int64)
    off = work[8 * m: 16 * m].view(torch.int64)
    best = work[16 * m: 16 * m + nb]
    cursor = work[16 * m + nb:]
    LIB.launch("capture_count_winners", dev, *head, best.data_ptr(), cnt.data_ptr())
    torch.cumsum(cnt, 0, out=off)
    total, most = (int(v) for v in torch.stack([off[-1], cnt.max()]).cpu())  # the one wait
    off.sub_(cnt)
    out = torch.empty(16 * m + 4 * total, dtype=torch.uint8, device=dev)
    kmers = out[: 8 * m].view(torch.int64)
    counts = out[8 * m: 16 * m].view(torch.int64)
    pos = out[16 * m:].view(torch.int32)
    scratch = torch.empty(total, dtype=torch.int32, device=dev) if most > lib.capture_sort_cap() \
        else None
    LIB.launch("capture_write_winners", dev, *head, best.data_ptr(), cnt.data_ptr(),
               off.data_ptr(), cursor.data_ptr(), pos.data_ptr(), kmers.data_ptr(),
               counts.data_ptr(), 0 if scratch is None else scratch.data_ptr())
    with _count_lock:
        capture.launches += 1
    return kmers, counts, pos


capture.launches = 0
