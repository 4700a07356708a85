"""Batched and single-query >=p-prefix seed locate: the hand-written CUDA
kernels (`csrc/seed_locate.cu`) and their plain PyTorch twins.

`seed_locate_batch` is the counterpart of
lexicmap_tpu/parallel/pallas_kernels.py::seed_locate_batch_pallas and
launches `locate_batch_staged` (rows of E <= SMALL_MAX_E, staged whole in
shared memory) or `locate_batch_sampled` (larger rows: a sample of SAMPLE
pivots, then each bound's interval bisected), a warp per row serving every
query of the row.  `seed_locate` is the counterpart of ::seed_locate_pallas
(the same function for one query) and launches its own `locate_single` (a
thread per row: a bisection over every SINGLE_RUN-th entry whose first
pivot comes with the query, then the SINGLE_RUN entries after the last one
below each bound read whole).
Table and query hi words are int32 tensors that hold the uint32 bits
(PyTorch cannot compare uint32 tensors on the CPU); the kernels read them as
uint32, the plain version widens them to int64 with `& 0xFFFFFFFF`.

    suf = 2^(32-2p) - 1,  lb = qhi & ~suf,  rb = qhi | suf
    n_hits[b,m] = #{e < cnt[m] : lb <= hi[m,e] <= rb}
    e0[b,m]     = #{e < cnt[m] : hi[m,e] < lb}

both 0 where `query_valid` is false.  The kernels search the rows, so they
need each row sorted ascending over [0, cnt); the plain version is the dense
masked count and does not, so a row that is not sorted shows up as a
mismatch between the two.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .runtime import Library, cuda_ptrs

PAD_HI = np.uint32(0xFFFFFFFF)
U32 = 0xFFFFFFFF  # the uint32 bits of an int32 tensor's values, widened to int64

# the design's choices, compiled into csrc/seed_locate.cu (SMALL_MAX_E,
# SAMPLE, RUN there) and named here for the tests' replays of its searches
# (tests/torch_parity.py), which chip_smoke.py holds equal to the kernels
SMALL_MAX_E = 1024
SAMPLE = 32
SINGLE_RUN = 16


def split_kmers_hi_lo(kmers: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Split packed k-mers (2k bits) into hi/lo uint32 words.

    hi = the first 16 bases (bits [2k-32, 2k)); lo = the remaining bases,
    left-aligned in 32 bits.
    """
    kk = kmers.astype(np.uint64)
    hi = (kk >> np.uint64(2 * k - 32)).astype(np.uint32)
    lo_bits = 2 * k - 32
    lo = ((kk & np.uint64((1 << lo_bits) - 1)) << np.uint64(32 - lo_bits)).astype(
        np.uint32
    )
    return hi, lo


def suffix_mask(p: int) -> int:
    """The low 32-2p bits of a hi word (0 for p = 16)."""
    if not 1 <= p <= 16:
        raise ValueError(f"min prefix p must be in [1, 16] (hi word only), got {p}")
    return (1 << (32 - 2 * p)) - 1


def _check_table(seed_hi, seed_cnt):
    for name, t in (("seed_hi", seed_hi), ("seed_cnt", seed_cnt)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be torch.int32, got {t.dtype}")
    if seed_cnt.device != seed_hi.device:
        raise ValueError(f"seed_cnt is on {seed_cnt.device}, seed_hi on {seed_hi.device}")
    if seed_hi.dim() != 2:
        raise ValueError(f"seed_hi must be [Mb, E], got {tuple(seed_hi.shape)}")
    if tuple(seed_cnt.shape) != (seed_hi.shape[0],):
        raise ValueError(f"seed_cnt must be [{seed_hi.shape[0]}], got {tuple(seed_cnt.shape)}")


def _check_queries(seed_hi, query_hi, query_valid, shape):
    for name, t, dt in (("query_hi", query_hi, torch.int32),
                        ("query_valid", query_valid, torch.bool)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != seed_hi.device:
            raise ValueError(f"{name} is on {t.device}, seed_hi on {seed_hi.device}")
    if tuple(query_hi.shape) != shape:
        raise ValueError(f"query_hi must be {shape}, got {tuple(query_hi.shape)}")
    if query_valid.shape != query_hi.shape:
        raise ValueError(
            f"query_valid must be {tuple(query_hi.shape)}, got {tuple(query_valid.shape)}"
        )


def _check(seed_hi, seed_cnt, query_hi, query_valid):
    _check_table(seed_hi, seed_cnt)
    if query_hi.dim() != 2:
        raise ValueError(f"query_hi must be [B, {seed_hi.shape[0]}], got {tuple(query_hi.shape)}")
    _check_queries(seed_hi, query_hi, query_valid, (query_hi.shape[0], seed_hi.shape[0]))


def seed_locate_batch_plain(seed_hi, seed_cnt, query_hi, query_valid, p: int,
                            max_elems: int = 1 << 27):
    """The dense masked count of the definition, chunked over rows so that
    no [B, rows, E] intermediate exceeds `max_elems` elements.
    Returns (n_hits, e0), both int32 [B, Mb]."""
    suf = suffix_mask(p)
    Mb, E = seed_hi.shape
    B = query_hi.shape[0]
    dev = seed_hi.device
    nh = torch.zeros((B, Mb), dtype=torch.int32, device=dev)
    e0 = torch.zeros((B, Mb), dtype=torch.int32, device=dev)
    if B == 0 or Mb == 0 or E == 0:
        return nh, e0
    rows = max(1, max_elems // (B * E))
    lane = torch.arange(E, device=dev)
    for r0 in range(0, Mb, rows):
        r1 = min(r0 + rows, Mb)
        hi = (seed_hi[r0:r1].to(torch.int64) & U32)[None]  # [1, R, E]
        real = (lane[None, :] < seed_cnt[r0:r1, None])[None]  # [1, R, E]
        q = query_hi[:, r0:r1].to(torch.int64) & U32  # [B, R]
        lb = (q & (U32 ^ suf))[..., None]
        rb = (q | suf)[..., None]
        ok = query_valid[:, r0:r1]
        below = (hi < lb) & real
        e0[:, r0:r1] = torch.where(ok, below.sum(-1, dtype=torch.int32), 0)
        inr = (hi >= lb) & (hi <= rb) & real
        nh[:, r0:r1] = torch.where(ok, inr.sum(-1, dtype=torch.int32), 0)
    return nh, e0


LIB = Library("seed_locate", {
    "seed_locate_batch": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                          + [ctypes.c_uint, ctypes.c_void_p], ctypes.c_int),
    "seed_locate": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_uint, ctypes.c_void_p],
                    ctypes.c_int),
})


def _check_out(out, shape, device):
    if out is not None and (out.dtype != torch.int32 or tuple(out.shape) != shape
                            or out.device != device or not out[0].is_contiguous()
                            or not out[1].is_contiguous()):
        raise ValueError(f"out must be an int32 {shape} tensor on {device} "
                         f"whose two halves are contiguous")


def _copy_out(out, got):
    out[0].copy_(got[0])
    out[1].copy_(got[1])
    return out[0], out[1]


def seed_locate_batch(seed_hi, seed_cnt, query_hi, query_valid, p: int, out=None):
    """Per (query, row) >=p-prefix entry range of a sorted hi-word table.

    seed_hi int32 [Mb, E] (uint32 bits, rows sorted over [0, cnt), PAD_HI
    after), seed_cnt int32 [Mb], query_hi int32 [B, Mb], query_valid bool
    [B, Mb]; 1 <= p <= 16; out: an optional int32 [2, B, Mb] to write into
    (out[0] and out[1] each contiguous, as a slice of a stacked buffer is).
    Returns (n_hits, e0), both int32 [B, Mb].

    CUDA tensors launch the kernel (`launches` counts the launches); CPU
    tensors run the plain version."""
    _check(seed_hi, seed_cnt, query_hi, query_valid)
    suf = suffix_mask(p)
    (Mb, E), B = seed_hi.shape, query_hi.shape[0]
    _check_out(out, (2, B, Mb), seed_hi.device)
    if seed_hi.device.type == "cpu":
        got = seed_locate_batch_plain(seed_hi, seed_cnt, query_hi, query_valid, p)
        return got if out is None else _copy_out(out, got)
    ptrs = cuda_ptrs(seed_hi=seed_hi, seed_cnt=seed_cnt, query_hi=query_hi,
                     query_valid=query_valid)
    if out is None:
        out = torch.empty((2, B, Mb), dtype=torch.int32, device=seed_hi.device)
    if B * Mb == 0:
        return out[0], out[1]
    LIB.launch("seed_locate_batch", seed_hi.device, *ptrs, out[0].data_ptr(),
               out[1].data_ptr(), B, Mb, E, suf)
    seed_locate_batch.launches += 1
    return out[0], out[1]


seed_locate_batch.launches = 0


def seed_locate_plain(seed_hi, seed_cnt, query_hi, query_valid, p: int):
    """The single-query plain version: the batched one on a batch of one."""
    nh, e0 = seed_locate_batch_plain(seed_hi, seed_cnt, query_hi[None], query_valid[None], p)
    return nh[0], e0[0]


def seed_locate(seed_hi, seed_cnt, query_hi, query_valid, p: int, out=None):
    """Per-row >=p-prefix entry range of a sorted hi-word table for ONE
    query: query_hi int32 [Mb], query_valid bool [Mb]; out: an optional
    int32 [2, Mb] whose two halves are contiguous; otherwise as
    `seed_locate_batch`.  Returns (n_hits, e0), both int32 [Mb].

    CUDA tensors launch the single-query kernel (`launches` counts them);
    CPU tensors run the plain version."""
    _check_table(seed_hi, seed_cnt)
    _check_queries(seed_hi, query_hi, query_valid, (seed_hi.shape[0],))
    suf = suffix_mask(p)
    Mb, E = seed_hi.shape
    _check_out(out, (2, Mb), seed_hi.device)
    if seed_hi.device.type == "cpu":
        got = seed_locate_plain(seed_hi, seed_cnt, query_hi, query_valid, p)
        return got if out is None else _copy_out(out, got)
    ptrs = cuda_ptrs(seed_hi=seed_hi, seed_cnt=seed_cnt, query_hi=query_hi,
                     query_valid=query_valid)
    if out is None:
        out = torch.empty((2, Mb), dtype=torch.int32, device=seed_hi.device)
    if Mb == 0:
        return out[0], out[1]
    LIB.launch("seed_locate", seed_hi.device, *ptrs, out[0].data_ptr(), out[1].data_ptr(),
               Mb, E, suf)
    seed_locate.launches += 1
    return out[0], out[1]


seed_locate.launches = 0
