"""Single-query >=p-prefix seed match with the best in-range LCP: the
hand-written CUDA kernel (`csrc/seed_match.cu`) and its plain PyTorch twin.

Counterpart of lexicmap_tpu/parallel/pallas_kernels.py::seed_match_pallas.
As in kernels/seed_locate.py, hi and lo words are int32 tensors holding the
uint32 bits.  With suf = 2^(32-2p) - 1, lb = qhi & ~suf, rb = qhi | suf:

    n_hits[m]   = #{e < cnt[m] : lb <= hi[m,e] <= rb}
    e0[m]       = #{e < cnt[m] : hi[m,e] < lb}
    best_lcp[m] = max over the in-range e of min(clz64((hi,lo) ^ (qhi,qlo)) / 2, k)

all 0 where `query_valid` is false, best_lcp 0 where nothing is in range.
The kernel (`match_single`: seed_locate's single-query search over the hi
words, then the lo words only where the slice of in-range entries is not
empty) searches, so it needs each row sorted ascending by the full (hi, lo)
word over [0, cnt); the plain version is the dense definition, so an
unsorted row shows up as a mismatch between the two.  No search path
calls it: the JAX package calls seed_match_pallas from tests only.
"""

from __future__ import annotations

import ctypes

import torch

from .runtime import Library, cuda_ptrs
from .seed_locate import U32, suffix_mask

# entries a head stands for in the kernel's search (RUN in
# csrc/seed_match.cu, which seed_match() holds this to), named here for the
# tests' replay of it (tests/torch_parity.py)
MATCH_RUN = 8


def _check(seed_hi, seed_lo, seed_cnt, query_hi, query_lo, query_valid):
    for name, t, dt in (("seed_hi", seed_hi, torch.int32), ("seed_lo", seed_lo, torch.int32),
                        ("seed_cnt", seed_cnt, torch.int32), ("query_hi", query_hi, torch.int32),
                        ("query_lo", query_lo, torch.int32),
                        ("query_valid", query_valid, torch.bool)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != seed_hi.device:
            raise ValueError(f"{name} is on {t.device}, seed_hi on {seed_hi.device}")
    if seed_hi.dim() != 2 or seed_lo.shape != seed_hi.shape:
        raise ValueError(f"seed_hi and seed_lo must both be [Mb, E], got "
                         f"{tuple(seed_hi.shape)} and {tuple(seed_lo.shape)}")
    Mb = seed_hi.shape[0]
    for name, t in (("seed_cnt", seed_cnt), ("query_hi", query_hi), ("query_lo", query_lo),
                    ("query_valid", query_valid)):
        if tuple(t.shape) != (Mb,):
            raise ValueError(f"{name} must be [{Mb}], got {tuple(t.shape)}")


def bit_length(x):
    """Bit length of each non-negative int64 value (0 for 0)."""
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        big = (x >> s) != 0
        n = n + torch.where(big, s, 0)
        x = torch.where(big, x >> s, x)
    return n + (x != 0).to(x.dtype)


def seed_match_plain(seed_hi, seed_lo, seed_cnt, query_hi, query_lo, query_valid, p: int,
                     k: int = 31, max_elems: int = 1 << 26):
    """The dense definition over int64-widened row chunks of at most
    `max_elems` elements.  Returns (n_hits, e0, best_lcp), int32 [Mb]."""
    suf = suffix_mask(p)
    Mb, E = seed_hi.shape
    dev = seed_hi.device
    nh = torch.zeros(Mb, dtype=torch.int32, device=dev)
    e0 = torch.zeros(Mb, dtype=torch.int32, device=dev)
    lcp = torch.zeros(Mb, dtype=torch.int32, device=dev)
    if Mb == 0 or E == 0:
        return nh, e0, lcp
    rows = max(1, max_elems // E)
    lane = torch.arange(E, device=dev)
    for r0 in range(0, Mb, rows):
        r1 = min(r0 + rows, Mb)
        hi = seed_hi[r0:r1].to(torch.int64) & U32
        lo = seed_lo[r0:r1].to(torch.int64) & U32
        real = lane[None, :] < seed_cnt[r0:r1, None]
        qh = (query_hi[r0:r1].to(torch.int64) & U32)[:, None]
        ql = (query_lo[r0:r1].to(torch.int64) & U32)[:, None]
        ok = query_valid[r0:r1]
        inr = (hi >= (qh & (U32 ^ suf))) & (hi <= (qh | suf)) & real
        below = (hi < (qh & (U32 ^ suf))) & real
        nh[r0:r1] = torch.where(ok, inr.sum(-1, dtype=torch.int32), 0)
        e0[r0:r1] = torch.where(ok, below.sum(-1, dtype=torch.int32), 0)
        xh, xl = hi ^ qh, lo ^ ql
        bits = torch.where(xh != 0, 32 - bit_length(xh), 64 - bit_length(xl))
        bases = torch.where(inr, torch.clamp(bits >> 1, max=k), 0)
        lcp[r0:r1] = torch.where(ok, bases.max(-1).values, 0).to(torch.int32)
    return nh, e0, lcp


LIB = Library("seed_match", {
    "seed_match": ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
                   + [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    "seed_match_run": ([], ctypes.c_int),
})


def seed_match(seed_hi, seed_lo, seed_cnt, query_hi, query_lo, query_valid, p: int, k: int = 31):
    """Per-row >=p-prefix entry range and best in-range LCP for one query.

    seed_hi, seed_lo int32 [Mb, E] (uint32 bits, rows sorted by (hi, lo) over
    [0, cnt)), seed_cnt int32 [Mb], query_hi, query_lo int32 [Mb],
    query_valid bool [Mb]; 1 <= p <= 16, 16 < k <= 32.  Returns (n_hits,
    e0, best_lcp), all int32 [Mb].  CUDA tensors launch the kernel
    (`launches` counts them); CPU tensors run the plain version."""
    _check(seed_hi, seed_lo, seed_cnt, query_hi, query_lo, query_valid)
    suf = suffix_mask(p)
    if not 16 < k <= 32:
        raise ValueError(f"k must be in (16, 32], got {k}")
    if seed_hi.device.type == "cpu":
        return seed_match_plain(seed_hi, seed_lo, seed_cnt, query_hi, query_lo, query_valid,
                                p, k)
    ptrs = cuda_ptrs(seed_hi=seed_hi, seed_lo=seed_lo, seed_cnt=seed_cnt, query_hi=query_hi,
                     query_lo=query_lo, query_valid=query_valid)
    Mb, E = seed_hi.shape
    out = torch.empty((3, Mb), dtype=torch.int32, device=seed_hi.device)
    if Mb == 0:
        return out[0], out[1], out[2]
    run = LIB.lib().seed_match_run()
    if run != MATCH_RUN:
        raise RuntimeError(f"csrc/seed_match.cu runs {run} entries a head, "
                           f"MATCH_RUN says {MATCH_RUN}")
    LIB.launch("seed_match", seed_hi.device, *ptrs, out[0].data_ptr(), out[1].data_ptr(),
               out[2].data_ptr(), Mb, E, suf, k)
    seed_match.launches += 1
    return out[0], out[1], out[2]


seed_match.launches = 0
