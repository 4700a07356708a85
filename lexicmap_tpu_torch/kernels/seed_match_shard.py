"""Per-shard seed matching with the fused partial score: the hand-written
CUDA kernel (`csrc/sharded.cu`, `match_shard`) and its plain PyTorch twin.

Counterpart of lexicmap_tpu/parallel/sharded.py::seed_match_shard (with
kernels.py::searchsorted_rows and ::kmer_lcp_bases) and of the per-query
sum that make_sharded_search_step takes of it.  The JAX package runs it on
uint32 k-mers with k <= 16 only (it never enables x64); so does this one.
The k-mers are int32 tensors that hold the uint32 bits, as the seed-locate
kernels' hi words are.  With suf = 2^(2(k-p)) - 1, for query b and row m:

    e0          = left bisection of q & ~suf over the whole row of E words
    e1          = right bisection of q | suf
    n_hits[b,m] = e1 - e0 where q != 0, else 0
    lcp[b,m]    = LCP in bases of row[min(e0, E-1)] and q where n_hits > 0,
                  ((32 - bitlen(x)) >> 1) + k - 16 with x their xor, else 0
    score[b]    = float32(sum over m of n_hits * lcp)

The bisections take the row's padding for entries, as JAX's do: a query
whose range reaches 0xFFFFFFFF counts the pad words among its hits.  The
score is summed exactly in int64 and converted once: it equals JAX's
float32 sum wherever the totals stay below 2^24.

One call takes one shard (seeds [M, E], queries [B, M]) or a rank's L
local shards as `parallel.sharded.shard_arrays` lays them out (seeds
[L, M, E], queries [L, B, M]); then n_hits and lcp are [L, B, M] and the
score sums over the L shards too.  Either is one kernel launch.
"""

from __future__ import annotations

import ctypes

import torch

from .runtime import Library, cuda_ptrs
from .seed_locate import U32


def _suffix(k: int, p: int) -> int:
    if not 1 <= p <= k <= 16:
        raise ValueError(f"seed_match_shard takes 1 <= p <= k <= 16 (uint32 k-mers), "
                         f"got k = {k}, p = {p}")
    return (1 << (2 * (k - p))) - 1


def _check(seeds, queries):
    for name, t in (("seeds", seeds), ("queries", queries)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be torch.int32 holding the bits of uint32 k-mers "
                            f"(k <= 16; the JAX package never runs this on uint64), got "
                            f"{t.dtype}")
    if queries.device != seeds.device:
        raise ValueError(f"queries is on {queries.device}, seeds on {seeds.device}")
    if seeds.dim() not in (2, 3) or seeds.shape[-1] == 0 or seeds.shape[:-2].numel() == 0:
        raise ValueError(f"seeds must be [M, E] or [L, M, E] with E >= 1 and L >= 1, got "
                         f"{tuple(seeds.shape)}")
    lead = tuple(seeds.shape[:-2])
    if (queries.dim() != seeds.dim() or tuple(queries.shape[:-2]) != lead
            or queries.shape[-1] != seeds.shape[-2]):
        raise ValueError(f"queries must be [{', '.join(map(str, lead + ('B',)))}, "
                         f"{seeds.shape[-2]}] for seeds {tuple(seeds.shape)}, got "
                         f"{tuple(queries.shape)}")


def _plain_shard(seeds, queries, k, suf):
    """One shard's (n_hits, lcp) int64 [B, M] and the int64 [B] sum."""
    M, E = seeds.shape
    B = queries.shape[0]
    rows = (seeds.to(torch.int64) & U32).unsqueeze(0).expand(B, M, E)
    q = queries.to(torch.int64) & U32

    def search(x, strict):
        lo = torch.zeros_like(x)
        hi = torch.full_like(x, E)
        for _ in range(max(1, E.bit_length())):
            mid = (lo + hi) >> 1
            v = torch.gather(rows, 2, mid.clamp(max=E - 1).unsqueeze(2)).squeeze(2)
            right = v < x if strict else v <= x
            act = lo < hi
            lo = torch.where(act & right, mid + 1, lo)
            hi = torch.where(act & ~right, mid, hi)
        return lo

    e0 = search(q & (U32 ^ suf), True)
    e1 = search(q | suf, False)
    n_hits = torch.where(q != 0, e1 - e0, 0)
    first = torch.gather(rows, 2, e0.clamp(max=E - 1).unsqueeze(2)).squeeze(2)
    x = first ^ q
    bitlen = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = (x >> s) != 0
        bitlen = bitlen + torch.where(big, s, 0)
        x = torch.where(big, x >> s, x)
    bitlen = bitlen + (x != 0).to(torch.int64)
    lcp = torch.where(n_hits > 0, ((32 - bitlen) >> 1) + (k - 16), 0)
    return n_hits, lcp, (n_hits * lcp).sum(1)


def seed_match_shard_plain(seeds, queries, k: int, min_prefix: int):
    """JAX's fixed-trip bisection written with torch.gather, on the
    int64-widened words, shard by shard.  Returns (n_hits, lcp) int32
    ([B, M], or [L, B, M] for L shards) and the float32 [B] score, the
    int64 sum over every shard converted once."""
    _check(seeds, queries)
    suf = _suffix(k, min_prefix)
    if seeds.dim() == 2:
        n_hits, lcp, total = _plain_shard(seeds, queries, k, suf)
        return n_hits.to(torch.int32), lcp.to(torch.int32), total.to(torch.float32)
    parts = [_plain_shard(s, q, k, suf) for s, q in zip(seeds, queries)]
    return (torch.stack([p[0] for p in parts]).to(torch.int32),
            torch.stack([p[1] for p in parts]).to(torch.int32),
            sum(p[2] for p in parts).to(torch.float32))


#: csrc/sharded.cu, whose two kernels this module and kernels/shard_compact.py launch
SHARDED = Library("sharded", {
    "seed_match_shard": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                         + [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    "shard_compact": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
                      ctypes.c_int),
})


def seed_match_shard(seeds, queries, k: int, min_prefix: int):
    """Per-(query, row) prefix hits and LCP of one shard or of L shards,
    and the per-query score summed over them.

    seeds int32 [M, E] or [L, M, E] (uint32 k-mer bits, each row sorted
    ascending as uint32 over all E words), queries int32 [B, M] or
    [L, B, M] (0 = no k-mer); 1 <= min_prefix <= k <= 16.  Returns
    (n_hits, lcp) int32 of the queries' shape and the float32 [B] score.
    CUDA tensors launch the kernel once (`launches` counts the launches);
    CPU tensors run the plain version."""
    _check(seeds, queries)
    suf = _suffix(k, min_prefix)
    if seeds.device.type == "cpu":
        return seed_match_shard_plain(seeds, queries, k, min_prefix)
    ptrs = cuda_ptrs(seeds=seeds, queries=queries)
    M, E = seeds.shape[-2:]
    L = seeds.shape[0] if seeds.dim() == 3 else 1
    B = queries.shape[-2]
    dev = seeds.device
    out = torch.empty((2, *queries.shape), dtype=torch.int32, device=dev)
    acc = torch.empty(B + 1, dtype=torch.int64, device=dev)
    score = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return out[0], out[1], score
    SHARDED.launch("seed_match_shard", dev, *ptrs, out[0].data_ptr(), out[1].data_ptr(),
                   acc.data_ptr(), score.data_ptr(), L, B, M, E, suf, k)
    seed_match_shard.launches += 1
    return out[0], out[1], score


seed_match_shard.launches = 0
