"""Phase-3 chain1 forward DP of a batch of genomes: the hand-written CUDA
kernel of `csrc/chain1.cu` and its plain PyTorch twin.

  chain1_forward  (replaces lexicmap_tpu/parallel/chain_device.py::
                   build_chain1_fn): per genome, per anchor i, the best
                   predecessor by the Chainer's float32 score, exactly as
                   the native oracle native/core.cpp chain1_forward.

Layout: the genomes are one ragged batch, their anchors concatenated in
the host's order (sorted by QBegin, as clear_substr_pairs leaves them):
qb, tb, ln int32 [N], off int64 [G+1].  Outputs: max_scores float32 [N],
prev int32 [N] (the index within the genome), dirs int8 [N], at the same
offsets, and flags int32 [G]; a genome with a nonzero flag is not answered
and goes to the host.  The gap score of an integer gap g comes from the
table gtab float32 [L] (parallel/chain_device.py::gap_score_table); a gap
g <= max_gap with g >= L sets F_GAP_TABLE.

The kernel takes the genomes longest first (`schedule`): those of at least
BLOCK_MIN anchors a block of four warps each, the others a warp each.  On
the card the four outputs are views of one buffer (`runtime.fetch_numpy`
brings them back in one copy).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .runtime import Library, fetch_numpy, require

F_GAP_TABLE = 1  # a gap within max_gap past the gap-score table
#: anchors from which a genome takes a whole block (four warps share each
#: step's predecessors) instead of one warp
BLOCK_MIN = 1024

_count_lock = threading.Lock()


def pack_sets(sets) -> tuple[np.ndarray, np.ndarray]:
    """Anchor sets [(qb, tb, ln) int32 arrays] -> (cols int32 [3, N]: qb, tb,
    ln concatenated; off int64 [G+1])."""
    off = np.zeros(len(sets) + 1, dtype=np.int64)
    np.cumsum([s[0].shape[0] for s in sets], out=off[1:])
    cols = np.empty((3, int(off[-1])), dtype=np.int32)
    for c in range(3):
        if sets:
            np.concatenate([s[c] for s in sets], out=cols[c])
    return cols, off


def schedule(off: np.ndarray, block_min: int = BLOCK_MIN) -> tuple[np.ndarray, int]:
    """The kernel's genome order from the host's offsets: (order int32 [G],
    the genomes longest first, and n_block, how many of them, those of at
    least block_min anchors, take a block each)."""
    n = np.diff(off)
    order = np.argsort(-n, kind="stable").astype(np.int32)
    return order, int(np.count_nonzero(n >= block_min))


# ---------------------------------------------------------------------------
# plain version


def _seed_weight(l):
    """0.1f * l * l as two rounded float32 products (l float32)."""
    return (l * torch.tensor(0.1, dtype=torch.float32, device=l.device)) * l


def _forward_group(q, t, l, n, gtab, max_gap, min_score, max_dist):
    """The DP of genomes of similar size, padded to [B, N] (int64
    coordinates, n [B]), step i over the full predecessor prefix,
    vectorised over genomes and predecessors.  Returns (ms, prev, dirs,
    flag) [B, N], [B, N], [B, N], [B]."""
    B, N = q.shape
    dev = q.device
    f32 = torch.float32
    L = gtab.shape[0]
    lane = torch.arange(N, device=dev)
    ms = torch.zeros((B, N), dtype=f32, device=dev)
    prev = torch.zeros((B, N), dtype=torch.int64, device=dev)
    dirs = torch.zeros((B, N), dtype=torch.int64, device=dev)
    flag = torch.zeros(B, dtype=torch.bool, device=dev)
    ms[:, 0] = _seed_weight(l[:, 0].to(f32))
    neg_inf = torch.tensor(float("-inf"), dtype=f32, device=dev)
    for i in range(1, int(n.max())):
        live = i < n  # [B]
        aq, at, al = q[:, i: i + 1], t[:, i: i + 1], l[:, i: i + 1]
        bq, bt, bl = q[:, :i], t[:, :i], l[:, :i]
        m0 = _seed_weight(al.to(f32))
        qd = aq - bq
        # the native scan stops at the first j (descending) with qd > max_dist
        cut = torch.where(qd > max_dist, lane[None, :i], -1).max(1, keepdim=True).values
        td = at - bt
        atd = td.abs()
        cand = (lane[None, :i] > cut) & (qd != 0) & (atd <= max_dist) & (td != 0)
        fwd = at >= bt
        alt = ((at + al) - (bt + bl)).abs()
        g = torch.where(fwd, qd.abs() - atd, qd.abs() - alt).abs()
        cand &= g.to(f32) <= max_gap
        over = cand & (g >= L)
        flag |= over.any(1) & live
        cand &= ~over
        bqe = bq + bl
        no_ovl = aq > bqe
        length = torch.where(no_ovl, al, torch.where(g == 0, aq + al - bq, aq + al - bqe))
        sw_len = _seed_weight(length.to(f32))
        sw_bl = _seed_weight(bl.to(f32))
        w = torch.where(no_ovl | (g != 0), sw_len, -sw_bl + sw_len)
        d = torch.where(fwd, 1, -1)
        bdir = dirs[:, :i]
        base = torch.where((bdir == 0) | (bdir == d), ms[:, :i], sw_bl)
        s = (base + w) - gtab[g.clamp(0, L - 1)]
        valid = cand & (s >= min_score) & (s > m0)
        sm = torch.where(valid, s, neg_inf)
        best = sm.max(1, keepdim=True).values
        # largest j among equal scores
        pick = torch.where(valid & (sm == best), lane[None, :i], -1).max(1, keepdim=True).values
        found = pick >= 0
        ms[:, i: i + 1] = torch.where(found, best, m0)
        prev[:, i: i + 1] = torch.where(found, pick, i)
        dirs[:, i: i + 1] = torch.where(found, d.gather(1, pick.clamp(min=0)), 0)
    return ms, prev, dirs, flag


def chain1_forward_plain(qb, tb, ln, off, gtab, max_gap, min_score, max_dist):
    """The forward DP in tensor code: genomes grouped by the power of two
    above their anchor count, each group a loop over anchors vectorised
    over genomes and predecessors, in float32 with the kernel's (and the
    host's) order of operations.  Same arguments and outputs as
    `chain1_forward`."""
    dev = qb.device
    N = qb.shape[0]
    G = off.shape[0] - 1
    ms = torch.zeros(N, dtype=torch.float32, device=dev)
    prev = torch.zeros(N, dtype=torch.int32, device=dev)
    dirs = torch.zeros(N, dtype=torch.int8, device=dev)
    flags = torch.zeros(G, dtype=torch.int32, device=dev)
    offs = off.tolist()
    groups: dict[int, list[int]] = {}
    for g in range(G):
        n = offs[g + 1] - offs[g]
        if n > 0:
            groups.setdefault(1 << (n - 1).bit_length(), []).append(g)
    max_gap = float(torch.tensor(max_gap, dtype=torch.float32))
    min_score = torch.tensor(min_score, dtype=torch.float32, device=dev)
    for Np, gs in groups.items():
        n = torch.tensor([offs[g + 1] - offs[g] for g in gs], device=dev)
        idx = torch.tensor([offs[g] for g in gs], device=dev)[:, None] + torch.arange(
            Np, device=dev)[None, :]
        pad = torch.arange(Np, device=dev)[None, :] >= n[:, None]
        idx = torch.where(pad, 0, idx)
        # padding follows a genome's anchors: no real anchor scans it
        q = qb[idx].to(torch.int64)
        t = tb[idx].to(torch.int64)
        l = ln[idx].to(torch.int64)
        m, p, d, f = _forward_group(q, t, l, n, gtab, max_gap, min_score, int(max_dist))
        keep = ~pad
        ms[idx[keep]] = m[keep]
        prev[idx[keep]] = p[keep].to(torch.int32)
        dirs[idx[keep]] = d[keep].to(torch.int8)
        flags[torch.tensor(gs, device=dev)] = f.to(torch.int32) * F_GAP_TABLE
    return ms, prev, dirs, flags


# ---------------------------------------------------------------------------
# wrapper


LIB = Library("chain1", {
    "chain1_forward": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_float] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 5,
                       ctypes.c_int),
})


def chain1_forward(qb, tb, ln, off, gtab, max_gap, min_score, max_dist, *, plan=None):
    """The chain1 forward DP of every genome of a ragged batch (see the
    module docstring for the layout).  Returns (max_scores f32 [N], prev
    i32 [N], dirs i8 [N], flags i32 [G]).  CUDA tensors launch the kernel
    (`launches` counts them); CPU tensors run the plain version.  `plan`,
    when given, is `schedule(off)` with its order already on the card;
    else it is made from a host copy of off."""
    dev = qb.device
    N = qb.shape[0]
    for name, t in (("qb", qb), ("tb", tb), ("ln", ln)):
        require(name, t, torch.int32, dev, (N,))
    require("off", off, torch.int64, dev)
    require("gtab", gtab, torch.float32, dev)
    if off.dim() != 1 or off.shape[0] < 1:
        raise ValueError("off must be [G+1]")
    if gtab.dim() != 1 or gtab.shape[0] == 0:
        raise ValueError("gtab must be a non-empty 1-D table")
    if max_dist < 0:
        raise ValueError("max_dist must be >= 0")
    G = off.shape[0] - 1
    if dev.type == "cpu":
        return chain1_forward_plain(qb, tb, ln, off, gtab, max_gap, min_score, max_dist)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(9 * N + 4 * G, dtype=torch.uint8, device=dev)
    ms = out[: 4 * N].view(torch.float32)
    prev = out[4 * N: 8 * N].view(torch.int32)
    flags = out[8 * N: 8 * N + 4 * G].view(torch.int32)
    dirs = out[8 * N + 4 * G:].view(torch.int8)
    if G == 0:
        return ms, prev, dirs, flags
    if plan is None:
        host, n_block = schedule(fetch_numpy("device chain DP", off)[0])
        plan = (torch.from_numpy(host).to(dev), n_block)
    order, n_block = plan
    require("order", order, torch.int32, dev, (G,))
    LIB.launch("chain1_forward", dev, qb.data_ptr(), tb.data_ptr(), ln.data_ptr(),
               off.data_ptr(), order.data_ptr(), G, n_block, gtab.data_ptr(), gtab.shape[0],
               float(max_gap), float(min_score), int(max_dist), ms.data_ptr(), prev.data_ptr(),
               dirs.data_ptr(), flags.data_ptr())
    with _count_lock:
        chain1_forward.launches += 1
    return ms, prev, dirs, flags


chain1_forward.launches = 0
