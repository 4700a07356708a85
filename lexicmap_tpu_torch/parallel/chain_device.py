"""Device twin of the phase-3 chainer (Chainer.Chain's forward DP).

The forward DP of ops/chaining.py::chain (ref: lib-chaining.go:122-633,
mirrored by native chain1_forward) runs for every genome of every query
of an engine batch in one launch of the chain1 kernel
(kernels/chain1.py), the genomes one ragged batch.  Backtracking (pointer
chasing with visited marks) stays on the host, exactly like the native
path.

Twin of lexicmap_tpu/parallel/chain_device.py, without its TPU shapes:
there is no predecessor window (the kernel scans back to where the native
loop breaks), so no window truncation to flag, and no size buckets.  Bit
exactness: the seed weights and the score sum are float32 operations in
the host's order, the integer gap g is exact, and its score comes from
`gap_score_table`, the host formula with its float64 log2.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.chain1 import chain1_forward, pack_sets, schedule
from ..kernels.runtime import fetch_numpy
from ..utils.spans import bound_tally
from . import resolve_device

#: the gap-score table's largest gap: a longer max_gap leaves the gaps past
#: it to the host (F_GAP_TABLE), instead of a table of max_gap entries
GTAB_MAX = 1 << 20


def gap_score_table(max_gap: float) -> np.ndarray:
    """Host-side table of the chain1 gap score for integer g in
    [0, floor(max_gap)], computed with the exact host formula
    (ops/chaining.py::_gap_score_vec, float64 log2 rounded to float32)."""
    n = int(np.floor(max_gap)) + 1
    g = np.arange(n, dtype=np.float32)
    out = np.zeros(n, dtype=np.float32)
    nz = g > 0
    out[nz] = (np.float32(0.1) * g[nz]) + (
        np.float32(0.5) * np.log2(g[nz].astype(np.float64)).astype(np.float32)
    )
    return out


class DeviceChainer:
    """Batched phase-3 forward DP on the device with host backtracking.

    chain_batch() takes per-genome anchor arrays (already cleared/sorted by
    the host, ops/chaining.py::clear_substr_pairs) and returns per genome
    either ('ok', (max_scores, prev_idx, directions)) for the host
    backtrack, or ('host', None) when the genome must use the host chainer
    (fewer than two anchors, or a flag of the kernel).

    Each call with genomes of two or more anchors makes one launch and adds
    them to the counter `chain.genomes`, and those of them the kernel
    flagged to `chain.flagged_genomes`, under the recorder bound to the
    calling thread (utils/spans.py)."""

    def __init__(self, max_gap: float, min_score: float, max_dist: int, device=None):
        self.device = resolve_device(device)
        self.max_gap = float(max_gap)
        self.min_score = float(min_score)
        self.max_dist = int(max_dist)
        self._gtab = torch.from_numpy(gap_score_table(min(self.max_gap, GTAB_MAX))).to(
            self.device)

    def chain_batch(self, anchor_sets):
        """anchor_sets: list of (qb, tb, ln) int32 arrays (host order).
        Returns a list aligned with the input (see class docstring)."""
        out = [("host", None)] * len(anchor_sets)
        idxs = [i for i, (qb, _, _) in enumerate(anchor_sets) if qb.shape[0] >= 2]
        if not idxs:
            return out
        cols, off = pack_sets([anchor_sets[i] for i in idxs])
        order, n_block = schedule(off)
        # one upload: the columns, the order and the offsets (int64 at an
        # even int32 index) in one int32 buffer, then views of their types
        N, G = cols.shape[1], len(idxs)
        at = (3 * N + G + 1) // 2 * 2
        host = np.zeros(at + 2 * (G + 1), dtype=np.int32)
        host[: 3 * N] = cols.reshape(-1)
        host[3 * N: 3 * N + G] = order
        host[at:] = off.view(np.int32)
        up = torch.from_numpy(host).to(self.device)
        ms, prev, dirs, flags = chain1_forward(
            up[:N], up[N: 2 * N], up[2 * N: 3 * N], up[at:].view(torch.int64), self._gtab,
            self.max_gap, self.min_score, self.max_dist,
            plan=(up[3 * N: 3 * N + G], n_block))
        ms, prev, dirs, flags = fetch_numpy("device chain DP", ms, prev, dirs, flags)
        bound_tally("chain.genomes", len(idxs))
        bound_tally("chain.flagged_genomes", int(np.count_nonzero(flags)))
        for r, i in enumerate(idxs):
            if flags[r]:
                continue
            a, b = off[r], off[r + 1]
            out[i] = ("ok", (ms[a:b], prev[a:b].astype(np.int64), dirs[a:b]))
        return out
