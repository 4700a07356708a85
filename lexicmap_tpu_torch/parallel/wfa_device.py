"""Batched gap-affine WFA on the GPU (phase 5's base-level aligner),
returning op lists equal to ops/wfa.py::wfa_align's.

The reference calls WFA once per HSP extension window (ref:
lib-index-search.go:2218; shenwei356/wfa with DefaultPenalties and
AdaptiveReduction).  Here every window of a whole query batch goes to the
card in a few launches of the WFA kernels (kernels/wfa.py): pairs are
grouped by length into buckets of (longest sequence L, scores S, window W),
and each bucket is cut into launches whose wavefront history stays under
HIST_BYTES.

Twin of lexicmap_tpu/parallel/wfa_device.py::DeviceWFA.  Sequences go to
the card packed 32 bases to a 64-bit word (the dense upload and its in-jit
expansion were for the TPU's transport), and batches are not padded to
powers of two (no compile shapes).  A pair with an empty side, one longer
than the last bucket, or one the kernels flag (a live span wider than W, no
end within S scores) is aligned by the host's wfa_align: exact in every
case.  Each such host alignment is a span `wfa.host`, and each call adds
its pairs to the counters `wfa.card_pairs` and `wfa.host_pairs` (of them,
those the kernels flagged to `wfa.flagged_pairs`), and the history bytes
its launches took (each sized to what its pairs write, at most HIST_BYTES)
to `wfa.hist_bytes`, under the recorder bound to the calling thread
(utils/spans.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.runtime import fetch_numpy
from ..kernels.wfa import check_pairs, decode_ops, history_bytes, pack_pairs, wfa_batch
from ..ops.wfa import wfa_align
from ..utils.spans import bound_span, bound_tally
from . import resolve_device

#: (longest sequence, scores, window of diagonals): S covers a cost of
#: about half the length (~10% substitutions and 1% indels), W the live
#: spans adaptive reduction leaves
BUCKETS = (
    (512, 384, 128),
    (2048, 1024, 128),
    (8192, 4096, 192),
    (30000, 12288, 256),
)
#: the most device bytes one launch's wavefront history could take
#: (history_bytes: every score's row at the full window), which cuts a
#: bucket into launches; a launch takes what its pairs write (the JAX
#: package keeps ~512 MB of it per dispatch)
HIST_BYTES = 512 << 20


def bucket_for(n: int, m: int):
    for b in BUCKETS:
        if n <= b[0] and m <= b[0]:
            return b
    return None


class DeviceWFA:
    """Aligns batches of HSP windows on the device, returning op lists
    identical to ops/wfa.py:wfa_align's.

    align_batch is safe to call from several threads (the phase-5 pools):
    the kernel library is built and loaded once under a lock
    (kernels/build.py), each call launches on its thread's current stream,
    and its counters go to its thread's recorder (see the module)."""

    def __init__(self, mismatch=4, gap_open=6, gap_ext=2, min_wf_len=10, max_dist_diff=50,
                 device=None):
        self.device = resolve_device(device)
        self.x, self.o, self.e = mismatch, gap_open, gap_ext
        self.min_wf_len = min_wf_len
        self.max_dist_diff = max_dist_diff

    def _host(self, q, t):
        r = wfa_align(q, t, self.x, self.o, self.e, min_wf_len=self.min_wf_len,
                      max_dist_diff=self.max_dist_diff)
        return r.ops if r is not None else None

    def align_batch(self, pairs):
        """pairs: list of (qcodes uint8[n], tcodes uint8[m]).
        Returns list of ops-lists ([(op, count), ...], same as wfa_align)."""
        results = [None] * len(pairs)
        groups: dict[tuple, list[int]] = {}
        host = []
        for i, (q, t) in enumerate(pairs):
            b = bucket_for(q.shape[0], t.shape[0]) if q.shape[0] and t.shape[0] else None
            if b is None:
                host.append(i)
            else:
                groups.setdefault(b, []).append(i)
        flagged = hist_bytes = 0
        for b, idxs in groups.items():
            L, S, W = b
            per = max(1, HIST_BYTES // history_bytes(1, S, W))
            for c0 in range(0, len(idxs), per):
                chunk = idxs[c0: c0 + per]
                got, took = self._align_chunk(b, [pairs[i] for i in chunk])
                hist_bytes += took
                for i, ops in zip(chunk, got):
                    if ops is None:
                        flagged += 1
                        host.append(i)
                    else:
                        results[i] = ops
        for i in host:
            with bound_span("wfa.host"):
                results[i] = self._host(*pairs[i])
        bound_tally("wfa.card_pairs", len(pairs) - len(host))
        bound_tally("wfa.host_pairs", len(host))
        bound_tally("wfa.flagged_pairs", flagged)
        bound_tally("wfa.hist_bytes", hist_bytes)
        return results

    def _align_chunk(self, bucket, pairs):
        """One launch over `pairs` (all within `bucket`, at most its
        HIST_BYTES share): (op lists, None where the kernels flagged; the
        history bytes the launch took)."""
        L, S, W = bucket
        arrs = pack_pairs(pairs)
        check_pairs(arrs[0].shape[0], *arrs[1:])
        # one upload: the words, the offsets and the lengths side by side
        # as int64 words, then views of their own types
        B, NW = len(pairs), arrs[0].shape[0]
        host = np.concatenate([arrs[0], arrs[1], arrs[2],
                               np.concatenate([arrs[3], arrs[4]]).view(np.int64)])
        up = torch.from_numpy(host).to(self.device)
        lens = up[NW + 2 * B:].view(torch.int32)
        scratch = {}
        ops, cnts, nops = wfa_batch(
            up[:NW], up[NW: NW + B], up[NW + B: NW + 2 * B], lens[:B], lens[B:],
            S, W, S + 8, self.x, self.o, self.e, self.min_wf_len, self.max_dist_diff,
            checked=True, scratch=scratch)
        ops, cnts, nops = fetch_numpy("device WFA", ops, cnts, nops)
        return decode_ops(ops, cnts, nops), scratch["hist_bytes"]
