"""Device pseudo-alignment of a batch of candidate windows (phase 4): the
SeqComparator probe -> anchor sort -> nested-anchor removal -> tandem trim
-> Chainer2 forward DP -> region-splitting backtrack, for every window of a
query batch in two kernel launches (kernels/pseudo_align.py).

Twin of lexicmap_tpu/parallel/pseudo_device.py.  It replaces the per-window
host calls compare_prepare + chain2_backtrack with the same results: every
window the kernels do not flag gets exactly the native oracle's chain rows.
The JAX package's TPU workarounds are gone: the probe gathers from the
query's k-mer table instead of sort-joining (no 3-way prefix-collision
flag, no J <= 2 limit), anchors are int32 (no 13-bit query-length cap), the
nested-anchor check scans every predecessor it needs (no dedup window), and
PyTorch runs eagerly (no compile-shape buckets).

The kernels read a window's codes from a blob of 2-bit words: the genome
store resident on the card (parallel/resident.py; the engine passes each
window's geometry) or, when the store does not fit there, the batch's
windows packed and uploaded per launch as a blob of their own (geoms=None).

A window goes to the host ('host') when it is longer than L_CAP, its query
does not fit the 21-bit anchor key fields, its geometry does not match its
length, or a kernel flags it: more than A_CAP anchors, more than C_CAP
chains, or a region stack deeper than S_CAP.  Each batch adds its windows
to the counters `pseudo.card_windows` and `pseudo.host_windows` under the
recorder bound to the calling thread (utils/spans.py).
ref: lib-seq_compare.go:335-521, lib-chaining2.go:152-658.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.pseudo_align import (  # noqa: F401  (the flag bits are re-exported)
    A_CAP,
    C_CAP,
    COORD_MAX,
    F_ANCHOR_OVERFLOW,
    F_CHAIN_OVERFLOW,
    F_STACK_OVERFLOW,
    K,
    L_CAP,
    QTAB_BITS,
    WORDS_OUT,
    check_windows,
    pseudo_chain,
    pseudo_probe,
)
from ..constants import SearchDefaults
from ..kernels.runtime import fetch_numpy
from ..ops.seqcompare import min_prefix_for
from ..utils.spans import bound_tally
from . import resolve_device

M_PREFIX = SearchDefaults.CMP_MIN_PREFIX  # SeqComparator minimum prefix
HEURISTIC_PIDENT = SearchDefaults.HEURISTIC_KMER_PIDENT_THRESHOLD  # chain pident gate
W_CHUNK = 2048  # windows per launch: bounds the [W, A_CAP] anchor tensors
#: device bytes of one launch's tensors: probe anchors (3 x [W, A_CAP]
#: int32), chain scratch (2 x [W, A_CAP]) and rows, uploaded window words,
#: and the query bucket tables of a 32-query batch with their int64
#: searchsorted probes
WORKING_BYTES = (W_CHUNK * (5 * A_CAP * 4 + C_CAP * 8 * 8 + L_CAP // 4 + 128)
                 + 32 * ((1 << QTAB_BITS) + 1) * 20)


# ---------------------------------------------------------------------------
# host-side packing helpers


def pack_codes_2bit(codes: np.ndarray, pad_to: int) -> np.ndarray:
    """[L] uint8 codes -> [pad_to//16] uint32, base i at bits 2*(i%16)."""
    buf = np.zeros(pad_to, dtype=np.uint32)
    buf[: codes.shape[0]] = codes
    buf = buf.reshape(-1, 16)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    return np.bitwise_or.reduce(buf << shifts, axis=1).astype(np.uint32)


def _upload(a: np.ndarray, dev):
    """a host array on `dev`; to the card through pinned memory, so the copy
    is queued and the host does not wait for the card's earlier work."""
    t = torch.from_numpy(a)
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


def query_tables(queries, dev):
    """The batch's query k-mer tables in the probe kernel's layout, on `dev`.

    queries: list of (qk u64 sorted, qv u32) per query (SeqComparator.qk,
    .qv).  Returns ([qk int64 concatenated, qv int32, qoff int64 [NQ+1],
    qtab int32 [NQ, 2^16+1]], ok bool [NQ] numpy); ok is False for a query
    whose anchor coordinates would not fit the 21-bit key fields.  The
    queries are concatenated straight into one staging tensor (pinned, so
    its blocks are reused and the copy is asynchronous), copied once, and
    the bucket table is built on `dev` (query_bucket_table)."""
    nq = len(queries)
    sizes = np.array([q[0].shape[0] for q in queries], dtype=np.int64)
    n = int(sizes.sum())
    host = torch.empty(n + nq + 1 + (n + 1) // 2, dtype=torch.int64,
                       pin_memory=dev.type == "cuda")
    buf = host.numpy()
    qoff = buf[n: n + nq + 1]
    qoff[0] = 0
    np.cumsum(sizes, out=qoff[1:])
    # the k-mers (< 4^31) and packed positions (< 2^31) as their signed twins
    qv = buf[n + nq + 1:].view(np.uint32)[:n]
    ok = np.ones(nq, dtype=bool)
    if nq:
        np.concatenate([np.asarray(q[0], dtype=np.uint64) for q in queries],
                       out=buf[:n].view(np.uint64))
        np.concatenate([np.asarray(q[1], dtype=np.uint32) for q in queries], out=qv)
        has = sizes > 0
        if has.any():  # each query's largest position, one reduceat over the batch
            ok[has] = (np.maximum.reduceat(qv, qoff[:-1][has]) >> 1).astype(np.int64) \
                + K <= COORD_MAX
    d = host.to(dev, non_blocking=True)
    qk_d, qoff_d = d[:n], d[n: n + nq + 1]
    return [qk_d, d[n + nq + 1:].view(torch.int32)[:n], qoff_d,
            query_bucket_table(qk_d, qoff_d)], ok


def query_bucket_table(qk, qoff):
    """qtab int32 [NQ, 2^16+1] on qk's device: row qi holds, for b in
    0..2^16, the first index among query qi's sorted k-mers whose top 16
    bits reach b (SeqComparator.index's buckets).  With R = 2^16 + 1, the
    keys qi * R + (k-mer >> 46) of the concatenated, per-query-sorted
    k-mers are sorted, so one searchsorted of qi * R + b, less qoff[qi],
    gives every row."""
    nq, row = qoff.shape[0] - 1, (1 << QTAB_BITS) + 1
    dev = qk.device
    base = torch.repeat_interleave(torch.arange(0, nq * row, row, device=dev), qoff.diff(),
                                   output_size=qk.shape[0])
    keys = base + (qk >> (2 * K - QTAB_BITS))
    probes = torch.arange(nq * row, device=dev).view(nq, row)
    return torch.searchsorted(keys, probes, out_int32=True).sub_(qoff[:-1, None])


# ---------------------------------------------------------------------------


class DevicePseudoAligner:
    """Batched device pseudo-alignment with per-window host fallback.

    run_batch(queries, windows, geoms=None) -> list of per-window results:
      ('rows', int64 [C, 8])  chains in emission order, columns
          [n_anchors, aligned_q, aligned_t, matched, qb, qe, tb, te]: the
          exact output of native chain2_backtrack, as align_paths takes it
          (pre_rows; pident is recomputed there in float64);
      ('host', None)  the caller runs the host compare path;
      ('none', None)  no chains (no anchors, or none survived).
    """

    def __init__(self, band_base=100, band_count=50, max_gap=20, min_score=35,
                 min_align_len=50, device=None):
        self.device = resolve_device(device)
        self.band_base = band_base
        self.band_count = band_count
        self.max_gap = max_gap
        self.min_score = min_score
        self.min_align_len = min_align_len
        #: DeviceGenomeBlob: with geometry, windows are read from it on the
        #: card; without, each batch's windows are packed and uploaded as a
        #: blob of their own
        self.blob = None

    def run_batch(self, queries, windows, geoms=None):
        """queries: list of (qk u64 sorted, qv u32) per batch query.
        windows: list of (qidx, tcodes uint8[L], begin, end).
        geoms: optional list aligned with windows of (word_base, phase, rc)
        blob geometry (words_out = WORDS_OUT), None for a window that has
        none; needs self.blob."""
        n_win = len(windows)
        results = [("host", None)] * n_win
        if n_win == 0:
            return results
        tables, q_ok = query_tables(queries, self.device)
        dev_idx = [
            i for i, (qidx, tcodes, _b, _e) in enumerate(windows)
            if q_ok[qidx] and tcodes.shape[0] <= L_CAP
            and (geoms is None or geoms[i] is not None)
        ]
        flagged = sum(self._run_chunk(dev_idx[o: o + W_CHUNK], windows, geoms, tables, results)
                      for o in range(0, len(dev_idx), W_CHUNK))
        bound_tally("pseudo.card_windows", len(dev_idx) - flagged)
        bound_tally("pseudo.host_windows", n_win - len(dev_idx) + flagged)
        return results

    def _run_chunk(self, idxs, windows, geoms, tables, results) -> int:
        """One launch of each kernel over the windows `idxs`; returns how
        many of them the kernels flagged."""
        d = self.device
        win = np.zeros((len(idxs), 8), dtype=np.int64)
        packed = []
        off = 0
        for row, i in enumerate(idxs):
            qidx, tcodes, begin, end = windows[i]
            L = tcodes.shape[0]
            if geoms is not None:
                wb, ph, rc = geoms[i]
            else:  # an uploaded window: a blob of its own at phase 0
                packed.append(pack_codes_2bit(tcodes, 16 * ((L + 15) // 16)))
                wb, ph, rc = off, 0, False
                off += packed[-1].shape[0]
            win[row] = (wb, ph, L, int(rc), qidx, begin, end, min_prefix_for(L, M_PREFIX))
        if geoms is not None:
            blob = self.blob.words
        else:
            words = np.concatenate(packed) if off else np.zeros(1, np.uint32)
            blob = _upload(words.view(np.int32), d)
        # checked here, on the host copy, and uploaded without a wait: the
        # host does not wait for the card before the probe launch
        check_windows(win, tables[2].shape[0] - 1)
        aqb, atb, aln, acnt, aflg = pseudo_probe(blob, _upload(win, d), *tables, checked=True)
        # the chain is queued right behind the probe: the host first waits
        # for the card at the fetch of both kernels' flags and counts
        rows, ccnt, cflg = pseudo_chain(
            aqb, atb, aln, acnt, aflg, self.band_base, self.band_count, self.max_gap,
            self.min_score, self.min_align_len, HEURISTIC_PIDENT)
        pflags, cnt, cflags = fetch_numpy("device pseudo-align probe",
                                          torch.stack((aflg, ccnt, cflg)))[0]
        # compaction on the device: only the emitted rows cross to the host
        valid = torch.arange(C_CAP, device=d)[None, :] < ccnt[:, None].to(torch.int64)
        flat = fetch_numpy("device pseudo-align chain", rows[valid])[0]
        return self._decode(idxs, pflags | cflags, cnt, flat, results)

    def _decode(self, idxs, flags, cnt, flat, results) -> int:
        """Per-window results from the compacted rows (window order, each
        window's rows in emission order); returns the flagged windows."""
        ptr = 0
        for k, i in enumerate(idxs):
            if flags[k]:
                continue
            c = int(cnt[k])
            if c == 0:
                results[i] = ("none", None)
                continue
            results[i] = ("rows", flat[ptr: ptr + c].astype(np.int64))
            ptr += c
        return int(np.count_nonzero(flags))
