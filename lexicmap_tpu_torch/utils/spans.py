"""Host spans of the search path: one recorder a searcher, with its
seconds (`totals`) and its spans (`counts`) by key, exact under the
client thread, the finish thread and the alignment pool together.

A span always adds its host seconds (time.perf_counter) to `totals[key]`
and one to `counts[key]`.  While torch.profiler records, it also opens
torch.profiler.record_function("lexicmap." + key), which puts the span on
the profiler's clock beside the card's rows, with `args` (the query's index
in its batch, or a transfer's stage label) as the range's arguments.  With
the profiler off a span costs two clock reads and one flag check.

A wait on the card (`card_wait`, used by kernels/runtime.py::fetch_numpy)
adds to the recorder bound to the waiting thread
(`SpanRecorder.bind_thread`); on a thread with none it times nothing.  So
do `bound_span` and `bound_tally`, which the device stages use without
holding a recorder of their own.

A counter (`SpanRecorder.tally`) adds a number of items, pairs or windows,
to `totals[key]` in place of seconds; its keys are COUNTERS.  The recorder
is the port's only account of what the device stages did.

This module imports no torch: the host engine's searcher never loads it,
and the profiler cannot record before torch is imported.
"""

from __future__ import annotations

import sys
import threading
from contextlib import nullcontext
from time import perf_counter

PREFIX = "lexicmap."

#: the phases' wall times, which DeviceSearchEngine.times has always held:
#: mask (1), match (2a), anchors (2b), chain (3), winprep and pseudo (4),
#: align (5-6) and wfa (the device WFA inside align); then the parts of
#: phases 1 and 2b (match.reverse: the batch's reversed-k-mer dispatch on
#: the card, inside match; anchors.reverse_host: a query the card declined,
#: dispatched on the host inside anchors.reverse), the client thread's wait
#: on the finish thread, the host's waits on the card, and wfa.host: the
#: host WFA of a pair the device WFA declined or flagged, inside wfa; then
#: the COUNTERS
KEYS = ("mask", "match", "anchors", "chain", "winprep", "pseudo", "align", "wfa",
        "mask.capture", "mask.filter", "match.reverse",
        "anchors.prefix", "anchors.reverse", "anchors.reverse_host", "anchors.suffix",
        "anchors.gather", "finish_wait", "card_wait", "wfa.host")
#: items, not seconds: phase 5's WFA pairs aligned on the card and on the
#: host (parallel/wfa_device.py; a host pair was declined without a launch
#: or flagged by the kernels), phase 4's windows answered on the card and
#: sent to the host (parallel/pseudo_device.py), the bytes of WFA history
#: the card's launches took (kernels/wfa.py's history_bytes_packed, summed
#: over a call's launches); then the pairs of wfa.host_pairs the kernels
#: flagged, phase 3's genomes sent to the chain1 kernel and those of them it
#: flagged (parallel/chain_device.py), and the sharded matcher's buckets
#: compacted a second time and the queries that took their hits from such a
#: pass (parallel/sharded.py)
COUNTERS = ("wfa.card_pairs", "wfa.host_pairs", "pseudo.card_windows", "pseudo.host_windows",
            "wfa.hist_bytes", "wfa.flagged_pairs", "chain.genomes", "chain.flagged_genomes",
            "match.second_passes", "match.second_pass_queries")
KEYS += COUNTERS

_bound = threading.local()
_NO_SPAN = nullcontext()


def profiling() -> bool:
    """Whether torch.profiler is recording.  torch's own
    `torch.autograd._profiler_enabled()` reads False under
    `_ExperimentalConfig(profile_all_threads=True)`, in every thread, so
    the flag that profile() sets for the whole process is read instead."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and getattr(prof, "_is_profiler_enabled", False)


class Span:
    """One timed interval of `key` (a context manager; see the module)."""

    __slots__ = ("_rec", "_key", "_args", "_t0", "_range")

    def __init__(self, rec: SpanRecorder, key: str, args=None):
        self._rec, self._key, self._args = rec, key, args

    def __enter__(self):
        self._range = None
        if profiling():
            import torch

            self._range = torch.profiler.record_function(
                PREFIX + self._key, None if self._args is None else str(self._args))
            self._range.__enter__()
        self._t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        dt = perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        self._rec.add(self._key, dt)


class SpanRecorder:
    """Seconds and spans by key, every key of KEYS seeded at 0; a counter's
    total is its items, and its count the calls that added them."""

    def __init__(self):
        self.totals = dict.fromkeys(KEYS, 0.0)
        self.counts = dict.fromkeys(KEYS, 0)
        self._lock = threading.Lock()

    def add(self, key: str, seconds: float):
        """One span of `seconds` (a loop's parts summed by the caller)."""
        with self._lock:
            self.totals[key] += seconds
            self.counts[key] += 1

    def tally(self, key: str, n: int):
        """n items (pairs, windows: not seconds) added to counter `key`,
        and one call to its count."""
        self.add(key, n)

    def span(self, key: str, args=None) -> Span:
        return Span(self, key, args)

    def bind_thread(self):
        """Make this the calling thread's recorder for its card waits."""
        _bound.rec = self


def bound_span(key: str, args=None):
    """A span of `key` under the calling thread's recorder; a no-op where
    none is bound."""
    rec = getattr(_bound, "rec", None)
    return _NO_SPAN if rec is None else Span(rec, key, args)


def bound_tally(key: str, n: int):
    """n items added to counter `key` of the calling thread's recorder;
    nothing where none is bound."""
    rec = getattr(_bound, "rec", None)
    if rec is not None:
        rec.tally(key, n)


def card_wait(label: str):
    """A span of the host's wait on the card under the calling thread's
    recorder, `label` the transfer's stage; a no-op where none is bound."""
    return bound_span("card_wait", label)
