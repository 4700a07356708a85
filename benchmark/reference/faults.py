"""Faults planted under the timed path, to show that the comparison
catches them (tests/test_bench_faults.py on the CPU; control.py reads
them on the card at a cell's own size).  Each wraps
IndexSearcher.search_many for as long as its context lasts.

  half     half of the queries left out (every second query's results
           dropped, across requests), the rest answered as usual
  strand   one answer altered where it is produced: in every request, the
           first HSP of the first query with a hit reported on the other
           strand
  first_hsp  chaining that keeps one HSP a genome: every genome hit keeps
           only the first HSP of its first sequence, the rest dropped
"""

from __future__ import annotations

from contextlib import contextmanager

FAULTS = ("half", "strand", "first_hsp")


def _half(results, state):
    out = []
    for r in results:
        out.append(r if state["n"] % 2 == 0 else [])
        state["n"] += 1
    return out


def _first_hsp(results, state):
    for hits in results:
        for r in hits:
            r.details = r.details[:1]
            for sd in r.details:
                sd.chains = sd.chains[:1]
    return results


def _strand(results, state):
    for hits in results:
        if hits and hits[0].details:
            sd = hits[0].details[0]
            sd.rc = not sd.rc
            break
    return results


@contextmanager
def planted(name: str | None):
    if name is None:
        yield
        return
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r} (have {FAULTS})")
    from lexicmap_tpu_torch.index.search import IndexSearcher

    orig = IndexSearcher.search_many
    change = {"half": _half, "strand": _strand, "first_hsp": _first_hsp}[name]

    state = {"n": 0}

    def broken(self, seqs):
        return change(orig(self, seqs), state)

    IndexSearcher.search_many = broken
    try:
        yield
    finally:
        IndexSearcher.search_many = orig
