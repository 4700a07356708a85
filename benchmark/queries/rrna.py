"""Query class `rrna`: the whole rRNA-like gene of one genome's species,
mutated, on a random strand.  Its copies are every planted copy in every
genome (each species' variant differs from the others'); the genomes of
its own species carry it unchanged, so those must be hit.

Parameters: substitution [lo, hi], indel_share, indel_max (as `gene`).
"""

from __future__ import annotations

import numpy as np

from benchmark.lib.seqgen import mutate, revcomp
from benchmark.lib.traffic import Query


def _copy_map(c0: int, orient: int, L: int):
    if orient > 0:
        return lambda r: c0 + np.asarray(r, dtype=np.int64)
    return lambda r: c0 + L - 1 - np.asarray(r, dtype=np.int64)


def make(db, rng, spec: dict, u_len: float, u_div: float, qid: str) -> Query:
    if db.rrna_len == 0:
        raise ValueError("query class rrna needs a database with rRNA copies")
    gi = int(rng.integers(len(db.genomes)))
    g = db.genomes[gi]
    lo, hi = spec["substitution"]
    sub = lo + u_div * (hi - lo)
    q0, qmap = mutate(rng, db.species[g.species].rrna_variant, sub, sub * spec["indel_share"],
                      max_indel=int(spec["indel_max"]))
    rev = bool(rng.random() < 0.5)
    n0 = q0.shape[0]

    def to_source(qpos):
        return qmap.inv((n0 - 1 - qpos) if rev else qpos)

    occ = [(h, _copy_map(c0, o, db.rrna_len), o)
           for h, gh in enumerate(db.genomes) for c0, o in gh.rrna]
    return Query(qid=qid, codes=revcomp(q0) if rev else q0, kind="rrna", genome=gi, rev=rev,
                 to_source=to_source, occurrences=occ,
                 expected=list(db.species[g.species].strains))
