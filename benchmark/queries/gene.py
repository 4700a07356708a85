"""Query class `gene`: a stretch cut from one genome at a random place and
strand, then mutated.  Its copies are the same stretch in every strain
of the genome's species (through each strain's map from the ancestor).

Parameters: length {median, sigma, min, max} (log-normal, clipped),
substitution [lo, hi] (the rate, spread over the queries), indel_share
(indel rate as a share of the substitution rate), indel_max (bases).
"""

from __future__ import annotations

from benchmark.lib.seqgen import mutate, revcomp
from benchmark.lib.traffic import Query, lognormal_length


def make(db, rng, spec: dict, u_len: float, u_div: float, qid: str) -> Query:
    gi = int(rng.integers(len(db.genomes)))
    g = db.genomes[gi]
    L = min(lognormal_length(u_len, spec["length"]), g.codes.shape[0])
    span = db.rrna_len + 1
    while True:  # a gene, not an rRNA copy
        a = int(rng.integers(g.codes.shape[0] - L + 1))
        if all(a + L <= c0 or a >= c0 + span for c0, _ in g.rrna):
            break
    lo, hi = spec["substitution"]
    sub = lo + u_div * (hi - lo)
    q0, qmap = mutate(rng, g.codes[a:a + L], sub, sub * spec["indel_share"],
                      max_indel=int(spec["indel_max"]))
    rev = bool(rng.random() < 0.5)
    n0 = q0.shape[0]

    def to_source(qpos):
        j = (n0 - 1 - qpos) if rev else qpos
        return g.smap.inv(a + qmap.inv(j))

    strains = db.species[g.species].strains
    occ = [(h, db.genomes[h].smap.fwd, 1) for h in strains]
    return Query(qid=qid, codes=revcomp(q0) if rev else q0, kind="gene", genome=gi, rev=rev,
                 to_source=to_source, occurrences=occ, expected=list(strains))
