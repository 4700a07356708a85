"""The comparison that decides `correct`: search rows held against the
truth the benchmark planted and against a plain re-alignment.

It reads only the generated genomes and queries, and the TSV rows the
timed path printed (20 columns, as `lexicmap search` writes them).  Every
row of every query finished in the window is checked against the truth;
a sample of the rows, drawn from the seed with the longest query's first,
is re-aligned.

Numbers (each has a limit, limits/<workload>.json):
  missed_pct         share of (query, genome) pairs that must be found
                     (the genomes that carry the query's stretch unchanged
                     but for strain mutations) with no row on a planted copy
  missed_copies_pct  share of the planted copies in those genomes (each
                     rRNA-like copy on its strand, each strain's copy of a
                     gene) that no row on target overlaps
  missed_cross_copies_pct  the same share over the other species' copies
                     of an rRNA-like gene (variants 4-16% from the query's
                     species' one), which sound runs find all but ~1% of
  off_target_rows    rows on no planted copy of the query: no copy in that
                     genome on that strand whose place overlaps the row's
  coord_err_mean_bp  mean, over the rows on target, of the larger distance
                     between the row's subject start or end and where the
                     truth maps its query start or end
  pident_gap         widest |pident - the re-alignment's| (percentage
                     points) over the re-aligned rows
  fields_bad         rows whose derived fields disagree with what the rows
                     give: qcovHSP from qstart/qend, qcovGnm from the union
                     of the genome's HSPs, hits, qlen, slen
The widest coordinate error is reported beside them, not compared: an end
on an indel of the query or the strain can lie a few bases from the
truth's map in any optimal alignment, as far as the control's shifts.
"""

from __future__ import annotations

import numpy as np

from benchmark.lib.seqgen import revcomp
from benchmark.reference.align import align_batch

ALIGN_ROWS = 192
NUMBERS = ("missed_pct", "missed_copies_pct", "missed_cross_copies_pct", "off_target_rows",
           "coord_err_mean_bp", "pident_gap", "fields_bad")


def parse_row(row: str) -> dict:
    f = row.split("\t")
    return {
        "query": f[0], "qlen": int(f[1]), "hits": int(f[2]), "sgenome": f[3], "sseqid": f[4],
        "qcovGnm": f[5], "cls": int(f[6]), "hsp": int(f[7]), "qcovHSP": f[8],
        "alen": int(f[9]), "pident": float(f[10]), "gaps": int(f[11]),
        "qstart": int(f[12]), "qend": int(f[13]), "sstart": int(f[14]), "send": int(f[15]),
        "sstr": f[16], "slen": int(f[17]),
    }


def _union_len(iv: list[tuple[int, int]]) -> int:
    tot, cur_s, cur_e = 0, None, None
    for s, e in sorted(iv):
        if cur_e is None or s > cur_e + 1:
            if cur_e is not None:
                tot += cur_e - cur_s + 1
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        tot += cur_e - cur_s + 1
    return tot


def _strand(query, orient: int) -> str:
    return "+" if (orient > 0) != query.rev else "-"


def expected_interval(query, fn, qs: int, qe: int):
    """0-based genome interval that the truth gives for query positions
    qs..qe (0-based, inclusive) on one copy."""
    p = fn(query.to_source(np.array([qs, qe], dtype=np.int64)))
    return int(min(p)), int(max(p))


def row_error(query, copies: list, p: dict):
    """The distance of the row from the nearest planted copy that it
    overlaps (same genome, same strand), or None where it overlaps none."""
    src = query.to_source(np.array([p["qstart"] - 1, p["qend"] - 1], dtype=np.int64))
    best = None
    for fn, orient in copies:
        if _strand(query, orient) != p["sstr"]:
            continue
        g = fn(src)
        lo, hi = int(min(g)), int(max(g))
        if p["sstart"] - 1 > hi or p["send"] - 1 < lo:
            continue
        err = max(abs(p["sstart"] - 1 - lo), abs(p["send"] - 1 - hi))
        best = err if best is None else min(best, err)
    return best


def judge(db, done: list, seed: int, device: str = "cpu") -> tuple[dict, dict]:
    """(numbers, counts) for `done`, [(query, rows)]: every finished query;
    the sample is re-aligned on `device`."""
    gidx = {g.name: i for i, g in enumerate(db.genomes)}
    must = missed = off = fields_bad = n_rows = 0
    must_copies = missed_copies = cross = cross_found = 0
    err_sum, err_max, on_target = 0, 0, []  # on_target: (row, query)
    for query, rows in done:
        qlen = query.codes.shape[0]
        copies: dict[int, list] = {}
        for h, fn, orient in query.occurrences:
            copies.setdefault(h, []).append((fn, orient))
        by_genome: dict[str, list] = {}
        for r in rows:
            p = parse_row(r)
            by_genome.setdefault(p["sgenome"], []).append(p)
        n_rows += len(rows)
        found = set()
        spans: dict[int, list] = {}  # genome -> [(strand, lo, hi)] of its rows on target
        for name, ps in by_genome.items():
            cov = _union_len([(p["qstart"], p["qend"]) for p in ps])
            gnm = f"{min(cov / qlen * 100, 100.0):.3f}"
            g = gidx.get(name)
            for p in ps:
                hsp = f"{min((p['qend'] - p['qstart'] + 1) / qlen * 100, 100.0):.3f}"
                if (p["qcovHSP"] != hsp or p["qcovGnm"] != gnm or p["hits"] != len(by_genome)
                        or p["qlen"] != qlen
                        or g is None or p["slen"] != db.genomes[g].codes.shape[0]):
                    fields_bad += 1
                err = row_error(query, copies.get(g, []), p) if g is not None else None
                if err is None:
                    off += 1
                    continue
                err_sum += err
                err_max = max(err_max, err)
                on_target.append((p, query))
                found.add(g)
                spans.setdefault(g, []).append((p["sstr"], p["sstart"] - 1, p["send"] - 1))
        must += len(query.expected)
        missed += sum(h not in found for h in query.expected)
        expected = set(query.expected)
        for h, cps in copies.items():
            for fn, orient in cps:
                lo, hi = expected_interval(query, fn, 0, qlen - 1)
                strand = _strand(query, orient)
                hit = any(s == strand and a <= hi and b >= lo for s, a, b in spans.get(h, ()))
                if h in expected:
                    must_copies += 1
                    missed_copies += not hit
                else:
                    cross += 1
                    cross_found += hit

    picked = align_sample(on_target, seed)
    pairs = [hsp_pair(db, gidx, p, q) for p, q in picked]
    gap = 0.0
    for (p, _), ref in zip(picked, align_batch(pairs, device=device)):
        gap = max(gap, abs(p["pident"] - ref["pident"]))
    numbers = {
        "missed_pct": 100.0 * missed / must if must else 0.0,
        "missed_copies_pct": 100.0 * missed_copies / must_copies if must_copies else 0.0,
        "missed_cross_copies_pct": 100.0 * (cross - cross_found) / cross if cross else 0.0,
        "off_target_rows": off,
        "coord_err_mean_bp": err_sum / len(on_target) if on_target else 0.0,
        "pident_gap": gap,
        "fields_bad": fields_bad,
    }
    counts = {"queries": len(done), "rows": n_rows, "must_hit": must,
              "must_copies": must_copies, "cross_copies": cross,
              "realigned": len(picked), "realigned_max_bp": max(
                  (max(q.shape[0], t.shape[0]) for q, t in pairs), default=0),
              "coord_err_max_bp": err_max}
    return numbers, counts


def align_sample(on_target: list, seed: int, n: int = ALIGN_ROWS) -> list:
    """Rows to re-align: the longest query's first (a quarter at most),
    the rest drawn from the seed."""
    if len(on_target) <= n:
        return list(on_target)
    rng = np.random.default_rng([int(seed), 4])
    longest = max(q.codes.shape[0] for _, q in on_target)
    first = [i for i, (_, q) in enumerate(on_target) if q.codes.shape[0] == longest][: n // 4]
    taken = set(first)
    rest = [i for i in range(len(on_target)) if i not in taken]
    pick = first + [int(i) for i in rng.choice(rest, size=n - len(first), replace=False)]
    return [on_target[i] for i in sorted(pick)]


def hsp_pair(db, gidx: dict, p: dict, query):
    """The query and subject stretches of one row, the subject on the
    row's strand."""
    q = query.codes[p["qstart"] - 1: p["qend"]]
    t = db.genomes[gidx[p["sgenome"]]].codes[p["sstart"] - 1: p["send"]]
    return q, (revcomp(t) if p["sstr"] == "-" else t)


def ungapped_rows(db, done: list) -> list:
    """The control: every row's alignment taken without gaps (the seed
    chain's span compared base by base, no base-level alignment), its
    identity, length and subject end from that; the rest of the row as
    printed."""
    gidx = {g.name: i for i, g in enumerate(db.genomes)}
    out = []
    for query, rows in done:
        new = []
        for r in rows:
            f = r.split("\t")
            p = parse_row(r)
            if p["sgenome"] not in gidx:
                new.append(r)
                continue
            g = db.genomes[gidx[p["sgenome"]]].codes
            L = p["qend"] - p["qstart"] + 1
            q = query.codes[p["qstart"] - 1: p["qend"]]
            if p["sstr"] == "+":
                ss, se = p["sstart"], min(p["sstart"] + L - 1, g.shape[0])
                t = g[ss - 1: se]
            else:
                ss, se = max(p["send"] - L + 1, 1), p["send"]
                t = revcomp(g[ss - 1: se])
            k = min(L, t.shape[0])
            matches = int(np.count_nonzero(q[:k] == t[:k]))
            f[9], f[10], f[11] = str(L), f"{100.0 * matches / L:.3f}", "0"
            f[14], f[15] = str(ss), str(se)
            new.append("\t".join(f))
        out.append((query, new))
    return out
