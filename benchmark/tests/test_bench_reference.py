"""The plain reference: the banded alignment against an exhaustive one,
and the judge's numbers on rows built from the truth."""

import numpy as np
import pytest

from benchmark.data import clades
from benchmark.lib.traffic import QueryStream
from benchmark.reference import judge as J
from benchmark.reference.align import align_batch
from benchmark.tests.test_bench_generators import tiny_cfg, tiny_mix


def exhaustive(q, t):
    """(cost, matches, mismatches) of the lexicographically least
    alignment: Gotoh over tuples, no band."""
    n, m = len(q), len(t)
    big = (10**9, 0, 0)

    def add(a, c, mt, mm):
        return (a[0] + c, a[1] - mt, a[2] + mm)

    H = [[big] * (m + 1) for _ in range(n + 1)]
    E = [[big] * (m + 1) for _ in range(n + 1)]
    F = [[big] * (m + 1) for _ in range(n + 1)]
    H[0][0] = (0, 0, 0)
    for j in range(1, m + 1):
        H[0][j] = E[0][j] = (6 + 2 * j, 0, 0)
    for i in range(1, n + 1):
        H[i][0] = F[i][0] = (6 + 2 * i, 0, 0)
        for j in range(1, m + 1):
            F[i][j] = min(add(H[i - 1][j], 8, 0, 0), add(F[i - 1][j], 2, 0, 0))
            E[i][j] = min(add(H[i][j - 1], 8, 0, 0), add(E[i][j - 1], 2, 0, 0))
            d = (add(H[i - 1][j - 1], 0, 1, 0) if q[i - 1] == t[j - 1]
                 else add(H[i - 1][j - 1], 4, 0, 1))
            H[i][j] = min(d, E[i][j], F[i][j])
    c, negm, mm = H[n][m]
    return c, -negm, mm


def test_banded_alignment_equals_exhaustive():
    rng = np.random.default_rng(1)
    pairs = []
    for _ in range(40):
        q = rng.integers(0, 4, int(rng.integers(0, 30))).astype(np.uint8)
        t = list(q)
        for _ in range(int(rng.integers(0, 6))):
            op = rng.integers(0, 3)
            if op == 0 and t:
                t[int(rng.integers(len(t)))] = int(rng.integers(4))
            elif op == 1:
                t.insert(int(rng.integers(len(t) + 1)), int(rng.integers(4)))
            elif t:
                t.pop(int(rng.integers(len(t))))
        pairs.append((q, np.array(t, dtype=np.uint8)))
    for (q, t), r in zip(pairs, align_batch(pairs, band=16)):
        assert (r["cost"], r["matches"], r["mismatches"]) == exhaustive(list(q), list(t))
        assert r["alen"] == r["matches"] + r["mismatches"] + r["gaps"]


def truth_rows(db, q):
    """Rows as a correct search would print them: one HSP a must-hit
    genome, on its planted copy, identity from the reference."""
    qlen = q.codes.shape[0]
    rows = []
    hits = [(h, fn, o) for h, fn, o in q.occurrences if h in q.expected]
    n_genomes = len({h for h, _, _ in hits})
    for h, fn, o in hits:
        lo, hi = J.expected_interval(q, fn, 0, qlen - 1)
        strand = J._strand(q, o)
        t = db.genomes[h].codes[lo: hi + 1]
        ref = align_batch([(q.codes, J.revcomp(t) if strand == "-" else t)])[0]
        rows.append("\t".join(map(str, [
            q.qid, qlen, n_genomes, db.genomes[h].name, db.genomes[h].name + "_c1",
            "100.000", 1, 1, "100.000", ref["alen"], f"{ref['pident']:.3f}", ref["gaps"],
            1, qlen, lo + 1, hi + 1, strand, db.genomes[h].codes.shape[0], "0.00e+00", 100])))
    return rows


@pytest.fixture(scope="module")
def case():
    db = clades.generate(tiny_cfg(), 4)
    qs = QueryStream(db, tiny_mix(), 9).take(24)
    return db, [(q, truth_rows(db, q)) for q in qs]


def test_judge_reads_zero_on_true_rows(case):
    db, picked = case
    numbers, counts = J.judge(db, picked, 1)
    assert numbers["missed_pct"] == 0 and numbers["off_target_rows"] == 0
    assert numbers["missed_copies_pct"] == 0
    assert numbers["fields_bad"] == 0 and numbers["pident_gap"] < 0.001
    assert numbers["coord_err_mean_bp"] < 0.5  # an end on an indel maps to its neighbour
    assert counts["coord_err_max_bp"] <= 3
    assert counts["must_hit"] == sum(len(q.expected) for q, _ in picked)


def test_judge_sees_each_kind_of_wrong_row(case):
    db, picked = case
    q, rows = next((q, r) for q, r in picked if len(r) > 1)
    f = rows[0].split("\t")
    g = f[:]
    g[16] = "+" if f[16] == "-" else "-"  # the other strand
    n, _ = J.judge(db, [(q, ["\t".join(g)] + rows[1:])], 1)
    assert n["off_target_rows"] == 1
    g = f[:]
    g[14], g[15] = str(int(f[14]) + 40), str(int(f[15]) + 40)
    n, _ = J.judge(db, [(q, ["\t".join(g)] + rows[1:])], 1)
    assert n["coord_err_mean_bp"] >= 40 / len(rows)
    g[14], g[15] = str(int(f[14]) + 40000), str(int(f[15]) + 40000)
    n, _ = J.judge(db, [(q, ["\t".join(g)] + rows[1:])], 1)
    assert n["off_target_rows"] == 1
    g = f[:]
    g[10] = f"{float(f[10]) - 2:.3f}"
    n, _ = J.judge(db, [(q, ["\t".join(g)] + rows[1:])], 1)
    assert n["pident_gap"] == pytest.approx(2.0, abs=1e-3)
    g = f[:]
    g[8] = "50.000"
    n, _ = J.judge(db, [(q, ["\t".join(g)] + rows[1:])], 1)
    assert n["fields_bad"] == 1
    n, _ = J.judge(db, [(q, rows[1:])], 1)
    assert n["missed_pct"] > 0 and n["missed_copies_pct"] > 0


def test_judge_counts_each_planted_copy(case):
    """A genome that keeps one row of several copies is found, but its
    other copies are missed; other species' copies are counted apart."""
    db, picked = case
    q, rows = next((q, r) for q, r in picked
                   if len({x.split("\t")[3] for x in r}) < len(r))
    seen, one_each = set(), []
    for r in rows:
        g = r.split("\t")[3]
        if g not in seen:
            seen.add(g)
            one_each.append(r)
    n, counts = J.judge(db, [(q, one_each)], 1)
    assert n["missed_pct"] == 0 and n["off_target_rows"] == 0
    share = 100.0 * (len(rows) - len(one_each)) / len(rows)
    assert n["missed_copies_pct"] == pytest.approx(share)
    assert counts["must_copies"] == len(rows)
    assert counts["cross_copies"] > 0 and n["missed_cross_copies_pct"] == 100.0


def test_align_sample_takes_the_longest_first(case):
    db, picked = case
    rows = [(J.parse_row(r), q) for q, rs in picked for r in rs]
    longest = max(q.codes.shape[0] for _, q in rows)
    got = J.align_sample(rows, 5, n=8)
    assert len(got) == 8
    assert sum(q.codes.shape[0] == longest for _, q in got) >= min(
        2, sum(q.codes.shape[0] == longest for _, q in rows))
    again = J.align_sample(rows, 5, n=8)
    assert [(p["query"], p["sstart"]) for p, _ in got] == [(p["query"], p["sstart"]) for p, _ in again]
