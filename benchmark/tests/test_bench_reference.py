"""The plain reference: the banded alignment against an exhaustive one,
against the earlier aligner's outputs and against long pairs whose
optimum is known, and the judge's numbers on rows built from the truth."""

import json
import os

import numpy as np
import pytest

from benchmark.data import clades
from benchmark.lib.traffic import QueryStream
from benchmark.reference import judge as J
from benchmark.reference.align import BAND, LONG_BAND, MAX_LEN, align_batch
from benchmark.tests.test_bench_generators import tiny_cfg, tiny_mix

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


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


def mutated(rng, q, sub, indel):
    """q with substitutions at rate `sub` and 1-3 base indels at rate
    `indel`, half insertions, half deletions."""
    t = q.copy()
    s = rng.random(t.shape[0]) < sub
    t[s] = (t[s] + rng.integers(1, 4, int(s.sum()))) % 4
    pieces, last = [], 0
    for p in np.flatnonzero(rng.random(t.shape[0]) < indel).tolist():
        if p < last:
            continue
        L = int(rng.integers(1, 4))
        pieces.append(t[last:p])
        if rng.random() < 0.5:
            pieces.append(rng.integers(0, 4, L).astype(np.uint8))
            last = p
        else:
            last = min(p + L, t.shape[0])
    pieces.append(t[last:])
    return np.concatenate(pieces).astype(np.uint8)


def seeded_pairs(seed=20, count=40):
    """Pairs under 16,384 bases: a quarter of 10-16 kb, the rest up to
    5 kb, two of 0 and 1; 0.5-8% substitutions, indels a tenth to a third
    of that; a third with the mutated side as the query."""
    rng = np.random.default_rng(seed)
    pairs = []
    for c in range(count):
        if c < 2:
            n = c
        elif c % 4 == 0:
            n = int(rng.integers(10_000, 16_300))
        else:
            n = int(rng.integers(2, 5_000))
        q = rng.integers(0, 4, n).astype(np.uint8)
        sub = float(rng.uniform(0.005, 0.08))
        t = mutated(rng, q, sub, sub * float(rng.uniform(0.1, 0.33)))[:16_383]
        pairs.append((q, t) if c % 3 else (t, q))
    return pairs


def test_widened_encoding_equals_the_earlier_aligner():
    with open(os.path.join(DATA, "align_earlier.json")) as fh:
        earlier = json.load(fh)["rows"]
    pairs = seeded_pairs()
    assert sum(max(len(q), len(t)) >= 10_000 for q, t in pairs) >= 8
    got = [[r["cost"], r["matches"], r["mismatches"], r["gaps"], r["alen"]]
           for r in align_batch(pairs)]
    assert got == earlier


def known_pair(seed, n, spacing, pattern):
    """(query, target, (cost, matches, mismatches, gaps)): events placed
    `spacing` [lo, hi] bases apart, in the order of `pattern` ('s' a
    substitution, 'i' an insertion of 1-3 bases into the target, 'd' a
    deletion of 1-3 query bases), so far apart that no other alignment is
    as cheap: the optimum is the one that undoes each event."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, n).astype(np.uint8)
    pieces, last, p, k = [], 0, 0, 0
    subs = ins = dels = opens = 0
    while True:
        p += int(rng.integers(spacing[0], spacing[1] + 1))
        if p + spacing[1] >= n:
            break
        kind = pattern[k % len(pattern)]
        k += 1
        pieces.append(q[last:p])
        L = int(rng.integers(1, 4))
        if kind == "s":
            pieces.append((q[p: p + 1] + rng.integers(1, 4, 1)).astype(np.uint8) % 4)
            last, subs = p + 1, subs + 1
        elif kind == "i":
            pieces.append(rng.integers(0, 4, L).astype(np.uint8))
            last, ins, opens = p, ins + L, opens + 1
        else:
            last, dels, opens = p + L, dels + L, opens + 1
            p += L
    pieces.append(q[last:])
    t = np.concatenate(pieces).astype(np.uint8)
    cost = 4 * subs + 6 * opens + 2 * (ins + dels)
    return q, t, (cost, n - subs - dels, subs, ins + dels)


LONG_PAIRS = {
    "substitutions_20k": (1, 20_000, (20, 40), "s"),
    "substitutions_131071": (2, MAX_LEN, (50, 100), "s"),
    "indels_60k": (3, 60_000, (300, 600), "sisd"),
    "deletions_131071": (4, MAX_LEN, (800, 1600), "sd"),
    "insertions_100k": (5, 100_000, (800, 1600), "si"),
}


@pytest.fixture(scope="module")
def long_pairs():
    cases = {name: known_pair(*args) for name, args in LONG_PAIRS.items()}
    out = align_batch([(q, t) for q, t, _ in cases.values()])
    return {name: (case, r) for (name, case), r in zip(cases.items(), out)}


@pytest.mark.parametrize("name", list(LONG_PAIRS))
def test_exact_on_long_pairs_of_known_optimum(long_pairs, name):
    (q, t, (cost, matches, mism, gaps)), r = long_pairs[name]
    assert max(len(q), len(t)) <= MAX_LEN
    assert (r["cost"], r["matches"], r["mismatches"], r["gaps"]) == (cost, matches, mism, gaps)
    assert r["alen"] == matches + mism + gaps
    assert r["pident"] == pytest.approx(100.0 * matches / r["alen"])


@pytest.mark.parametrize("shape", [(MAX_LEN + 1, 10), (10, MAX_LEN + 1)])
def test_beyond_the_encoding_raises(shape):
    pair = tuple(np.zeros(x, dtype=np.uint8) for x in shape)
    with pytest.raises(ValueError):
        align_batch([(np.zeros(5, dtype=np.uint8),) * 2, pair])


@pytest.mark.parametrize("n, band", [(16_000, BAND), (40_000, LONG_BAND)])
def test_doubling_the_band_changes_nothing(n, band):
    rng = np.random.default_rng(n)
    pairs = []
    for sub in (0.005, 0.02, 0.05):
        q = rng.integers(0, 4, n).astype(np.uint8)
        pairs.append((q, mutated(rng, q, sub, sub / 10)))
    assert align_batch(pairs) == align_batch(pairs, band=2 * band)


def truth_rows(db, q):
    """Rows as a correct search would print them: one HSP a must-hit
    genome, on its planted copy, identity from the reference."""
    qlen = q.codes.shape[0]
    rows = []
    hits = [(h, fn, o) for h, fn, o in q.occurrences if h in q.expected]
    n_genomes = len({h for h, _, _ in hits})
    places = []
    for h, fn, o in hits:
        lo, hi = J.expected_interval(q, fn, 0, qlen - 1)
        strand = J._strand(q, o)
        t = db.genomes[h].codes[lo: hi + 1]
        places.append((h, lo, hi, strand, J.revcomp(t) if strand == "-" else t))
    refs = align_batch([(q.codes, t) for *_, t in places])
    for (h, lo, hi, strand, _), ref in zip(places, refs):
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
