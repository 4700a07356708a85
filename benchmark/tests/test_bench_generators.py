"""The database and query generators: deterministic for a seed, with the
stated lengths, shares and copies, and truth maps that point at the
bases a query came from."""

import json
import os

import numpy as np
import pytest

from benchmark.data import clades
from benchmark.lib.seqgen import PosMap, indels, mutate, revcomp, substitute
from benchmark.lib.traffic import QueryStream
from benchmark.tests.tinyspec import DATA

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def tiny_cfg():
    with open(os.path.join(DATA, "tiny_clades.json")) as fh:
        return json.load(fh)


def tiny_mix(**change):
    with open(os.path.join(DATA, "traffic", "tiny_mix.json")) as fh:
        mix = json.load(fh)
    for c in mix["classes"]:
        c.update(change)
    return mix


def test_database_is_deterministic_for_a_seed():
    a, b, c = (clades.generate(tiny_cfg(), s) for s in (2**31 + 5, 2**31 + 5, 7))
    assert [g.codes.tobytes() for g in a.genomes] == [g.codes.tobytes() for g in b.genomes]
    assert [g.codes.tobytes() for g in a.genomes] != [g.codes.tobytes() for g in c.genomes]


def test_database_layout_matches_the_config():
    cfg = tiny_cfg()
    db = clades.generate(cfg, 3)
    assert len(db.genomes) == sum(n * s for n, s in cfg["species"])
    assert [len(sp.strains) for sp in db.species] == [3, 1, 1]
    lo, hi = cfg["genome_bp"]
    # the ancestors' lengths are the same set for every seed
    lens = sorted(sp.ancestor_len for sp in db.species)
    lens2 = sorted(sp.ancestor_len for sp in clades.generate(cfg, 99).species)
    assert lens == lens2 and all(lo <= n <= hi for n in lens)
    for g in db.genomes:
        variant = db.species[g.species].rrna_variant
        assert 1 <= len(g.rrna) <= 3
        for c0, o in g.rrna:  # identical copies of the species' variant
            got = g.codes[c0: c0 + db.rrna_len]
            assert np.array_equal(got, variant if o > 0 else revcomp(variant))


def test_strain_maps_point_at_shared_bases():
    db = clades.generate(tiny_cfg(), 11)
    sp = db.species[0]
    a, b = (db.genomes[i] for i in sp.strains[:2])
    pos = np.arange(1000, 30000, 97)
    same = np.mean(a.codes[a.smap.fwd(pos)] == b.codes[b.smap.fwd(pos)])
    assert same > 0.95  # two strains at most 1% + 1% from the ancestor


def test_mutation_rates_and_posmap():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 4, 100_000, dtype=np.uint8)
    sub = substitute(rng, src, 0.02)
    assert np.count_nonzero(sub != src) == 2000
    out, pm = indels(rng, src, 0.001)
    assert out.shape[0] == pm.dst_len
    kept = np.concatenate([np.arange(s, s + n) for s, n in zip(pm.src_start, pm.length)])
    assert np.array_equal(out[pm.fwd(kept)], src[kept])
    assert np.array_equal(pm.inv(pm.fwd(kept)), kept)
    assert abs(len(pm.length) - 1 - 100) <= 1
    same, ident = mutate(rng, src, 0.0, 0.0)
    assert np.array_equal(same, src) and np.array_equal(ident.fwd(kept), kept)
    assert PosMap.identity(5).inv(7) == 4


def test_query_stream_is_deterministic_and_spread():
    db = clades.generate(tiny_cfg(), 5)
    mix = tiny_mix()
    a = QueryStream(db, mix, 2**33 + 1).take(400)
    b = QueryStream(db, mix, 2**33 + 1).take(400)
    assert [q.codes.tobytes() for q in a] == [q.codes.tobytes() for q in b]
    kinds = [q.kind for q in a]
    assert abs(kinds.count("rrna") - 100) <= 2  # the mix's 25%
    genes = [q.codes.shape[0] for q in a if q.kind == "gene"]
    spec = mix["classes"][0]["length"]
    assert min(genes) >= spec["min"] * 0.95 and max(genes) <= spec["max"] * 1.05
    assert 700 <= np.median(genes) <= 900
    # another seed draws nearly the same lengths, in another order
    c = [q.codes.shape[0] for q in QueryStream(db, mix, 17).take(400) if q.kind == "gene"]
    assert abs(np.median(c) - np.median(genes)) < 40
    assert [q.codes.shape[0] for q in a[:20]] != [q.codes.shape[0] for q in
                                                 QueryStream(db, mix, 17).take(20)]


@pytest.mark.parametrize("kind", ["gene", "rrna"])
def test_truth_maps_reproduce_the_query(kind):
    db = clades.generate(tiny_cfg(), 8)
    mix = tiny_mix(substitution=[0.0, 0.0])
    mix["classes"] = [c for c in mix["classes"] if c["kind"] == kind]
    mix["classes"][0]["share"] = 1.0
    for q in QueryStream(db, mix, 21).take(30):
        assert q.genome in q.expected
        qpos = np.arange(q.codes.shape[0])
        src = q.to_source(qpos)
        hits = 0
        for h, fn, orient in q.occurrences:
            g = db.genomes[h].codes
            base = g[fn(src)]
            if (orient > 0) != q.rev:
                ok = np.mean(base == q.codes)
            else:
                ok = np.mean((3 - base) == q.codes)
            if h in q.expected:
                assert ok > 0.97, (h, ok)  # a strain's own mutations only
            hits += ok > 0.97
        assert hits >= len(q.expected)
        if kind == "gene":
            assert sorted(q.expected) == sorted(db.species[db.genomes[q.genome].species].strains)
