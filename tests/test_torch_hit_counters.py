"""The per-hit stages' counters and span (utils/spans.py): phase 5's WFA
pairs on the card and on the host (of them, those the kernels flagged) and
the host WFA's span `wfa.host` (parallel/wfa_device.py), phase 4's windows
on the card and on the host (parallel/pseudo_device.py), each equal to the
pairs and windows the test knows go where; and a search of a gene planted
in several copies a genome through the device engine, whose rows equal the
host engine's and whose times hold the counters.  On the CPU, with the
kernels' plain twins."""

import threading

import numpy as np
import pytest

from torch_parity import mutate_pair, rows_of
from torch_parity import one_intra_op_thread  # noqa: F401  (autouse fixture)
from torch_parity import rec  # noqa: F401  (fixture)

from lexicmap_tpu_torch.index.build import BuildOptions, build_index
from lexicmap_tpu_torch.index.search import IndexSearcher, SearchOptions
from lexicmap_tpu_torch.kernels import pseudo_align as PA
from lexicmap_tpu_torch.ops.seqcompare import SeqComparator
from lexicmap_tpu_torch.ops.wfa import wfa_align
from lexicmap_tpu_torch.parallel import wfa_device as WD
from lexicmap_tpu_torch.parallel.pseudo_device import DevicePseudoAligner
from lexicmap_tpu_torch.utils import spans as S
from lexicmap_tpu_torch.utils.kmers import seq_to_codes

ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)


def wfa_pairs_every_bucket():
    """A pair in each bucket, then three for the host: an empty side, one
    past the last bucket, and two unrelated 1,500-base sequences, whose
    cost overflows the 1,024 scores of their bucket (flagged)."""
    rng = np.random.default_rng(11)
    pairs = [mutate_pair(rng, 300, 0.03, 0.01), mutate_pair(rng, 1500, 0.03, 0.01),
             mutate_pair(rng, 3000, 0.02, 0.004), mutate_pair(rng, 9000, 0.005, 0.001)]
    assert [WD.bucket_for(len(q), len(t)) for q, t in pairs] == list(WD.BUCKETS)
    q = pairs[0][0]
    pairs += [(q, q[:0]), mutate_pair(rng, WD.BUCKETS[-1][0] + 1, 0.0, 0.0),
              (rng.integers(0, 4, 1500).astype(np.uint8),
               rng.integers(0, 4, 1500).astype(np.uint8))]
    return pairs


def test_wfa_counters_equal_stats(rec):
    pairs = wfa_pairs_every_bucket()
    dw = WD.DeviceWFA(device="cpu")
    got = dw.align_batch(pairs)
    assert got == [wfa_align(q, t).ops for q, t in pairs]
    t, c = rec.totals, rec.counts
    # four on the card; three on the host: two declined without a launch
    # (an empty side, past the last bucket) and one the kernels flagged
    assert (t["wfa.card_pairs"], t["wfa.host_pairs"], t["wfa.flagged_pairs"]) == (4, 3, 1)
    assert t["wfa.card_pairs"] + t["wfa.host_pairs"] == len(pairs)
    # one span a host pair, one tally a call; counters hold items, not seconds
    assert c["wfa.host"] == 3 and t["wfa.host"] > 0
    assert c["wfa.card_pairs"] == c["wfa.host_pairs"] == c["wfa.flagged_pairs"] == 1
    # a second call adds to each
    dw.align_batch(pairs[:1])
    assert (t["wfa.card_pairs"], t["wfa.host_pairs"], t["wfa.flagged_pairs"]) == (5, 3, 1)
    assert c["wfa.card_pairs"] == 2


def test_counters_need_a_bound_recorder(rec):
    """On a thread with no recorder bound, the aligners record nothing and
    raise nothing; the bound thread's recorder is left alone."""
    pairs = wfa_pairs_every_bucket()[4:6]
    out = {}

    def work():
        out["ops"] = WD.DeviceWFA(device="cpu").align_batch(pairs)

    th = threading.Thread(target=work)
    th.start()
    th.join(timeout=60)
    assert out["ops"] == [wfa_align(q, t).ops for q, t in pairs]
    assert all(v == 0 for v in rec.totals.values())
    assert all(v == 0 for v in rec.counts.values())


def test_pseudo_window_counters_add_up(rec):
    """Windows of a 1,500-base query, mutated, and one past L_CAP: the card
    answers the first, the host takes the last."""
    rng = np.random.default_rng(12)
    q = bytes(rng.choice(ALPHA, size=1500))
    cpr = SeqComparator(SearchOptions().seqcompare_options())
    cpr.index(seq_to_codes(q))
    windows = []
    for k in range(5):
        b = bytearray(q)
        for p in rng.integers(0, len(b), size=20 + 10 * k):
            b[p] = ALPHA[rng.integers(0, 4)]
        windows.append((0, seq_to_codes(bytes(b)), 0, len(q) - 1))
    windows.append((0, np.zeros(PA.L_CAP + 1, dtype=np.uint8), 0, len(q) - 1))
    dev = DevicePseudoAligner(device="cpu")
    res = dev.run_batch([(cpr.qk, cpr.qv)], windows)
    assert [r[0] for r in res] == ["rows"] * 5 + ["host"]
    t = rec.totals
    assert t["pseudo.card_windows"] == 5
    assert t["pseudo.host_windows"] == 1
    assert t["pseudo.card_windows"] + t["pseudo.host_windows"] == len(windows)
    assert rec.counts["pseudo.card_windows"] == rec.counts["pseudo.host_windows"] == 1


def planted_genomes(d, n=3, length=24000, gene_len=400, seed=17):
    """n random genomes, each with 1..n copies of its own variant of one
    gene (3% substituted from a common ancestor), on either strand; returns
    the files and each genome's variant."""
    rng = np.random.default_rng(seed)
    anc = rng.choice(ALPHA, size=gene_len)
    comp = np.frombuffer(b"TGCA", dtype=np.uint8)
    files, variants = [], []
    for i in range(n):
        g = rng.choice(ALPHA, size=length)
        var = anc.copy()
        s = rng.random(gene_len) < 0.03
        var[s] = rng.choice(ALPHA, size=int(s.sum()))
        variants.append(bytes(var))
        rc = comp[np.searchsorted(ALPHA, var)][::-1]
        slots = rng.choice(length // (gene_len + 200), size=i + 1, replace=False)
        for c in slots:
            a = int(c) * (gene_len + 200) + 100
            g[a: a + gene_len] = var if rng.random() < 0.5 else rc
        p = d / f"P{i}.fasta"
        p.write_bytes(b">c0\n" + bytes(g) + b"\n")
        files.append(str(p))
    return files, variants


@pytest.fixture(scope="module")
def planted_db(tmp_path_factory):
    files, variants = planted_genomes(tmp_path_factory.mktemp("prefs"))
    out = str(tmp_path_factory.mktemp("pdb") / "p.lmt")
    build_index(out, files, BuildOptions(k=31, n_masks=512, chunks=2, threads=2))
    return out, variants


def test_planted_copies_through_the_device_engine(planted_db):
    """Each query hits every genome through every copy (1 + 2 + 3 HSPs);
    the rows equal the host engine's, and the engine's times hold the new
    counters, equal to what each stage saw: every pair and window on the
    card."""
    db, variants = planted_db
    qs = [variants[0], variants[2][:390]]
    dev = IndexSearcher(db, SearchOptions(engine="device", device="cpu",
                                          chain_engine="device", wfa_engine="device"))
    got = [rows_of(r, f"q{i}") for i, r in enumerate(dev.search_many(qs))]
    host = IndexSearcher(db, SearchOptions(engine="host"))
    assert got == [rows_of(host.search_bytes(q), f"q{i}") for i, q in enumerate(qs)]
    assert [len(r) for r in got] == [6, 6]
    eng = dev._device_engine
    t = eng.times
    assert set(S.COUNTERS) | {"wfa.host"} <= set(t)
    assert t["wfa.card_pairs"] > 0
    assert t["wfa.host_pairs"] == t["wfa.flagged_pairs"] == 0
    assert t["pseudo.card_windows"] >= 12
    assert t["pseudo.host_windows"] == 0
    assert t["chain.genomes"] > 0 and t["chain.flagged_genomes"] == 0
    assert t["wfa.host"] <= t["wfa"] <= t["align"]
