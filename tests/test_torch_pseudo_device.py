"""The port's DevicePseudoAligner (phase 4, the pseudo_probe and pseudo_chain
plain twins on the CPU) against the port's native oracle (compare_prepare +
chain2_backtrack) and against the JAX package's DevicePseudoAligner, on the
windows of tests/test_pseudo_device.py plus anchor ties and one-anchor
windows.  Every window the port does not flag must equal the oracle; the
windows neither side flags must equal the JAX run_batch."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from torch_parity import rec  # noqa: F401  (fixture)

from lexicmap_tpu.parallel.pseudo_device import DevicePseudoAligner as JaxAligner
from lexicmap_tpu_torch.index.search import SearchOptions
from lexicmap_tpu_torch.kernels import pseudo_align as PA
from lexicmap_tpu_torch.native import (
    chain2_backtrack_native,
    compare_prepare_native,
    compare_probe_codes_native,
    get_lib,
)
from lexicmap_tpu_torch.ops.seqcompare import SeqComparator
from lexicmap_tpu_torch.parallel.pseudo_device import (
    C_CAP,
    F_ANCHOR_OVERFLOW,
    DevicePseudoAligner,
    pack_codes_2bit,
    query_bucket_table,
    query_tables,
)
from lexicmap_tpu_torch.utils.kmers import seq_to_codes

pytestmark = pytest.mark.skipif(get_lib() is None, reason="native lib unavailable")

ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)
CPU = torch.device("cpu")
COPT = SearchOptions().seqcompare_options().chaining
DEFAULT = dict(band_base=COPT.band_base, band_count=COPT.band_count,
               max_gap=int(COPT.max_gap), min_score=int(COPT.min_score),
               min_align_len=COPT.min_align_len)


def _mk_cpr(qseq: bytes):
    cpr = SeqComparator(SearchOptions().seqcompare_options())
    cpr.index(seq_to_codes(qseq))
    return cpr


def host_rows(cpr, tcodes, begin, end, min_score, min_align_len):
    """The exact host chain rows (the oracle of tests/test_pseudo_device.py)."""
    copt = cpr.opt.chaining
    aq, at, al, _arc, scores, prev = compare_prepare_native(
        cpr.qk, cpr.qv, tcodes, cpr.opt.min_prefix, cpr.k, begin, end,
        copt.band_base, copt.band_count, copt.max_gap, qtab=cpr.qtab, bbits=cpr.qtab_bits)
    n = aq.shape[0]
    if n == 0:
        return None
    if n == 1:
        slen = int(al[0])
        if slen >= min_score and slen >= min_align_len:
            return np.array([[1, slen, slen, slen, aq[0], aq[0] + slen - 1,
                              at[0], at[0] + slen - 1]], dtype=np.int64)
        return None
    rows, _p, _t = chain2_backtrack_native(
        aq, at, al, scores, prev, float(min_score), min_align_len,
        float(copt.heuristic_kmer_pident_threshold))
    return rows if rows.shape[0] else None


def run_diff(cases, params=DEFAULT, jax_check=True):
    """cases: list of (qseq bytes, tcodes uint8).  Runs the port's batch and
    compares every window it does not flag with the host oracle and, where
    the JAX aligner does not flag it either, with the JAX result."""
    dev = DevicePseudoAligner(**params, device="cpu")
    queries, windows, cprs = [], [], []
    for qseq, tcodes in cases:
        cpr = _mk_cpr(qseq)
        queries.append((cpr.qk, cpr.qv))
        cprs.append(cpr)
        windows.append((len(queries) - 1, np.ascontiguousarray(tcodes), 0, len(qseq) - 1))
    res = dev.run_batch(queries, windows)
    jres = JaxAligner(**params).run_batch(queries, windows) if jax_check else [None] * len(res)
    kinds = []
    for (qseq, tcodes), cpr, (kind, rows), jr in zip(cases, cprs, res, jres):
        kinds.append(kind)
        if kind == "host":
            continue
        want = host_rows(cpr, tcodes, 0, len(qseq) - 1, params["min_score"],
                         params["min_align_len"])
        if want is None:
            assert kind == "none"
        else:
            assert kind == "rows" and rows.shape == want.shape and (rows == want).all()
        if jr is not None and jr[0] != "host":
            assert jr[0] == kind
            if kind == "rows":
                assert np.array_equal(jr[1][:, :8], rows)
    return kinds, dev


def _rand_seq(rng, n):
    return bytes(rng.choice(ALPHA, size=n))


def _mutate(rng, seq, n_mut):
    b = bytearray(seq)
    for p in rng.integers(0, len(b), size=n_mut):
        b[p] = ALPHA[rng.integers(0, 4)]
    return bytes(b)


def test_random_windows_match_host(rec):
    rng = np.random.default_rng(21)
    cases = []
    for i in range(8):
        q = _rand_seq(rng, 1500)
        t = np.frombuffer(_mutate(rng, q, 30 + 10 * i), dtype=np.uint8)
        cases.append((q, seq_to_codes(bytes(t))))
    kinds, dev = run_diff(cases)
    assert kinds == ["rows"] * 8  # nothing flagged, every window chained
    assert rec.totals["pseudo.card_windows"] == 8 and rec.totals["pseudo.host_windows"] == 0


def test_tandem_repeat_window(monkeypatch, rec):
    """Tandem repeats give dense, near-duplicate anchors (dedup, trim and
    region splitting); a window past A_CAP anchors is flagged."""
    flags = []  # the windows' flags as the aligner decodes them
    decode = DevicePseudoAligner._decode

    def spy(self, idxs, f, *a):
        flags.extend(f.tolist())
        return decode(self, idxs, f, *a)

    monkeypatch.setattr(DevicePseudoAligner, "_decode", spy)
    rng = np.random.default_rng(22)
    unit = _rand_seq(rng, 93)
    cases = []
    for copies in (12, 4):
        q = _rand_seq(rng, 300) + unit * copies + _rand_seq(rng, 300)
        cases.append((q, seq_to_codes(_mutate(rng, q, 15))))
    kinds, dev = run_diff(cases)
    assert kinds[0] == "host" and flags == [F_ANCHOR_OVERFLOW, 0]
    assert kinds[1] == "rows"
    assert rec.totals["pseudo.host_windows"] == rec.totals["pseudo.card_windows"] == 1


@pytest.mark.parametrize("n_segs", [C_CAP - 8, C_CAP + 8])
def test_chain_heavy_window(n_segs):
    """Many scattered matched segments: exact rows, or a flag when they pass
    C_CAP chains, never wrong rows."""
    rng = np.random.default_rng(23)
    segs = [_rand_seq(rng, 80) for _ in range(n_segs)]
    q = b"".join(s + _rand_seq(rng, 20) for s in segs)
    t = b"".join(s + _rand_seq(rng, 35) for s in reversed(segs))
    kinds, dev = run_diff([(q, seq_to_codes(t))])
    if n_segs < C_CAP:
        assert kinds == ["rows"]
    else:
        assert kinds in (["rows"], ["host"])


def test_prefix_colliding_query_stays_on_device():
    """11-base prefixes shared 6 ways: the JAX sort-join sends the query to
    the host (J <= 2); the port's table probe answers it exactly."""
    rng = np.random.default_rng(24)
    pref = _rand_seq(rng, 11)
    parts = [pref + _rand_seq(rng, 40) for _ in range(6)]
    q = b"".join(parts) + _rand_seq(rng, 600)
    kinds, _ = run_diff([(q, seq_to_codes(_mutate(rng, q, 10)))])
    assert kinds == ["rows"]


def _raw_anchor_keys(cpr, tcodes, end):
    aq, at, al, _ = compare_probe_codes_native(cpr.qk, cpr.qv, tcodes, cpr.opt.min_prefix,
                                               cpr.k, 0, end, qtab=cpr.qtab,
                                               bbits=cpr.qtab_bits)
    return list(zip(aq.tolist(), (aq + al).tolist(), at.tolist()))


def test_anchor_ties_keep_host_order():
    """Every exact 31-mer match is probed twice (forward against the query's
    forward entry, reverse complement against its rc entry) into anchors
    with equal (qb, qe, tb): the probe's anchors after sort, dedup and trim
    equal the host's, element for element."""
    rng = np.random.default_rng(25)
    q = _rand_seq(rng, 800)
    t = _rand_seq(rng, 100) + _mutate(rng, q[100:700], 6) + q[200:300] + _rand_seq(rng, 50)
    cpr = _mk_cpr(q)
    tcodes = seq_to_codes(t)
    keys = _raw_anchor_keys(cpr, tcodes, len(q) - 1)
    assert len(keys) - len(set(keys)) > 100  # many tied anchors
    words = pack_codes_2bit(tcodes, 16 * ((tcodes.shape[0] + 15) // 16))
    win = torch.tensor([[0, 0, tcodes.shape[0], 0, 0, 0, len(q) - 1, 11]], dtype=torch.int64)
    aqb, atb, aln, cnt, flg = PA.pseudo_probe(
        torch.from_numpy(words.view(np.int32)), win, *query_tables([(cpr.qk, cpr.qv)], CPU)[0])
    want = compare_prepare_native(cpr.qk, cpr.qv, tcodes, 11, 31, 0, len(q) - 1,
                                  COPT.band_base, COPT.band_count, COPT.max_gap,
                                  qtab=cpr.qtab, bbits=cpr.qtab_bits)
    n = int(cnt[0])
    assert int(flg[0]) == 0 and n == want[0].shape[0] > 10
    for got, w in zip((aqb, atb, aln), want[:3]):
        assert got[0, :n].tolist() == w.tolist()


@pytest.mark.parametrize("relaxed", [False, True], ids=["default_none", "relaxed_row"])
def test_one_anchor_window(relaxed):
    """A window whose only surviving anchor is one exact 31-mer: the
    single-anchor rule gives one row when it passes min_score and
    min_align_len (relaxed), else 'none'."""
    rng = np.random.default_rng(26)
    q = _rand_seq(rng, 600)
    t = _rand_seq(rng, 40) + q[300:331] + _rand_seq(rng, 40)
    cpr = _mk_cpr(q)
    assert compare_prepare_native(cpr.qk, cpr.qv, seq_to_codes(t), 11, 31, 0, len(q) - 1,
                                  COPT.band_base, COPT.band_count,
                                  COPT.max_gap)[0].shape[0] == 1
    params = dict(DEFAULT, min_score=20, min_align_len=25) if relaxed else DEFAULT
    kinds, _ = run_diff([(q, seq_to_codes(t))], params, jax_check=not relaxed)
    assert kinds == (["rows"] if relaxed else ["none"])


def test_no_anchor_and_short_windows():
    rng = np.random.default_rng(27)
    q = _rand_seq(rng, 500)
    kinds, _ = run_diff([(q, seq_to_codes(_rand_seq(rng, 400))), (q, seq_to_codes(q[:20]))])
    assert kinds == ["none", "none"]


def test_resident_and_uploaded_windows_agree():
    """The two ways the kernels read a window: by geometry from the genome
    store resident on the device, and packed and uploaded per batch (the
    path of a store over the device budget).  Both give the oracle's rows
    on windows of both strands across store batches."""
    from torch_parity import phase4_tensors

    blob, win, _tables, windows, cprs = phase4_tensors("cpu", n_sites=12)
    geoms = [(w[0], w[1], bool(w[3])) for w in win.tolist()]
    assert {g[2] for g in geoms} == {False, True}
    queries = [(c.qk, c.qv) for c in cprs]
    resident = DevicePseudoAligner(**DEFAULT, device="cpu")
    resident.blob = blob
    got_res = resident.run_batch(queries, windows, geoms)
    got_up = DevicePseudoAligner(**DEFAULT, device="cpu").run_batch(queries, windows)
    for (qi, t, b, e), a, u in zip(windows, got_res, got_up):
        want = host_rows(cprs[qi], t, b, e, DEFAULT["min_score"], DEFAULT["min_align_len"])
        assert a[0] == u[0] == "rows"
        assert np.array_equal(a[1], want) and np.array_equal(u[1], want)


def test_long_window_goes_host(rec):
    rng = np.random.default_rng(28)
    q = _rand_seq(rng, 300)
    t = np.zeros(PA.L_CAP + 1, dtype=np.uint8)
    dev = DevicePseudoAligner(**DEFAULT, device="cpu")
    cpr = _mk_cpr(q)
    assert dev.run_batch([(cpr.qk, cpr.qv)], [(0, t, 0, 299)]) == [("host", None)]
    assert rec.totals["pseudo.host_windows"] == 1 and rec.totals["pseudo.card_windows"] == 0


def test_chain_plain_stack_and_row_caps():
    """The backtrack's caps: more than C_CAP emitted chains flags
    F_CHAIN_OVERFLOW.  Anchors far apart on a diagonal-free layout: every
    anchor its own chain."""
    n = C_CAP + 5
    qb = torch.zeros((1, PA.A_CAP), dtype=torch.int32)
    tb = torch.zeros_like(qb)
    ln = torch.zeros_like(qb)
    qb[0, :n] = torch.arange(n) * 200
    tb[0, :n] = (n - torch.arange(n)) * 200  # descending: no anchor chains to another
    ln[0, :n] = 60
    cnt = torch.tensor([n], dtype=torch.int32)
    rows, ccnt, cflg = PA.pseudo_chain(qb, tb, ln, cnt, torch.zeros(1, dtype=torch.int32),
                                       **DEFAULT)
    assert int(cflg[0]) == PA.F_CHAIN_OVERFLOW and int(ccnt[0]) == 0
    cnt[0] = C_CAP
    rows, ccnt, cflg = PA.pseudo_chain(qb, tb, ln, cnt, torch.zeros(1, dtype=torch.int32),
                                       **DEFAULT)
    assert int(cflg[0]) == 0 and int(ccnt[0]) == C_CAP
    assert sorted(rows[0, :, 4].tolist()) == qb[0, :C_CAP].tolist()


def test_wrappers_launch_nothing_on_cpu():
    before = (PA.pseudo_probe.launches, PA.pseudo_chain.launches)
    rng = np.random.default_rng(29)
    q = _rand_seq(rng, 700)
    run_diff([(q, seq_to_codes(_mutate(rng, q, 20)))], jax_check=False)
    assert (PA.pseudo_probe.launches, PA.pseudo_chain.launches) == before


def test_probe_rejects_long_window():
    win = torch.tensor([[0, 0, PA.L_CAP + 1, 0, 0, 0, 10, 11]], dtype=torch.int64)
    with pytest.raises(ValueError):
        PA.pseudo_probe(torch.zeros(4, dtype=torch.int32), win,
                        *query_tables([(np.zeros(1, np.uint64), np.zeros(1, np.uint32))], CPU)[0])


def _numpy_bucket_table(k):
    """The host construction the card's table replaces: a bincount of the
    16-bit prefixes, then its running sum."""
    t = np.zeros((1 << 16) + 1, dtype=np.int64)
    if k.shape[0]:
        pref = (k >> np.uint64(46)).astype(np.int64)
        np.cumsum(np.bincount(pref, minlength=1 << 16), out=t[1:])
    return t


def _jax_cpr(qseq: bytes):
    from lexicmap_tpu.index.search import SearchOptions as JaxOptions
    from lexicmap_tpu.ops.seqcompare import SeqComparator as JaxComparator

    cpr = JaxComparator(JaxOptions().seqcompare_options())
    cpr.index(seq_to_codes(qseq))
    return cpr


def test_query_bucket_table_equals_numpy():
    """query_bucket_table (one searchsorted over every query's prefixes)
    equals the JAX package's bucket table (its SeqComparator.index) on
    indexed queries: random ones, an empty one (too short for a k-mer: the
    JAX package builds no table, every bucket is empty), and one whose four
    k-mers share one 16-bit prefix, that of the last bucket.  It also
    equals the per-query numpy table on synthetic queries around them, one
    of them wholly in the last bucket too."""
    rng = np.random.default_rng(30)

    def synthetic(prefix, n):
        low = np.sort(rng.integers(0, 1 << 46, n, dtype=np.uint64))
        return (np.uint64(prefix) << np.uint64(46)) | low, np.zeros(n, np.uint32)

    # 2 positions x 2 strands, every k-mer led by 8 T: prefix 0xFFFF
    last = b"T" * 9 + _rand_seq(rng, 14) + b"A" * 9
    seqs = [_rand_seq(rng, 900), b"ACGT" * 5, last, _rand_seq(rng, 400)]
    jcprs = [_jax_cpr(s) for s in seqs]
    queries = ([(c.qk, c.qv) for c in jcprs]
               + [synthetic(0xABCD, 50), synthetic(0xFFFF, 7)])
    (qk, _qv, qoff, tab), ok = query_tables(queries, CPU)
    assert ok.all() and qoff.tolist() == np.cumsum([0] + [q[0].shape[0] for q in queries]).tolist()
    assert torch.equal(tab, query_bucket_table(qk, qoff))
    assert tab.dtype == torch.int32 and tuple(tab.shape) == (len(queries), (1 << 16) + 1)
    for i, (s, jc) in enumerate(zip(seqs, jcprs)):
        want = jc.qtab.astype(np.int64) if jc.qk.shape[0] else np.zeros((1 << 16) + 1, np.int64)
        assert np.array_equal(tab[i].numpy(), want)
        pc = _mk_cpr(s)  # the port's comparator indexes the same k-mers
        assert np.array_equal(pc.qk, jc.qk) and np.array_equal(pc.qv, jc.qv)
    for i, (k, _v) in enumerate(queries):
        assert np.array_equal(tab[i].numpy(), _numpy_bucket_table(k))
    assert jcprs[1].qk.shape[0] == 0 and (tab[1] == 0).all()
    assert (jcprs[2].qk >> np.uint64(46)).tolist() == [0xFFFF] * 4
    assert int(tab[2, 0xFFFF]) == 0 and int(tab[2, -1]) == 4
    assert int(tab[4, 0xABCD]) == 0 and int(tab[4, 0xABCE]) == 50 == int(tab[4, -1])
    assert int(tab[5, 0xFFFF]) == 0 and int(tab[5, -1]) == 7


def test_query_tables_flag_queries_past_the_key_fields():
    """ok is False exactly for a query with a position whose anchors would
    not fit the 21-bit key fields (empty queries are fine)."""
    last = PA.COORD_MAX - PA.K  # the largest position that still fits
    queries = [(np.arange(3, dtype=np.uint64), np.array([2, 4, 6], np.uint32)),
               (np.zeros(0, np.uint64), np.zeros(0, np.uint32)),
               (np.arange(2, dtype=np.uint64), np.array([(last + 1) << 1, 0], np.uint32)),
               (np.arange(1, dtype=np.uint64), np.array([last << 1 | 1], np.uint32))]
    (qk, qv, qoff, _tab), ok = query_tables(queries, CPU)
    assert ok.tolist() == [True, True, False, True]
    assert qk.dtype == torch.int64 and qv.dtype == torch.int32 and qoff.tolist() == [0, 3, 3, 5, 6]
    assert qk.tolist() == [0, 1, 2, 0, 1, 0] and qk.is_contiguous() and qv.is_contiguous()
    assert qv.tolist() == [2, 4, 6, (last + 1) << 1, 0, last << 1 | 1]
