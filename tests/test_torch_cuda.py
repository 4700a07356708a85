"""The hand-written CUDA kernels vs their plain PyTorch versions on the
card.  Needs a CUDA device and nvcc; skips where there is none.  Run on the
GPU machine with:  python -m pytest tests/test_torch_cuda.py -q"""

import numpy as np
import pytest
import torch

from chip_smoke import native_rows, same_prefix
from torch_parity import (
    CHAIN1_PARAMS,
    CHAIN_PARAMS,
    SHARD_CASES,
    SHARD_STACK_KINDS,
    capture_cases,
    chain1_csr,
    chain1_sets,
    chain_stress_windows,
    chain_tensors,
    compact_case,
    host_triples,
    make_edge_case,
    make_match_edge_case,
    phase4_tensors,
    rows_of,
    screening_case,
    seed_match_case,
    seed_match_replay,
    seed_match_torch,
    shard_kernel_case,
    shard_stack_case,
    sharded_db,
    to_torch,
    wfa_pairs,
    wfa_tensors,
)

from lexicmap_tpu_torch.kernels import chain1 as C1
from lexicmap_tpu_torch.kernels import pseudo_align as PA
from lexicmap_tpu_torch.kernels import wfa as WK
from lexicmap_tpu_torch.kernels import seed_locate as SL
from lexicmap_tpu_torch.kernels import seed_match as SM


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# both regimes of seed_locate_batch around their threshold, the edge rows
# of torch_parity.make_edge_case, B around the 32 lanes of a warp
EDGE_E = (128, SL.SMALL_MAX_E - 128, SL.SMALL_MAX_E + 128, 16384)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 11, 15, 16])
@pytest.mark.parametrize("B", [1, 7, 32, 33])
@pytest.mark.parametrize("E", EDGE_E)
def test_cuda_kernel_equals_plain(cuda_device, E, B, p):
    args = to_torch(*make_edge_case(p, B, E, seed=2), device=cuda_device)
    before = (SL.seed_locate_batch.launches, SL.seed_locate.launches)
    nh, e0 = SL.seed_locate_batch(*args, p)
    torch.cuda.synchronize()
    assert (SL.seed_locate_batch.launches, SL.seed_locate.launches) == (before[0] + 1, before[1])
    pn, pe = SL.seed_locate_batch_plain(*args, p)
    assert torch.equal(nh, pn) and torch.equal(e0, pe)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 11, 15, 16])
@pytest.mark.parametrize("E", EDGE_E)
def test_cuda_single_query_kernel_equals_plain(cuda_device, E, p):
    hi, cnt, qh, qv = to_torch(*make_edge_case(p, 1, E, seed=4), device=cuda_device)
    before = (SL.seed_locate_batch.launches, SL.seed_locate.launches)
    nh, e0 = SL.seed_locate(hi, cnt, qh[0], qv[0], p)
    torch.cuda.synchronize()
    # its own kernel, once per call
    assert (SL.seed_locate_batch.launches, SL.seed_locate.launches) == (before[0], before[1] + 1)
    pn, pe = SL.seed_locate_plain(hi, cnt, qh[0], qv[0], p)
    assert torch.equal(nh, pn) and torch.equal(e0, pe)


@pytest.mark.cuda
@pytest.mark.parametrize("E", [5, SL.SMALL_MAX_E - 2, SL.SMALL_MAX_E + 4, 16376])
def test_cuda_locate_unaligned_widths_equal_plain(cuda_device, E):
    """Widths off the 16-byte and run grid: B1 stages word by word below
    the threshold, and B2 reads its last runs word by word (E = 5 puts its
    top head on the first entry)."""
    for p in (1, 15):
        hi, cnt, qh, qv = to_torch(*make_edge_case(p, 33, E, seed=8), device=cuda_device)
        pn, pe = SL.seed_locate_batch_plain(hi, cnt, qh, qv, p)
        nh, e0 = SL.seed_locate_batch(hi, cnt, qh, qv, p)
        assert torch.equal(nh, pn) and torch.equal(e0, pe), p
        nh, e0 = SL.seed_locate(hi, cnt, qh[0], qv[0], p)
        assert torch.equal(nh, pn[0]) and torch.equal(e0, pe[0]), p


# seed_match's edge widths: below one run, off the run grid, on it, many runs
MATCH_E = (5, 100, 128, 16384)


def check_match_on_card(case, p, device):
    """The kernel, launched once, against the plain version and the replay
    of its search."""
    args = seed_match_torch(*case, device=device)
    before = SM.seed_match.launches
    got = SM.seed_match(*args, p)
    torch.cuda.synchronize()
    assert SM.seed_match.launches == before + 1
    want = SM.seed_match_plain(*args, p)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, r) for g, r in zip(got, seed_match_replay(*args, p)[:3]))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 11, 15, 16])
@pytest.mark.parametrize("dup", [False, True])
def test_cuda_seed_match_equals_plain(cuda_device, p, dup):
    check_match_on_card(seed_match_case(seed=p, dup=dup), p, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 11, 15, 16])
@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("E", MATCH_E)
def test_cuda_seed_match_edges_equal_plain(cuda_device, p, dup, E):
    """The edge rows of make_match_edge_case: counts around a run, a slice
    of several runs, queries below and above every entry, words past cnt."""
    check_match_on_card(make_match_edge_case(p, E, dup=dup, seed=5), p, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["seed_hi", "seed_lo"])
def test_cuda_seed_match_unaligned_table_equals_plain(cuda_device, which):
    """A table 4 bytes off the 16-byte grid: the kernel reads its runs word
    by word."""
    args = list(seed_match_torch(*make_match_edge_case(11, 128, seed=6), device=cuda_device))
    i = 0 if which == "seed_hi" else 1
    buf = torch.empty(args[i].numel() + 1, dtype=torch.int32, device=cuda_device)
    off = buf[1:].view(args[i].shape)
    off.copy_(args[i])
    assert off.data_ptr() % 16 != 0
    for p in (1, 11):
        want = SM.seed_match_plain(*args, p)
        args_off = args[:i] + [off] + args[i + 1:]
        assert all(torch.equal(g, w) for g, w in zip(SM.seed_match(*args_off, p), want)), p


@pytest.mark.cuda
def test_cuda_pseudo_kernels_equal_plain(cuda_device):
    blob, win, tables, _windows, _cprs = phase4_tensors(cuda_device)
    before = (PA.pseudo_probe.launches, PA.pseudo_chain.launches)
    probe = PA.pseudo_probe(blob.words, win, *tables)
    torch.cuda.synchronize()
    plain = PA.pseudo_probe_plain(blob.words, win, *tables)
    assert torch.equal(probe[3], plain[3]) and torch.equal(probe[4], plain[4])
    assert all(same_prefix(a, b, probe[3], PA.A_CAP) for a, b in zip(probe[:3], plain[:3]))
    assert int((probe[3] > 0).sum()) == win.shape[0]  # every planted window has anchors
    chain = PA.pseudo_chain(*probe)
    torch.cuda.synchronize()
    cplain = PA.pseudo_chain_plain(*probe, 100, 50, 20, 35.0, 50, 15.0)
    assert torch.equal(chain[1], cplain[1]) and torch.equal(chain[2], cplain[2])
    assert same_prefix(chain[0], cplain[0], chain[1], PA.C_CAP)
    assert (PA.pseudo_probe.launches, PA.pseudo_chain.launches) == (before[0] + 1,
                                                                     before[1] + 1)


@pytest.mark.cuda
def test_cuda_run_batch_equals_native_oracle(cuda_device):
    from lexicmap_tpu_torch.index.search import SearchOptions
    from lexicmap_tpu_torch.parallel.pseudo_device import DevicePseudoAligner

    blob, win, _tables, windows, cprs = phase4_tensors(cuda_device, seed=5)
    copt = SearchOptions().seqcompare_options().chaining
    dev = DevicePseudoAligner(copt.band_base, copt.band_count, int(copt.max_gap),
                              copt.min_score, copt.min_align_len, device=cuda_device)
    dev.blob = blob
    geoms = [(int(r[0]), int(r[1]), bool(r[3])) for r in win.tolist()]
    res = dev.run_batch([(c.qk, c.qv) for c in cprs], windows, geoms)
    assert [r[0] for r in res].count("rows") == len(windows)
    for (qi, codes, b, e), (kind, rows) in zip(windows, res):
        assert np.array_equal(rows, native_rows(cprs[qi], codes, b, e, copt))


@pytest.mark.cuda
@pytest.mark.parametrize("params", range(len(CHAIN_PARAMS)))
def test_cuda_chain_stress_equals_plain(cuda_device, params):
    """The warp DP's edge cases (tests/test_torch_chain_dp.py names them):
    windows staged in shared memory and windows past the slice (1,600 and
    A_CAP anchors), a probe-flagged window skipped."""
    wins = chain_stress_windows(a_cap=PA.A_CAP)
    args = chain_tensors(wins + [wins[2]], cuda_device, flagged=[len(wins)])
    before = PA.pseudo_chain.launches
    got = PA.pseudo_chain(*args, *CHAIN_PARAMS[params])
    torch.cuda.synchronize()
    assert PA.pseudo_chain.launches == before + 1
    want = PA.pseudo_chain_plain(*(a.cpu() for a in args), *CHAIN_PARAMS[params])
    assert torch.equal(got[1].cpu(), want[1]) and torch.equal(got[2].cpu(), want[2])
    assert same_prefix(got[0].cpu(), want[0], want[1], PA.C_CAP)
    assert int(want[1].sum()) > 0


@pytest.mark.cuda
def test_cuda_query_bucket_table_equals_cpu(cuda_device):
    from lexicmap_tpu_torch.parallel.pseudo_device import query_bucket_table

    _blob, _win, tables, _windows, _cprs = phase4_tensors(cuda_device)
    qk, _qv, qoff, qtab = tables
    assert torch.equal(qtab.cpu(), query_bucket_table(qk.cpu(), qoff.cpu()))


def _chain1_on_card(sets, dev, lead=0, block_min=None, gtab_len=None):
    """chain1_forward on the card (inputs `lead` elements into their
    buffers; genomes of at least `block_min` anchors on the block path,
    the wrapper's own BLOCK_MIN when None; the gap table cut to gtab_len)
    against its plain version there and, for the genomes it answers, the
    native DP."""
    from lexicmap_tpu_torch.native import chain1_forward_native
    from lexicmap_tpu_torch.parallel.chain_device import gap_score_table

    mg, msc, md = CHAIN1_PARAMS
    gtab = torch.from_numpy(gap_score_table(mg)[:gtab_len]).to(dev)
    qb, tb, ln, off = chain1_csr(sets, dev)
    qb, tb, ln = (torch.cat([torch.zeros(lead, dtype=torch.int32, device=dev), a])[lead:]
                  for a in (qb, tb, ln))
    kw = {}
    if block_min is not None:
        order, n_block = C1.schedule(off.cpu().numpy(), block_min)
        kw["plan"] = (torch.from_numpy(order).to(dev), n_block)
    before = C1.chain1_forward.launches
    got = C1.chain1_forward(qb, tb, ln, off, gtab, mg, msc, md, **kw)
    torch.cuda.synchronize()
    assert C1.chain1_forward.launches == before + (len(sets) > 0)
    want = C1.chain1_forward_plain(qb, tb, ln, off, gtab, mg, msc, md)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))
    ms, prev, dirs, flags = (t.cpu().numpy() for t in got)
    o = off.tolist()
    for g, s in enumerate(sets):
        if s[0].shape[0] < 2:
            continue
        w_ms, w_prev, w_dirs = chain1_forward_native(*s, mg, msc, md)
        a, b = o[g], o[g + 1]
        if gtab_len is not None and flags[g]:
            continue  # a gap past the cut table: the host's genome
        assert flags[g] == 0
        assert np.array_equal(ms[a:b].view(np.uint32), w_ms.astype(np.float32).view(np.uint32))
        assert np.array_equal(prev[a:b], w_prev) and np.array_equal(dirs[a:b], w_dirs)


@pytest.mark.cuda
def test_cuda_chain1_equals_plain_and_native(cuda_device):
    """B9 on the sets of tests/test_device_search.py's differential (the
    dense one past the JAX package's 512-anchor window), a reverse-strand
    set, one of 9,000 anchors, and a second draw without the big set."""
    _chain1_on_card(chain1_sets() + chain1_sets(seed=6, big=0), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["unaligned", "empty", "short"])
def test_cuda_chain1_edges(cuda_device, case):
    sets = chain1_sets(seed=7, big=0)
    if case == "unaligned":  # anchors that start one int32 into their buffers
        _chain1_on_card(sets, cuda_device, lead=1)
    elif case == "empty":
        _chain1_on_card([], cuda_device)
    else:  # genomes of 0 and 1 anchors beside real ones
        one = tuple(a[:1] for a in sets[2])
        none = tuple(a[:0] for a in sets[2])
        _chain1_on_card([none, sets[1], one, none, sets[3]], cuda_device)


def _dense_set(rng, n, span=900):
    """n anchors in `span` bp: every earlier anchor within max_dist."""
    qb = np.sort(rng.integers(0, span, n)).astype(np.int32)
    tb = (qb + rng.integers(-30, 30, n)).astype(np.int32)
    return qb, tb, rng.integers(15, 32, n).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["default", "warp", "block"])
def test_cuda_chain1_paths(cuda_device, path):
    """Both paths of the kernel on genomes at the block threshold (BLOCK_MIN
    - 1, BLOCK_MIN, BLOCK_MIN + 1 dense anchors), one of 3,000 whose window
    outgrows the block path's ring of 2,048 (and a warp's of 512), and
    short ones, on the threshold's split, all on warps, or all on blocks."""
    rng = np.random.default_rng(21)
    bm = C1.BLOCK_MIN
    sets = [_dense_set(rng, n) for n in (bm - 1, bm, bm + 1)]
    sets += [_dense_set(rng, 3000, 1200)] + chain1_sets(seed=8, big=0)[:4]
    sets.append(tuple(a[:1] for a in sets[-1]))
    _chain1_on_card(sets, cuda_device, block_min={"default": None, "warp": 1 << 30,
                                                   "block": 0}[path])


@pytest.mark.cuda
@pytest.mark.parametrize("block_min", [1 << 30, 0])
def test_cuda_chain1_unsorted_and_flags(cuda_device, block_min):
    """Anchors out of QBegin order (breaks in any chunk and round), and a
    gap table cut to 3 entries (flags raised only by the predecessors the
    native scan visits): kernel == plain on both paths."""
    rng = np.random.default_rng(11)
    sets = []
    for n in (700, 1500):
        qb = rng.integers(0, 1500, n).astype(np.int32)
        qb[rng.random(n) < 0.02] += 5000
        tb = (qb + rng.integers(-40, 40, n)).astype(np.int32)
        sets.append((qb, tb, rng.integers(15, 32, n).astype(np.int32)))
    _chain1_on_card(sets, cuda_device, block_min=block_min)
    _chain1_on_card(sets + chain1_sets(seed=9, big=0), cuda_device, block_min=block_min,
                    gtab_len=3)


@pytest.mark.cuda
@pytest.mark.parametrize("block_min", [1 << 30, 0])
def test_cuda_chain1_wide_coordinates(cuda_device, block_min):
    """Columns near the int32 limit and a negative tb (the kernel's gaps
    and differences in int64), on both paths: kernel == plain == native."""
    sets = []
    for shift, s in zip((1 << 30, (1 << 31) - 10_000, -(1 << 20)), chain1_sets(seed=12, big=0)[3:6]):
        qb, tb, ln = (a.astype(np.int64) for a in s)
        qb = qb + max(shift, 0)
        tb = tb + shift
        sets.append((qb.astype(np.int32), tb.astype(np.int32), ln.astype(np.int32)))
    _chain1_on_card(sets + chain1_sets(seed=13, big=0)[:2], cuda_device, block_min=block_min)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(10))
def test_cuda_wfa_edges(cuda_device, case):
    """B8 at its boundaries (torch_parity.wfa_edge_cases: spans of 32/33
    and W/W+1, an end at score S-1 or S, exactly CAP runs or one more):
    kernel == plain, answered exactly as the case says, then == wfa_align."""
    from lexicmap_tpu_torch.ops.wfa import wfa_align
    from torch_parity import wfa_edge_cases

    name, ps, S, W, CAP, answered = wfa_edge_cases()[case]
    args = wfa_tensors(ps, cuda_device)
    got = WK.decode_ops(*(t.cpu().numpy() for t in WK.wfa_batch(*args, S, W, CAP)))
    want = WK.decode_ops(*(t.cpu().numpy() for t in WK.wfa_plain(*args, S, W, CAP)))
    assert got == want, name
    assert (got[0] is not None) == answered, name
    if answered:
        assert got == [wfa_align(q, t).ops for q, t in ps], name


@pytest.mark.cuda
@pytest.mark.parametrize("x, o, e", [(3, 5, 1), (6, 3, 3), (5, 0, 2)])
def test_cuda_wfa_other_penalties(cuda_device, x, o, e):
    """Penalties whose gcd is 1 or 3 (every score a row, or every third)
    and a zero gap-open: kernel == plain == wfa_align."""
    from lexicmap_tpu_torch.ops.wfa import wfa_align

    pairs = wfa_pairs()[:-1]
    args = wfa_tensors(pairs, cuda_device)
    got = WK.decode_ops(*(t.cpu().numpy() for t in WK.wfa_batch(*args, 1024, 128, 1032, x, o, e)))
    want = WK.decode_ops(*(t.cpu().numpy() for t in WK.wfa_plain(*args, 1024, 128, 1032, x, o, e)))
    assert got == want
    for (q, t), g in zip(pairs, got):
        if g is not None:
            assert g == wfa_align(q, t, x, o, e).ops


@pytest.mark.cuda
def test_cuda_wfa_equals_plain_and_host(cuda_device):
    """B8 == its plain version == ops/wfa.py::wfa_align op for op, the last
    pair (unrelated sequences) flagged for the host."""
    from lexicmap_tpu_torch.ops.wfa import wfa_align

    pairs = wfa_pairs()
    args = wfa_tensors(pairs, cuda_device)
    S, W = 1024, 128
    before = WK.wfa_batch.launches
    got = WK.wfa_batch(*args, S, W, S + 8)
    torch.cuda.synchronize()
    assert WK.wfa_batch.launches == before + 1
    want = WK.wfa_plain(*args, S, W, S + 8)
    assert torch.equal(got[2], want[2])
    ops = WK.decode_ops(*(t.cpu().numpy() for t in got))
    assert ops == WK.decode_ops(*(t.cpu().numpy() for t in want))
    assert ops[-1] is None
    for (q, t), o in zip(pairs[:-1], ops[:-1]):
        assert o == wfa_align(q, t).ops


@pytest.mark.cuda
@pytest.mark.parametrize("n", [30, 2000, 8000])
def test_cuda_device_wfa_buckets_equal_host(cuda_device, n):
    """DeviceWFA on the card across its buckets: op lists == wfa_align's."""
    from lexicmap_tpu_torch.ops.wfa import wfa_align
    from lexicmap_tpu_torch.parallel.wfa_device import DeviceWFA
    from torch_parity import mutate_pair

    rng = np.random.default_rng(n)
    pairs = [mutate_pair(rng, n, 0.03, 0.005) for _ in range(6)]
    dw = DeviceWFA(device=cuda_device)
    got = dw.align_batch(pairs)
    assert dw.launches >= 1 and dw.stats["device_pairs"] == len(pairs), dw.stats
    assert got == [wfa_align(q, t).ops for q, t in pairs]


@pytest.mark.cuda
def test_cuda_search_many_device_stages_equal_host(cuda_device, tmp_path):
    """search_many with phases 2a, 3 (chain1), 4 and 5 (WFA) on the card ==
    the host engine's rows, every kernel of the path launched."""
    from lexicmap_tpu_torch.index.build import BuildOptions, build_index
    from lexicmap_tpu_torch.index.search import IndexSearcher, SearchOptions
    from torch_parity import mutated_queries, rows_of, write_genomes

    files, seqs = write_genomes(tmp_path)
    db = str(tmp_path / "d.lmt")
    build_index(db, files, BuildOptions(k=31, n_masks=512, chunks=2, verbose=False))
    qs = mutated_queries(seqs, ["D0", "D1", "D2"], 20000, 2000, 20, 3)
    qs += mutated_queries(seqs, ["D2", "D0"], 5000, 1500, 40, 4)
    host = IndexSearcher(db, SearchOptions(engine="host"))
    dev = IndexSearcher(db, SearchOptions(engine="device", device="cuda",
                                          chain_engine="device", wfa_engine="device"))
    before = (C1.chain1_forward.launches, WK.wfa_batch.launches)
    got = [rows_of(r) for r in dev.search_many(qs)]
    assert got == [rows_of(host.search_bytes(q)) for q in qs]
    assert C1.chain1_forward.launches == before[0] + 1
    assert WK.wfa_batch.launches > before[1]
    assert dev.device_chainer.stats["host_genomes"] == 0
    assert dev.device_wfa.stats["device_pairs"] == dev.device_wfa.stats["pairs"] > 0


def _capture_on_card(dev, masks, k, codes, exclude):
    """B10 on the card and its plain version there, from the engine's
    tables; returns (kernel outputs, plain outputs) as numpy."""
    from lexicmap_tpu_torch.kernels import capture as CK
    from lexicmap_tpu_torch.masks import MaskSet
    from lexicmap_tpu_torch.parallel.build_device import DeviceCaptureEngine

    eng = DeviceCaptureEngine(MaskSet(masks, k), device=dev)
    c = torch.from_numpy(codes).to(dev)
    e = None if exclude is None else torch.from_numpy(exclude).to(dev)
    before = CK.capture.launches
    got = CK.capture(c, e, eng.table, eng.masks, k, eng.p)
    torch.cuda.synchronize()
    assert CK.capture.launches == before + 1
    want = CK.capture_plain(c, e, eng.table, eng.masks, k, eng.p)
    return [t.cpu().numpy() for t in got], [t.cpu().numpy() for t in want], eng


def _native_capture(eng, codes, exclude):
    from lexicmap_tpu_torch.native import capture_native_call
    from lexicmap_tpu_torch.utils.kmers import kmers_fwd_rc

    fwd, rc = kmers_fwd_rc(codes, eng.k)
    return capture_native_call(fwd, rc, exclude, eng.ms.masks, eng.k, eng.p, False)


def _capture_case_ids():
    return [c[0] for c in capture_cases()]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(_capture_case_ids())), ids=_capture_case_ids())
def test_cuda_capture_equals_plain_and_native(cuda_device, case):
    """B10 == its plain version == native capture_native, exactly, on
    torch_parity.capture_cases (dense and bisected bucket tables, k = 21-32,
    slices sorted by one thread, a block, and merged runs)."""
    name, masks, k, codes, exclude = capture_cases()[case]
    got, want, eng = _capture_on_card(cuda_device, masks, k, codes, exclude)
    for a, b in zip(got, want):
        assert a.shape == b.shape and (a == b).all(), name
    nat = _native_capture(eng, codes, exclude)
    assert (got[0].view(np.uint64) == nat[0]).all() and (got[1] == nat[1]).all()
    assert (got[2].view(np.uint32) == nat[2]).all()


@pytest.mark.cuda
def test_cuda_capture_4mb_genome_equals_plain_and_native(cuda_device):
    """A 4 Mb genome at the index default of 20,000 masks (p = 8), with a
    copied block and contig-interval exclusions."""
    from lexicmap_tpu_torch.masks import MaskSet

    rng = np.random.default_rng(61)
    codes = rng.integers(0, 4, size=4 << 20, dtype=np.uint8)
    for c in range(20):
        codes[100_000 + c * 6_000: 105_000 + c * 6_000] = codes[10_000:15_000]
    exclude = np.zeros(codes.shape[0] - 30, dtype=bool)
    exclude[2_000_000:2_001_030] = True
    got, want, eng = _capture_on_card(cuda_device, MaskSet.generate(31, 20_000, 1).masks, 31,
                                      codes, exclude)
    assert eng.p == 8 and eng.table.shape[0] == 1 << 16
    for a, b in zip(got, want):
        assert a.shape == b.shape and (a == b).all()
    nat = _native_capture(eng, codes, exclude)
    assert (got[0].view(np.uint64) == nat[0]).all() and (got[1] == nat[1]).all()
    assert (got[2].view(np.uint32) == nat[2]).all()
    assert got[1].max() >= 21


@pytest.mark.cuda
def test_cuda_device_build_equals_host_build(cuda_device, tmp_path):
    """`index --engine device` on the card writes the host build's tree."""
    from lexicmap_tpu_torch.index.build import BuildOptions, build_index
    from lexicmap_tpu_torch.kernels import capture as CK
    from torch_parity import tree_bytes, write_genomes

    files, _ = write_genomes(tmp_path, n=3, length=60000, seed=22)
    trees = []
    before = CK.capture.launches
    for engine in ("device", "host"):
        out = str(tmp_path / f"{engine}.lmt")
        build_index(out, files, BuildOptions(k=31, n_masks=1024, chunks=2, engine=engine,
                                             verbose=False))
        trees.append(tree_bytes(out))
    assert CK.capture.launches == before + 3
    assert trees[0] == trees[1]


# the sharded matcher's kernels: B11 (seed_match_shard) and B12's compaction
# (shard_compact), and one NCCL rank holding four shards on the card


def _on_card(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev) for a in arrays]


def _shard_kernel_equals_plain(seeds, queries, k, p, dev):
    from lexicmap_tpu_torch.kernels import seed_match_shard as MS

    s, q = _on_card(dev, seeds, queries)
    before = MS.seed_match_shard.launches
    got = MS.seed_match_shard(s, q, k, p)
    torch.cuda.synchronize()
    assert MS.seed_match_shard.launches == before + 1
    want = MS.seed_match_shard_plain(s, q, k, p)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", SHARD_CASES)
def test_cuda_seed_match_shard_edges_equal_plain(cuda_device, name):
    _shard_kernel_equals_plain(*shard_kernel_case(name, seed=5), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 31, 33, 70])
@pytest.mark.parametrize("M, E", [(1, 5), (300, 1000), (40_000, 8)])
def test_cuda_seed_match_shard_shapes_equal_plain(cuda_device, B, M, E):
    """Batches around a warp's 32 lanes (one lane a query), and more rows
    than the kernel's grid has warps (40,000 > 4,096 blocks x 8)."""
    rng = np.random.default_rng(B * M + E)
    seeds = np.sort(rng.integers(1, 1 << 32, size=(M, E), dtype=np.uint32), axis=1)
    queries = seeds[np.arange(M)[None, :], rng.integers(0, E, size=(B, M))]
    queries[rng.random((B, M)) < 0.2] = 0
    nh = _shard_kernel_equals_plain(seeds, queries, 16, 15, cuda_device)[0]
    assert (nh > 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 31, 33, 64])
@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("E", [1, 20, 45, 1000, 10240])
def test_cuda_seed_match_shard_stacked_equals_plain(cuda_device, E, L, B):
    """One launch over L shards ([L, M, E], [L, B, M]) against the plain
    twin: E of one word, below and not a multiple of the 32-pivot sample,
    above it, and the 10k table's row; B around a warp's 32 lanes."""
    seeds, queries, k, p = shard_stack_case(L, B, 37, E, seed=1, p=12)
    nh = _shard_kernel_equals_plain(seeds, queries, k, p, cuda_device)[0]
    assert (nh > 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SHARD_STACK_KINDS)
@pytest.mark.parametrize("E", [1, 20, 333])
def test_cuda_seed_match_shard_stacked_edges_equal_plain(cuda_device, kind, E):
    """Rows all pad words, all-T queries that reach them, queries of 0,
    at L = 4 and B = 33."""
    seeds, queries, k, p = shard_stack_case(4, 33, 29, E, kind=kind, seed=2)
    nh = _shard_kernel_equals_plain(seeds, queries, k, p, cuda_device)[0]
    assert (nh > 0).any() == (kind != "zero_queries")
    if kind == "pad_rows":  # a query drawn from a pad row counts every word
        assert int(nh.max()) == E


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.05, 0.6, 1.0])
@pytest.mark.parametrize("H", [0, 1, 257, 1000])
def test_cuda_shard_compact_equals_plain(cuda_device, H, rate):
    from lexicmap_tpu_torch.kernels import shard_compact as SC

    nh, e0, gids = (t.to(cuda_device) for t in compact_case(B=33, mb=1000, hit_rate=rate,
                                                             seed=H, n_pad=24))
    before = SC.shard_compact.launches
    got = SC.shard_compact(nh, e0, gids, H)
    torch.cuda.synchronize()
    assert SC.shard_compact.launches == before + 1
    want = SC.shard_compact_plain(nh, e0, gids, H)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("H", [999, 1000, 1001])
def test_cuda_shard_compact_capacity_at_the_rows(cuda_device, H):
    """H at a bucket's row count (H = min(H_SHARD, mb_pad)): every row hit
    gives n == mb, kept whole at H >= mb, over capacity at H = mb - 1;
    written into a slab's row as the matcher does."""
    from lexicmap_tpu_torch.kernels import shard_compact as SC

    nh, e0, gids = (t.to(cuda_device) for t in compact_case(B=3, mb=1000, hit_rate=1.0,
                                                             seed=9))
    slab = torch.full((2, 3, 3 * H + 1), 7, dtype=torch.int32, device=cuda_device)
    got = SC.shard_compact(nh, e0, gids, H, out=slab[1])
    want = SC.shard_compact_plain(nh, e0, gids, H)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (got[3] == 1000).all() and (slab[0] == 7).all()
    assert torch.equal(got[0][:, : min(H, 1000)], gids[None, : min(H, 1000)].expand(3, -1))


@pytest.mark.cuda
def test_cuda_one_nccl_rank_four_shards(cuda_device, tmp_path):
    """make_mesh(local_shards=4) on the card (NCCL, world size 1): the
    sharded step's scores equal the plain twins' over the whole table (one
    launch a step), the matcher's triples equal the host bisection's (four
    launches of each kernel a bucket, and second compactions at a capacity
    under the hits), and the mesh engine's rows the host engine's."""
    from lexicmap_tpu_torch.index.search import IndexSearcher, SearchOptions
    from lexicmap_tpu_torch.kernels import seed_match_shard as MS
    from lexicmap_tpu_torch.kernels import shard_compact as SC
    from lexicmap_tpu_torch.parallel import sharded as TS
    from lexicmap_tpu_torch.parallel.engine import DeviceSearchEngine
    from lexicmap_tpu_torch.utils.kmers import seq_to_codes

    table, qarr = screening_case(tmp_path)
    t, q = (torch.from_numpy(a.view(np.int32)) for a in (table, qarr))
    want_scores = MS.seed_match_shard_plain(t, q, 16, 15)[2].numpy()
    db, _, queries = sharded_db(tmp_path)
    host = IndexSearcher(db, SearchOptions())
    kmers = np.stack([host._mask_query(seq_to_codes(s))[0] for s in queries])
    want_rows = [rows_of(host.search_bytes(s), f"q{i}") for i, s in enumerate(queries)]
    with TS.make_mesh(local_shards=4, device="cuda") as mesh:
        assert (mesh.dp, mesh.tp, mesh.device.type) == (1, 4, "cuda")
        step = TS.make_sharded_search_step(mesh, k=16, min_prefix=15)
        args = TS.shard_arrays(mesh, table, qarr)
        for _ in range(2):  # one launch a step, for the four shards
            before = MS.seed_match_shard.launches
            scores = step(*args)
            assert MS.seed_match_shard.launches == before + 1
            assert np.array_equal(scores.cpu().numpy(), want_scores)

        m = TS.ShardedSeedMatcher(host, mesh)
        before = (SL.seed_locate_batch.launches, SC.shard_compact.launches)
        got = m.match_batch(kmers, host.opt.min_prefix)
        n = 4 * len(m.buckets)
        assert (SL.seed_locate_batch.launches, SC.shard_compact.launches) == (
            before[0] + n, before[1] + n)
        for b, g in enumerate(got):
            want = host_triples(host, kmers[b], host.opt.min_prefix)
            assert g is not None and all(np.array_equal(x, y) for x, y in zip(g, want))
        m.H_SHARD = 4  # under most queries' hits on a shard: second passes
        before = SC.shard_compact.launches
        again = m.match_batch(kmers, host.opt.min_prefix)
        assert m.stats["second_passes"] >= 1
        assert SC.shard_compact.launches == before + n + 4 * m.stats["second_passes"]
        for a, g in zip(again, got):
            assert all(np.array_equal(x, y) for x, y in zip(a, g))

        idx = IndexSearcher(db, SearchOptions(device="cuda", chain_engine="device",
                                              wfa_engine="device"))
        eng = DeviceSearchEngine(idx, mesh=mesh)
        rows = [rows_of(r, f"q{i}") for i, r in
                enumerate(eng.finish_batch(eng.prepare_batch(queries)))]
        assert rows == want_rows and all(want_rows)
