"""The port's seed-match wrapper and plain twin (B3), and the torch replay
of its kernel's search, vs the JAX package's Pallas kernel
seed_match_pallas in interpret mode on the CPU.  All outputs are integer
counts, so every comparison is exact."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from torch_parity import (K, make_match_edge_case, seed_match_case, seed_match_replay,
                          seed_match_torch)

from lexicmap_tpu.parallel.pallas_kernels import seed_match_pallas
from lexicmap_tpu_torch.kernels import seed_match as SM
from lexicmap_tpu_torch.kernels.seed_locate import PAD_HI, split_kmers_hi_lo


@pytest.mark.parametrize("p", [11, 15, 16])
@pytest.mark.parametrize("dup", [False, True], ids=["distinct_hi", "duplicate_hi"])
def test_plain_equals_pallas(p, dup):
    case = seed_match_case(seed=p, dup=dup)
    want = seed_match_pallas(*case, p=p, k=K, tile_m=128, interpret=True)
    got = SM.seed_match_plain(*seed_match_torch(*case), p, K)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[2].numpy() == K).sum() > 50  # exact hits: LCP k
    assert ((got[2].numpy() > 0) & (got[2].numpy() < K)).any()  # mutated queries


def test_polyT_rows():
    """A poly-T query (qhi == 0xFFFFFFFF) still matches, and a 15-T query
    (rb saturates) does not count the padding."""
    hi, lo, cnt, qh, ql, has = seed_match_case(seed=5)
    t16 = np.uint64(0xFFFFFFFF) << np.uint64(2 * K - 32)
    t15 = np.uint64(0x3FFFFFFF) << np.uint64(2 * K - 30)
    for row, ents, q in ((0, [t16, t16 | np.uint64(1), t16 | np.uint64(0x100)],
                          t16 | np.uint64(0x123)),
                         (1, [t15 | np.uint64(3), t15 | np.uint64(9)], t15 | np.uint64(7))):
        h, lw = split_kmers_hi_lo(np.array(ents, dtype=np.uint64), K)
        hi[row], lo[row] = PAD_HI, PAD_HI
        hi[row, : len(ents)], lo[row, : len(ents)] = h, lw
        cnt[row] = len(ents)
        qh2, ql2 = split_kmers_hi_lo(np.array([q], dtype=np.uint64), K)
        qh[row], ql[row], has[row] = qh2[0], ql2[0], True
    want = seed_match_pallas(hi, lo, cnt, qh, ql, has, p=15, k=K, tile_m=128, interpret=True)
    got = SM.seed_match(*seed_match_torch(hi, lo, cnt, qh, ql, has), 15)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0][:2].tolist() == [3, 2] and got[1][:2].tolist() == [0, 0]


def test_cpu_wrapper_launches_nothing():
    args = seed_match_torch(*seed_match_case(seed=2))
    before = SM.seed_match.launches
    got = SM.seed_match(*args, 15)
    want = SM.seed_match_plain(*args, 15)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert SM.seed_match.launches == before


def test_plain_chunking_is_invisible():
    args = seed_match_torch(*seed_match_case(seed=3))
    whole = SM.seed_match_plain(*args, 13)
    tiny = SM.seed_match_plain(*args, 13, max_elems=1)
    assert all(torch.equal(a, b) for a, b in zip(whole, tiny))


@pytest.mark.parametrize("which", ["lo_shape", "query_len", "dtype", "k"])
def test_wrapper_rejects(which):
    hi, lo, cnt, qh, ql, has = seed_match_torch(*seed_match_case(seed=4))
    k = K
    if which == "lo_shape":
        lo = lo[:, :-1]
    elif which == "query_len":
        ql = ql[:-1]
    elif which == "dtype":
        hi = hi.to(torch.int64)
    else:
        k = 16
    with pytest.raises((TypeError, ValueError)):
        SM.seed_match(hi, lo, cnt, qh, ql, has, 15, k)


EDGE_E = (5, 100, 128, 2048)  # below one run, off the run grid, on it, many runs


@pytest.mark.parametrize("E", EDGE_E)
@pytest.mark.parametrize("dup", [False, True], ids=["distinct_hi", "duplicate_hi"])
@pytest.mark.parametrize("p", [1, 11, 15, 16])
def test_replay_equals_plain_and_pallas(p, dup, E):
    """The kernel's search (tests/torch_parity.py's replay), the plain
    version and the Pallas kernel on the edge rows of make_match_edge_case:
    counts around both run lengths, poly-T and saturated rb, a slice of
    several runs with its best entry in a middle one, queries below and
    above every entry, random words past cnt in hi and lo."""
    case = make_match_edge_case(p, E, dup=dup, seed=3)
    want = seed_match_pallas(*case, p=p, k=K, tile_m=case[0].shape[0], interpret=True)
    args = seed_match_torch(*case)
    plain = SM.seed_match_plain(*args, p, K)
    replay = seed_match_replay(*args, p, K)
    for w, a, b in zip(want, plain, replay[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
        np.testing.assert_array_equal(b.numpy(), np.asarray(w))
    nh, lcp = plain[0].numpy(), plain[2].numpy()
    assert nh[0] == min(3, E) and lcp[0] > 0  # poly-T
    if E >= 3 * 2 * SM.MATCH_RUN:  # the long-run rows span more than two runs
        assert (nh[12:15] > 2 * SM.MATCH_RUN).all() and (lcp[12:15] > 16).all()
    if E >= 2:  # rows 15 and 16 reach their slice's first and last entry
        assert (nh[15:17] > 0).all() and (lcp[15:17] > 16).all()
    assert replay[4].numel() > 0  # lo words were read


@pytest.mark.parametrize("E", [128, 2048])
@pytest.mark.parametrize("dup", [False, True], ids=["distinct_hi", "duplicate_hi"])
@pytest.mark.parametrize("p", [11, 15, 16])
def test_replay_reads_fewer_sectors_than_three_bisections(p, dup, E):
    """The kernel's search reads fewer hi and lo sectors than three
    bisections and two neighbour reads (chip_smoke.match_replay_bytes) on
    seed_match_case, and no lo word of a row without hits."""
    from chip_smoke import SECTOR, match_replay_bytes

    hi, lo, cnt, qh, ql, has = seed_match_case(seed=p, E=E, dup=dup)
    args = seed_match_torch(hi, lo, cnt, qh, ql, has)
    nh, _, _, hi_sec, lo_sec = seed_match_replay(*args, p, K)
    kmers = torch.from_numpy((hi.astype(np.int64) << 30) | (lo.astype(np.int64) >> 2))
    q = torch.from_numpy((qh.astype(np.int64) << 30) | (ql.astype(np.int64) >> 2))
    three, _ = match_replay_bytes(kmers, torch.from_numpy(cnt), q, torch.from_numpy(has), p)
    design = (hi_sec.numel() + lo_sec.numel()) * SECTOR
    assert design < three
    rows = torch.unique(lo_sec * 8 // E)  # the rows whose lo words were read
    assert bool((nh[rows] > 0).all())
