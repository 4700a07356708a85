"""The port's seed-locate kernel wrapper and plain twin vs the JAX package's
Pallas kernel (interpret mode on the CPU).  All outputs are integer counts,
so every comparison is exact."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from torch_parity import (
    locate_batch_replay,
    locate_single_replay,
    make_case,
    make_edge_case,
    to_torch,
)

from lexicmap_tpu.parallel.pallas_kernels import seed_locate_batch_pallas, seed_locate_pallas
from lexicmap_tpu_torch.kernels import seed_locate as SL


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("p", [11, 15, 16])
def test_plain_equals_pallas(p, B):
    hi, cnt, qh, qv = make_case(p, B)
    M = hi.shape[0]
    nh_ref, e0_ref = seed_locate_batch_pallas(
        hi, cnt, qh, qv.astype(np.int32), p=p, tile_m=M, interpret=True
    )
    nh, e0 = SL.seed_locate_batch_plain(*to_torch(hi, cnt, qh, qv), p)
    assert nh.dtype == torch.int32 and e0.dtype == torch.int32
    np.testing.assert_array_equal(nh.numpy(), np.asarray(nh_ref))
    np.testing.assert_array_equal(e0.numpy(), np.asarray(e0_ref))
    assert (nh.numpy()[:, 0] == 3).all() and (nh.numpy()[:, 1] == 2).all()
    assert nh.numpy().sum() > 2 * B  # the sampled queries do hit


@pytest.mark.parametrize("row, want_n", [(0, 3), (1, 2)], ids=["polyT16", "polyT15_saturated"])
def test_polyT_rows_exact(row, want_n):
    """(a) a query whose first 16 bases are T (qhi == 0xFFFFFFFF) still
    matches; (b) a 15-T query saturates rb and must not count padding."""
    hi, cnt, qh, qv = make_case(15, 2)
    nh, e0 = SL.seed_locate_batch(*to_torch(hi, cnt, qh, qv), 15)
    assert nh[:, row].tolist() == [want_n, want_n]
    assert e0[:, row].tolist() == [0, 0]


def test_plain_chunking_is_invisible():
    """The plain version's row chunking must not change its answer."""
    args = to_torch(*make_case(13, 4))
    whole = SL.seed_locate_batch_plain(*args, 13)
    tiny = SL.seed_locate_batch_plain(*args, 13, max_elems=1)
    assert torch.equal(whole[0], tiny[0]) and torch.equal(whole[1], tiny[1])


@pytest.mark.parametrize("p", [11, 15, 16])
def test_cpu_wrapper_equals_plain(p):
    args = to_torch(*make_case(p, 5, seed=1))
    before = SL.seed_locate_batch.launches
    nh, e0 = SL.seed_locate_batch(*args, p)
    pn, pe = SL.seed_locate_batch_plain(*args, p)
    assert torch.equal(nh, pn) and torch.equal(e0, pe)
    assert SL.seed_locate_batch.launches == before  # the CPU path launches nothing


@pytest.mark.parametrize("which, dtype", [
    (0, torch.int64), (1, torch.int64), (2, torch.uint8), (3, torch.int32),
])
def test_wrapper_rejects_dtype(which, dtype):
    args = list(to_torch(*make_case(15, 2)))
    args[which] = args[which].to(dtype)
    with pytest.raises(TypeError):
        SL.seed_locate_batch(*args, 15)


@pytest.mark.parametrize("which", ["table_1d", "cnt_len", "query_width", "valid_shape"])
def test_wrapper_rejects_shape(which):
    hi, cnt, qh, qv = to_torch(*make_case(15, 2))
    if which == "table_1d":
        hi = hi.reshape(-1)
    elif which == "cnt_len":
        cnt = cnt[:-1]
    elif which == "query_width":
        qh = qh[:, :-1]
    else:
        qv = qv[:1]
    with pytest.raises(ValueError):
        SL.seed_locate_batch(hi, cnt, qh, qv, 15)


@pytest.mark.parametrize("p", [0, 17])
def test_wrapper_rejects_prefix(p):
    with pytest.raises(ValueError):
        SL.seed_locate_batch(*to_torch(*make_case(15, 1)), p)


@pytest.mark.parametrize("p", [11, 15, 16])
def test_single_plain_equals_pallas(p):
    """B2: the single-query plain version vs seed_locate_pallas at M = 256,
    poly-T and saturated-rb rows included."""
    hi, cnt, qh, qv = make_case(p, 1, M=256, seed=3)
    nh_ref, e0_ref = seed_locate_pallas(hi, cnt, qh[0], qv[0].astype(np.int32), p=p,
                                        tile_m=256, interpret=True)
    t_hi, t_cnt, t_qh, t_qv = to_torch(hi, cnt, qh, qv)
    nh, e0 = SL.seed_locate_plain(t_hi, t_cnt, t_qh[0], t_qv[0], p)
    np.testing.assert_array_equal(nh.numpy(), np.asarray(nh_ref))
    np.testing.assert_array_equal(e0.numpy(), np.asarray(e0_ref))
    assert nh[0] == 3 and nh[1] == 2 and int((nh > 0).sum()) > 20
    before = SL.seed_locate.launches
    wn, we = SL.seed_locate(t_hi, t_cnt, t_qh[0].contiguous(), t_qv[0].contiguous(), p)
    assert torch.equal(wn, nh) and torch.equal(we, e0)
    assert SL.seed_locate.launches == before  # the CPU path launches nothing


@pytest.mark.parametrize("which", ["query_2d", "query_len", "dtype"])
def test_single_wrapper_rejects(which):
    hi, cnt, qh, qv = to_torch(*make_case(15, 1))
    qh, qv = qh[0], qv[0]
    if which == "query_2d":
        qh = qh[None]
    elif which == "query_len":
        qv = qv[:-1]
    else:
        qh = qh.to(torch.int64)
    with pytest.raises((TypeError, ValueError)):
        SL.seed_locate(hi, cnt, qh, qv, 15)


# the kernels' design (csrc/seed_locate.cu), replayed on tensors by
# tests/torch_parity.py: both B1 regimes around their threshold, the B2
# search (its top head, a bisection of the heads, a run read whole), and
# the edge rows (counts 0,
# 1, S - 1, S, S + 1, E; long runs; non-PAD words past cnt)
EDGE = [
    (128, 33, 1),
    (SL.SMALL_MAX_E - 128, 7, 11),
    (SL.SMALL_MAX_E + 128, 32, 15),
    (SL.SMALL_MAX_E + 128, 33, 1),
    (16384, 1, 16),
    (16384, 33, 11),
]


@pytest.mark.parametrize("E, B, p", EDGE)
def test_replay_equals_plain_and_pallas(E, B, p):
    hi, cnt, qh, qv = make_edge_case(p, B, E)
    M = hi.shape[0]
    nh_ref, e0_ref = seed_locate_batch_pallas(
        hi, cnt, qh, qv.astype(np.int32), p=p, tile_m=M, interpret=True
    )
    args = to_torch(hi, cnt, qh, qv)
    pn, pe = SL.seed_locate_batch_plain(*args, p)
    np.testing.assert_array_equal(pn.numpy(), np.asarray(nh_ref))
    np.testing.assert_array_equal(pe.numpy(), np.asarray(e0_ref))
    nh, e0, _ = locate_batch_replay(*args, p)
    assert torch.equal(nh, pn) and torch.equal(e0, pe)
    assert nh[:, 0].tolist() == [3] * B and nh[:, 1].tolist() == [2] * B
    assert int((nh[:, 6:13] > 0).sum()) > 0  # the drawn queries of the edge rows hit

    s_ref = seed_locate_pallas(hi, cnt, qh[0], qv[0].astype(np.int32), p=p, tile_m=M,
                               interpret=True)
    sn, se, _ = locate_single_replay(args[0], args[1], args[2][0], args[3][0], p)
    np.testing.assert_array_equal(sn.numpy(), np.asarray(s_ref[0]))
    np.testing.assert_array_equal(se.numpy(), np.asarray(s_ref[1]))


@pytest.mark.parametrize("p", [1, 13])
@pytest.mark.parametrize("E", [SL.SMALL_MAX_E - 2, SL.SMALL_MAX_E, SL.SMALL_MAX_E + 4, 16384])
def test_batch_replay_regimes_equal_plain(E, p):
    """Both regimes on either side of their threshold (E = SMALL_MAX_E - 2
    staged word by word), at p = 1 (rb's interval far from lb's) and 13."""
    args = to_torch(*make_edge_case(p, 33, E, seed=5))
    pn, pe = SL.seed_locate_batch_plain(*args, p)
    nh, e0, _ = locate_batch_replay(*args, p)
    assert torch.equal(nh, pn) and torch.equal(e0, pe)


@pytest.mark.parametrize("p", [1, 11, 16])
@pytest.mark.parametrize("E", [5, 128, 16384, 16376])
def test_single_replay_equals_plain(E, p):
    """E = 5 puts the top head on the first entry, and E = 5 and 16,376
    leave a last run shorter than the others (read word by word, never past
    cnt)."""
    hi, cnt, qh, qv = to_torch(*make_edge_case(p, 1, E, seed=6))
    pn, pe = SL.seed_locate_plain(hi, cnt, qh[0], qv[0], p)
    nh, e0, _ = locate_single_replay(hi, cnt, qh[0], qv[0], p)
    assert torch.equal(nh, pn) and torch.equal(e0, pe)


def test_replay_sector_counts():
    """With no valid query the design reads only the sample (sampled rows),
    the staged rows or the single-query search's top head: one sector per
    pivot once the stride passes 8 words, ceil(words / 8) per staged row,
    one sector per row."""
    E, S = 16384, SL.SAMPLE
    hi, cnt, qh, qv = to_torch(*make_edge_case(15, 4, E, seed=7))
    none = torch.zeros_like(qv)
    _, _, sectors = locate_batch_replay(hi, cnt, qh, none, 15)
    n = cnt.long()
    s = torch.where(n > S, (n + S - 1) // S, 1)
    pivots = (n + s - 1) // s
    dense = s < 8  # pivots closer than a sector share sectors
    assert not bool(dense[n > 8 * S].any())
    assert sectors.numel() >= int(pivots[~dense].sum())
    assert sectors.numel() <= int(pivots.sum())
    small = hi[:, :256].contiguous()
    _, _, staged = locate_batch_replay(small, cnt.clamp(max=256), qh, none, 15)
    assert staged.numel() == int(((cnt.clamp(max=256).long() + 7) // 8).sum())
    _, _, single = locate_single_replay(hi, cnt, qh[0], none[0], 15)
    assert single.numel() == hi.shape[0]


@pytest.mark.parametrize("p", [11, 15])
def test_design_reads_fewer_sectors_than_bisection(p):
    """lb's and rb's searches share their probes while their intervals are
    one, so the design reads fewer sectors than two bisections run one
    after the other (rb's from lb's answer): on full rows of 16,384 at B =
    32 at most two thirds.  The single-query kernel also reads its top head
    in every row, whatever the query (a full row's first bisection probe,
    but not that of a shorter row or of a row without a valid query): at
    most two thirds plus that sector a row."""
    from chip_smoke import bisection_probe_bytes

    hi, cnt, qh, qv = to_torch(*make_edge_case(p, 32, 16384, M=48, seed=9))
    hi64 = hi.long() & 0xFFFFFFFF
    bound, _ = bisection_probe_bytes(hi64, cnt, qh, qv, p)
    _, _, design = locate_batch_replay(hi, cnt, qh, qv, p)
    assert design.numel() * 32 <= bound * 2 // 3
    bound1, _ = bisection_probe_bytes(hi64, cnt, qh[:1], qv[:1], p)
    _, _, design1 = locate_single_replay(hi, cnt, qh[0], qv[0], p)
    assert design1.numel() * 32 <= bound1 * 2 // 3 + hi.shape[0] * 32
