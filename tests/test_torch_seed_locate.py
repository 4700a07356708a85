"""The port's seed-locate kernel wrapper and plain twin vs the JAX package's
Pallas kernel (interpret mode on the CPU).  All outputs are integer counts,
so every comparison is exact."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from torch_parity import make_case, to_torch

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
