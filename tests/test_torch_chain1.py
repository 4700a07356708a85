"""The chain1 forward DP (B9) on the CPU: the port's gap-score table, the
kernel's plain twin, a numpy replay of the kernel's warp scan and the
port's DeviceChainer against the native DP (float32 bits and indices) and
the JAX package's DeviceChainer (JAX on its CPU backend)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from torch_parity import CHAIN1_PARAMS, chain1_csr, chain1_replay, chain1_sets
from torch_parity import one_intra_op_thread  # noqa: F401  (autouse fixture)
from torch_parity import rec  # noqa: F401  (fixture)

from lexicmap_tpu.parallel.chain_device import DeviceChainer as JaxChainer
from lexicmap_tpu.parallel.chain_device import gap_score_table as jax_gap_score_table
from lexicmap_tpu_torch.kernels import chain1 as C1
from lexicmap_tpu_torch.native import chain1_forward_native
from lexicmap_tpu_torch.parallel import chain_device as CD

MG, MSC, MD = CHAIN1_PARAMS


def bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def native(s):
    return chain1_forward_native(*s, MG, MSC, MD)


@pytest.fixture(scope="module")
def sets():
    return chain1_sets()


@pytest.fixture(scope="module")
def jax_out(sets):
    return JaxChainer(MG, MSC, MD).chain_batch(sets)


@pytest.mark.parametrize("max_gap", [0.0, 1.0, 50.0, 50.5, 5000.0])
def test_gap_score_table_equals_jax(max_gap):
    got = CD.gap_score_table(max_gap)
    assert got.dtype == np.float32
    assert np.array_equal(bits(got), bits(jax_gap_score_table(max_gap)))


def test_plain_equals_native_and_jax(sets, jax_out):
    gtab = torch.from_numpy(CD.gap_score_table(MG))
    qb, tb, ln, off = chain1_csr(sets)
    ms, prev, dirs, flags = C1.chain1_forward(qb, tb, ln, off, gtab, MG, MSC, MD)
    assert ms.dtype == torch.float32 and prev.dtype == torch.int32 and dirs.dtype == torch.int8
    assert not flags.any()
    o = off.tolist()
    n_jax = 0
    for g, s in enumerate(sets):
        a, b = o[g], o[g + 1]
        w_ms, w_prev, w_dirs = native(s)
        assert np.array_equal(bits(ms[a:b].numpy()), bits(w_ms)), g
        assert np.array_equal(prev[a:b].numpy(), w_prev) and np.array_equal(dirs[a:b].numpy(), w_dirs)
        kind, fwd = jax_out[g]
        if kind == "ok":
            n_jax += 1
            assert np.array_equal(bits(ms[a:b].numpy()), bits(fwd[0]))
            assert np.array_equal(prev[a:b].numpy(), fwd[1]) and np.array_equal(dirs[a:b].numpy(), fwd[2])
    # JAX flags the dense set (window truncation) and the one past 8,192
    assert n_jax == len(sets) - 2


@pytest.mark.parametrize("warps", [1, 4])
@pytest.mark.parametrize("which", range(10))
def test_kernel_replay_equals_native(sets, which, warps):
    """The kernel's scan, replayed in numpy on its warp path and its block
    path, on every set: those the JAX package flags too (its dense set and
    the one of 9,000 anchors)."""
    s = sets[which]
    ms, prev, dirs, flag, counts = chain1_replay(*s, CD.gap_score_table(MG), MG, MSC, MD, warps)
    w_ms, w_prev, w_dirs = native(s)
    assert flag == 0
    assert np.array_equal(bits(ms), bits(w_ms))
    assert np.array_equal(prev, w_prev) and np.array_equal(dirs, w_dirs)
    n = s[0].shape[0]
    assert n - 1 <= counts["visits"] and counts["rounds"] <= counts["chunks"]
    assert counts["visits"] <= counts["chunks"] * 32 < counts["visits"] + 32 * (n - 1)


def test_smoke_visit_count_equals_replay(sets):
    """chip_smoke.py's count of the native scan's predecessor visits (B9's
    bound) equals the kernel replay's, on both paths."""
    from chip_smoke import chain1_visits

    gt = CD.gap_score_table(MG)
    got = [chain1_visits([s], MD) for s in sets[:9]]
    for warps in (1, 4):
        assert got == [chain1_replay(*s, gt, MG, MSC, MD, warps)[4]["visits"] for s in sets[:9]]


def test_replay_schedule_counts(sets):
    """The two paths' schedules on the dense set (1,500 anchors in 900 bp,
    every earlier anchor within max_dist): the warp path scans a step's
    chunks two an iteration and reads the predecessors older than its ring
    of 512 from global memory; the block path takes four chunks a round
    and keeps all of them in its ring of 2,048."""
    s = sets[7]
    n = s[0].shape[0]
    gt = CD.gap_score_table(MG)
    one = chain1_replay(*s, gt, MG, MSC, MD, 1)[4]
    four = chain1_replay(*s, gt, MG, MSC, MD, 4)[4]
    steps = [-(-i // 32) for i in range(1, n)]  # no break: every chunk of every step
    assert one["chunks"] == sum(steps)
    assert one["rounds"] == sum(-(-c // 2) for c in steps)
    assert four["rounds"] == sum(-(-c // 4) for c in steps)
    assert four["chunks"] == one["chunks"]
    assert one["past_ring"] == sum(max(0, i - 512) for i in range(1, n))
    assert four["past_ring"] == 0
    assert one["visits"] == four["visits"] == n * (n - 1) // 2


@pytest.mark.parametrize("warps", [1, 4])
def test_replay_unsorted_breaks_mid_window(warps):
    """Anchors out of QBegin order: the first predecessor past max_dist
    (descending j) can fall in any chunk and round, with nearer ones
    behind it that the native scan never reaches.  Both paths stop where
    it does."""
    rng = np.random.default_rng(11)
    n = 700
    qb = rng.integers(0, 1500, n).astype(np.int32)
    qb[rng.random(n) < 0.02] += 5000  # far anchors that break the scans after them
    tb = (qb + rng.integers(-40, 40, n)).astype(np.int32)
    s = (qb, tb, rng.integers(15, 32, n).astype(np.int32))
    ms, prev, dirs, flag, counts = chain1_replay(*s, CD.gap_score_table(MG), MG, MSC, MD, warps)
    w_ms, w_prev, w_dirs = native(s)
    assert np.array_equal(bits(ms), bits(w_ms))
    assert np.array_equal(prev, w_prev) and np.array_equal(dirs, w_dirs)
    assert counts["visits"] < n * (n - 1) // 2


@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_schedule_block_threshold(offset):
    """schedule(): genomes longest first; those of at least BLOCK_MIN
    anchors (here one at BLOCK_MIN + offset) take the block path."""
    sizes = [5, C1.BLOCK_MIN + offset, 0, 2 * C1.BLOCK_MIN, 700, 2]
    off = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(sizes, out=off[1:])
    order, n_block = C1.schedule(off)
    assert order.dtype == np.int32
    assert [sizes[g] for g in order] == sorted(sizes, reverse=True)
    assert n_block == (2 if offset >= 0 else 1)


def test_device_chainer_equals_native_and_jax(sets, jax_out, rec):
    dc = CD.DeviceChainer(MG, MSC, MD, device="cpu")
    short = [tuple(a[:1] for a in sets[0]), tuple(a[:0] for a in sets[0])]
    launches = C1.chain1_forward.launches
    got = dc.chain_batch(sets + short)
    assert [k for k, _ in got] == ["ok"] * len(sets) + ["host", "host"]
    assert (rec.totals["chain.genomes"], rec.totals["chain.flagged_genomes"]) == (len(sets), 0)
    assert C1.chain1_forward.launches == launches  # the plain version on the CPU
    for s, (_, fwd), (jk, jf) in zip(sets, got, jax_out):
        w = native(s)
        assert fwd[1].dtype == np.int64 and fwd[2].dtype == np.int8
        assert np.array_equal(bits(fwd[0]), bits(w[0]))
        assert np.array_equal(fwd[1], w[1]) and np.array_equal(fwd[2], w[2])
        if jk == "ok":
            assert all(np.array_equal(a, b) for a, b in zip(fwd[1:], jf[1:]))


def test_gap_past_table_flags_genome(sets, monkeypatch, rec):
    """A gap within max_gap that the table does not hold sends the genome to
    the host (F_GAP_TABLE); the others are answered."""
    monkeypatch.setattr(CD, "GTAB_MAX", 3)
    dc = CD.DeviceChainer(MG, MSC, MD, device="cpu")
    tiny = [tuple(a[:2] for a in sets[0])]
    got = dc.chain_batch(sets[:3] + tiny)
    assert rec.totals["chain.flagged_genomes"] >= 1
    assert rec.totals["chain.genomes"] == 4
    assert rec.totals["chain.flagged_genomes"] == sum(k == "host" for k, _ in got)
    for s, (k, fwd) in zip(sets[:3] + tiny, got):
        if k == "ok":
            assert np.array_equal(bits(fwd[0]), bits(native(s)[0]))


def test_wrapper_checks():
    qb, tb, ln, off = chain1_csr(chain1_sets(big=0)[:2])
    gtab = torch.from_numpy(CD.gap_score_table(MG))
    with pytest.raises(TypeError):
        C1.chain1_forward(qb.long(), tb, ln, off, gtab, MG, MSC, MD)
    with pytest.raises(ValueError):
        C1.chain1_forward(qb, tb[:-1], ln, off, gtab, MG, MSC, MD)
    with pytest.raises(ValueError):
        C1.chain1_forward(qb, tb, ln, off, gtab[:0], MG, MSC, MD)
    empty = C1.chain1_forward(qb[:0], tb[:0], ln[:0], off[:1], gtab, MG, MSC, MD)
    assert [t.shape[0] for t in empty] == [0, 0, 0, 0]


def test_device_chainer_one_upload_one_fetch(sets, monkeypatch, rec):
    """chain_batch sends the columns, the genome order and the offsets up
    in one copy and brings the four outputs back in one: one wait on the
    card."""
    dc = CD.DeviceChainer(MG, MSC, MD, device="cpu")
    ups = []
    real = torch.from_numpy

    def spy(a):
        ups.append(a.nbytes)
        return real(a)

    monkeypatch.setattr(CD.torch, "from_numpy", spy)
    dc.chain_batch(sets[:4])
    N = sum(s[0].shape[0] for s in sets[:4])
    assert rec.counts["card_wait"] == 1
    # int32 columns and order, the int64 offsets at an even int32 index
    assert ups == [4 * ((3 * N + 4 + 1) // 2 * 2 + 2 * 5)]
