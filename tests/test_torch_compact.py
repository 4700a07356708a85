"""B4, the seed matcher's compaction (kernels/seed_compact.py): its plain
version on the CPU against the JAX package's DeviceSeedMatcher (Pallas in
interpret mode), the host bisection and the host sort and merge, on the
fixtures of tests/test_torch_device_search.py.  Triples are integers: every
comparison is exact.  The CUDA kernel against the plain version on random
inputs is the `cuda` test at the end (skipped without a card); through the
matcher, on the card, in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_torch_device_search import db, jax_matcher, port_idx, query_batch  # noqa: F401
from torch_parity import host_triples, one_intra_op_thread, seed_compact_case  # noqa: F401
from torch_parity import split_triples

from lexicmap_tpu.parallel import device_search as jds
from lexicmap_tpu_torch.kernels import seed_compact as SC
from lexicmap_tpu_torch.parallel import device_search as tds

# a ~16,000-byte budget: with E_CAP = 4 and buckets of E = 1, 2, 4, the E = 4
# bucket is cut inside, so one mask's chunk rows lie on both tiers
BUDGET = 16_000
SHAPES = ("default", "chunked", "host_tier", "chunked_host_tier")


def listed(triples):
    return [[a.tolist() for a in t] for t in triples]


def chunked(monkeypatch):
    """Rows of at most 4 entries in buckets of E = 1, 2 and 4, so that the
    last chunk of a mask mostly lies in another bucket than the ones before
    it (the JAX matcher chunks alike, in one bucket)."""
    monkeypatch.setattr(tds, "E_CAP", 4)
    monkeypatch.setattr(jds, "E_CAP", 4)
    monkeypatch.setattr(tds, "bucket_edges_for", lambda counts, cap=None: [1, 2, 4])


def matchers(shape, db, port_idx, monkeypatch):
    if shape.startswith("chunked"):
        chunked(monkeypatch)
    budget = BUDGET if shape.endswith("host_tier") else None
    pm = tds.DeviceSeedMatcher(port_idx, device="cpu", hbm_budget=budget)
    jm = jax_matcher(db, monkeypatch, budget) if budget else jax_matcher(db)
    return pm, jm


def device_chunks(pm):
    """(mask, base, cnt, bucket) of the matcher's device rows."""
    return [(int(g), int(b), int(c), k) for k, bk in enumerate(pm.buckets)
            for g, b, c in zip(bk.gids.tolist(), bk.base.tolist(), bk.cnt.tolist())]


def spans(triples, chunks):
    """How many triples cover entries of chunk rows of more than one tag,
    over `chunks` (mask, base, cnt, tag)."""
    by_mask = {}
    for g, b, c, tag in chunks:
        by_mask.setdefault(g, []).append((b, c, tag))
    n = 0
    for hm, e0, nh in triples:
        for g, s, k in zip(hm.tolist(), e0.tolist(), nh.tolist()):
            n += len({tag for b, c, tag in by_mask.get(g, ()) if b < s + k and s < b + c}) > 1
    return n


@pytest.mark.parametrize("p", [7, 15])
@pytest.mark.parametrize("shape", SHAPES)
def test_compaction_matches_jax_and_bisection(db, port_idx, monkeypatch, shape, p):
    """match_batch (B1's plain version, then the plain compaction) == the
    JAX matcher == the host bisection.  At p = 7 ranges cover many entries
    of a mask, so hits cross chunk rows; with `chunked` those runs cross
    buckets, with `host_tier` the device's triples join the host tier's."""
    pm, jm = matchers(shape, db, port_idx, monkeypatch)
    batch = query_batch(port_idx, db[1], 1)
    got = pm.match_batch(batch, p)
    want = jm.match_batch(batch, p)
    for b in range(batch.shape[0]):
        host = host_triples(port_idx, batch[b], p)
        assert listed([got[b]]) == listed([host])
        if want[b] is not None:  # None: over the JAX matcher's hit capacity
            assert listed([got[b]]) == listed([want[b]])
        assert all(a.dtype == np.int64 for a in got[b])
    assert sum(g[0].shape[0] for g in got) > 0
    if shape.endswith("host_tier"):
        assert pm.host_rows > 0 and pm.buckets
    else:
        assert pm.host_rows == 0
    if shape.startswith("chunked") and p == 7:
        dev = device_chunks(pm)
        # runs of chunk rows merged on the card, across buckets
        assert spans(got, dev) > 0
        if shape == "chunked_host_tier":
            host = [(int(g), int(s), int(e - s0), "host") for g, s, s0, e in zip(
                pm._ht_mi, pm._ht_start, pm._ht_off[:-1], pm._ht_off[1:])]
            on_card = [(g, b, c, "card") for g, b, c, _ in dev]
            assert spans(got, host + on_card) > 0  # a run over both tiers


def test_chunked_rows_cross_buckets(db, port_idx, monkeypatch):
    """The chunked layout really puts consecutive chunks of a mask in
    different buckets, and the row order marks them as continuing."""
    chunked(monkeypatch)
    pm = tds.DeviceSeedMatcher(port_idx, device="cpu")
    o = pm.order
    assert len(pm.buckets) == 3
    bucket = np.searchsorted(o.starts.numpy(), o.perm.numpy(), "right") - 1
    cont = o.cont.numpy().astype(bool)
    assert (cont[1:] & (bucket[1:] != bucket[:-1])).any()
    assert not cont[0]
    gid, base = o.gid.numpy(), o.base.numpy()
    assert np.all((gid[1:] > gid[:-1]) | ((gid[1:] == gid[:-1]) & (base[1:] > base[:-1])))


@pytest.mark.parametrize("shape", ["default", "chunked"])
def test_queries_without_kmers(db, port_idx, monkeypatch, shape):
    """A query with no k-mer gives three empty int64 arrays; one with half
    its masks empty gives the bisection's triples of the other half."""
    pm, _ = matchers(shape, db, port_idx, monkeypatch)
    batch = query_batch(port_idx, db[1], 2)
    batch[0] = 0
    batch[2, ::2] = 0
    got = pm.match_batch(batch, 7)
    assert [a.shape[0] for a in got[0]] == [0, 0, 0]
    assert all(a.dtype == np.int64 for a in got[0])
    for b in range(1, batch.shape[0]):
        assert listed([got[b]]) == listed([host_triples(port_idx, batch[b], 7)])
    none = pm.match_batch(np.zeros_like(batch), 7)
    assert all(a.shape[0] == 0 for t in none for a in t)


@pytest.mark.parametrize("shape", ["default", "chunked", "chunked_host_tier"])
def test_single_query_match(db, port_idx, monkeypatch, shape):
    """B = 1 through `match` (the single-query B1, then the compaction at
    B = 1) == match_batch's row == the host bisection."""
    pm, _ = matchers(shape, db, port_idx, monkeypatch)
    batch = query_batch(port_idx, db[1], 3)
    batched = pm.match_batch(batch, 7)
    for b in range(batch.shape[0]):
        one = pm.match(batch[b], 7)
        assert listed([one]) == listed([batched[b]])
        assert listed([one]) == listed([host_triples(port_idx, batch[b], 7)])


@pytest.mark.parametrize("shape", ["default", "chunked"])
def test_no_host_sort_without_host_rows(db, port_idx, monkeypatch, shape):
    """With every row on the device, match_batch and match run neither
    np.lexsort nor the host merge: the compaction's order is the output's."""
    pm, _ = matchers(shape, db, port_idx, monkeypatch)
    assert pm.host_rows == 0
    batch = query_batch(port_idx, db[1], 4)
    want = [host_triples(port_idx, batch[b], 7) for b in range(batch.shape[0])]

    def refuse(*a, **k):
        raise AssertionError("the host sorted or merged")

    monkeypatch.setattr(np, "lexsort", refuse)
    monkeypatch.setattr(tds, "sort_merge", refuse)
    assert listed(pm.match_batch(batch, 7)) == listed(want)
    assert listed([pm.match(batch[0], 7)]) == listed(want[:1])


def hit_rows(stacked, B, order):
    """The unmerged (query, mask, e0 + base, n_hits) of every hit row."""
    starts = order.starts.tolist()
    st = stacked.numpy()
    qb, hm, e0, nh = [], [], [], []
    gid, base, perm = order.gid.numpy(), order.base.numpy(), order.perm.numpy()
    at = np.argsort(perm)  # global row -> ordered row
    for s0, s1 in zip(starts[:-1], starts[1:]):
        blk = st[2 * B * s0: 2 * B * s1].reshape(2, B, s1 - s0)
        b, r = np.nonzero(blk[0] > 0)
        i = at[s0 + r]
        qb.append(b)
        hm.append(gid[i])
        e0.append(blk[1][b, r] + base[i])
        nh.append(blk[0][b, r])
    return [np.concatenate(x).astype(np.int64) for x in (qb, hm, e0, nh)]


@pytest.mark.parametrize("B, n_masks, n_buckets, e_cap, hit_rate", [
    (1, 40, 1, 8, 0.5), (5, 300, 3, 8, 0.5), (8, 500, 4, 3, 0.7), (3, 50, 2, 64, 0.3),
    (33, 200, 3, 5, 0.9), (4, 30, 2, 8, 0.0)])
def test_plain_compaction_random(B, n_masks, n_buckets, e_cap, hit_rate):
    """The plain compaction on B1-shaped outputs of random chunked masks
    spread over buckets == the ranges they were made from == the host sort
    and merge of the unmerged hit rows."""
    stacked, order, want = seed_compact_case(B, n_masks, seed=B + n_masks, e_cap=e_cap,
                                             n_buckets=n_buckets, hit_rate=hit_rate)
    offsets, triples = SC.seed_compact(stacked, B, order)  # CPU tensors: the plain version
    assert offsets.dtype == triples.dtype == torch.int64 and triples.shape[0] == 3
    assert int(offsets[-1]) == triples.shape[1]
    got = split_triples(offsets, triples)
    assert listed(got) == listed(want)
    assert listed(tds.sort_merge(B, *hit_rows(stacked, B, order))) == listed(want)


def test_plain_compaction_checks_its_inputs():
    stacked, order, _ = seed_compact_case(2, 20)
    with pytest.raises(ValueError, match="stacked must be"):
        SC.seed_compact(stacked[:-2], 2, order)
    with pytest.raises(TypeError, match="int32"):
        SC.seed_compact(stacked.to(torch.int64), 2, order)
    bad = SC.RowOrder(order.starts, order.perm, order.cont.bool(), order.gid, order.base)
    with pytest.raises(TypeError, match="cont"):
        SC.seed_compact(stacked, 2, bad)
    with pytest.raises(ValueError, match="at most"):
        SC.row_order([np.zeros(1, np.int64)] * 33, [np.zeros(1, np.int64)] * 33,
                     [np.ones(1, np.int64)] * 33, "cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B, n_masks, n_buckets, e_cap, hit_rate", [
    (1, 40, 1, 8, 0.5), (32, 3000, 4, 16, 0.5), (33, 200, 3, 5, 0.9), (4, 30, 2, 8, 0.0),
    (2, 20000, 32, 8, 0.3), (32, 5, 2, 3, 1.0)])
def test_cuda_seed_compact_equals_plain(cuda_device, B, n_masks, n_buckets, e_cap, hit_rate):
    """The kernel == its plain version == the ranges the inputs were made
    from, on random B1-shaped outputs of chunked masks spread over one to
    MAX_BUCKETS buckets: B = 1 to 33, no hit at all, every cell a hit,
    ordered rows over many warps' spans."""
    stacked, order, want = seed_compact_case(B, n_masks, seed=B + n_masks, e_cap=e_cap,
                                             n_buckets=n_buckets, hit_rate=hit_rate,
                                             device=cuda_device)
    before = SC.seed_compact.launches
    got = SC.seed_compact(stacked, B, order)
    torch.cuda.synchronize()
    assert SC.seed_compact.launches == before + 1
    plain = SC.seed_compact_plain(stacked, B, order)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    assert listed(split_triples(*got)) == listed(want)
