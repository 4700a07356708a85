"""B4, the seed matcher's compaction (kernels/seed_compact.py): its plain
version on the CPU against the JAX package's DeviceSeedMatcher (Pallas in
interpret mode), the host bisection and the host sort and merge, on the
fixtures of tests/test_torch_device_search.py; the row order's address
table against the bucket walk; the cases whose runs cross the kernel's
warps' spans and blocks' tiles.  Triples are integers: every comparison is
exact.  The CUDA kernel against the plain version (random inputs, runs over
units, back-to-back calls, a side stream) is the `cuda` tests at the end
(skipped without a card); through the matcher, on the card, in
tests/test_torch_cuda.py."""

import dataclasses

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
    with pytest.raises(TypeError, match="cont"):
        SC.seed_compact(stacked, 2, dataclasses.replace(order, cont=order.cont.bool()))
    with pytest.raises(TypeError, match="src"):
        SC.seed_compact(stacked, 2, dataclasses.replace(order, src=order.src.long()))
    with pytest.raises(ValueError, match="src"):
        SC.seed_compact(stacked, 2, dataclasses.replace(order, src=order.src[:, :1]))


def bucket_walk(order):
    """Each ordered row's (first global row, rows) of its bucket, by walking
    the bucket starts (what the kernel did before RowOrder.src)."""
    st = order.starts.tolist()
    out = []
    for g in order.perm.tolist():
        k = 0
        while g >= st[k + 1]:
            k += 1
        out.append((st[k], st[k + 1] - st[k]))
    return np.array(out, dtype=np.int32).reshape(-1, 2)


@pytest.mark.parametrize("n_buckets", [*range(1, 33), 64])
def test_row_order_address_table(n_buckets):
    """RowOrder.src == the bucket walk, for 1 to 32 buckets (the most the
    kernel took before the table) and past them; the address it gives,
    2 B s0 + b Mb + (perm - s0), holds each ordered row's n_hits, and Mb B
    past it its e0."""
    B = 3
    stacked, order, _ = seed_compact_case(B, 300, seed=n_buckets, n_buckets=n_buckets)
    assert order.starts.shape[0] - 1 == n_buckets
    src = order.src.numpy()
    assert src.dtype == np.int32 and src.shape == (order.perm.shape[0], 2)
    assert np.array_equal(src, bucket_walk(order))
    nh, e0 = SC._triples(stacked, B, order)
    st, g = stacked.numpy(), order.perm.numpy().astype(np.int64)
    s0, mb = src[:, 0].astype(np.int64), src[:, 1].astype(np.int64)
    at = 2 * B * s0[None, :] + np.arange(B)[:, None] * mb[None, :] + (g - s0)[None, :]
    assert np.array_equal(st[at], nh.numpy())
    assert np.array_equal(st[at + B * mb[None, :]], e0.numpy())


def unit_crossings(order, triples, rows=SC.SPAN):
    """How many triples run over the ordered rows of two of the kernel's
    units of `rows` rows (a warp's SPAN, or a block's TILE) of their query."""
    key = order.gid.cpu().numpy() * (1 << 32) + order.base.cpu().numpy()
    n = 0
    for hm, e0, nh in triples:
        first = np.searchsorted(key, hm * (1 << 32) + e0, "right") - 1
        last = np.searchsorted(key, hm * (1 << 32) + e0 + nh - 1, "right") - 1
        n += int((first // rows != last // rows).sum())
    return n


def runs_case(B, n_masks, chunks, e_cap, device="cpu"):
    """Masks of `chunks` chunk rows of e_cap entries, dealt to two buckets
    in turn; query b hits entries [1 + b % 3, chunks e_cap - 1 - b % 2) of
    every mask, one run over all its chunk rows: every query hits the first
    and the last ordered row, and with chunks = 3 runs cross units.
    Returns (stacked, RowOrder, per query the triples)."""
    vmask = np.repeat(np.arange(n_masks), chunks)
    vstart = np.tile(np.arange(chunks) * e_cap, n_masks)
    rows = [np.arange(0, vmask.shape[0], 2), np.arange(1, vmask.shape[0], 2)]
    order = SC.row_order([vmask[r] for r in rows], [vstart[r] for r in rows],
                         [np.full(r.shape[0], e_cap) for r in rows], device)
    lo = 1 + np.arange(B) % 3
    hi = chunks * e_cap - 1 - np.arange(B) % 2
    stacked = np.empty(2 * B * vmask.shape[0], dtype=np.int32)
    at = 0
    for r in rows:
        blk = stacked[2 * B * at: 2 * B * (at + r.shape[0])].reshape(2, B, r.shape[0])
        loc_lo = np.clip(lo[:, None] - vstart[r][None, :], 0, e_cap)
        blk[0] = np.clip(hi[:, None] - vstart[r][None, :], 0, e_cap) - loc_lo
        blk[1] = loc_lo
        at += r.shape[0]
    want = [(np.arange(n_masks, dtype=np.int64), np.full(n_masks, lo[b], dtype=np.int64),
             np.full(n_masks, hi[b] - lo[b], dtype=np.int64)) for b in range(B)]
    return torch.from_numpy(stacked).to(device), order, want


# (B, masks): R = 3 x masks ordered rows, a multiple of SPAN (384) or not
# (300), over a TILE (1,200)
RUNS = [(5, 128), (5, 100), (1, 128), (1, 100), (5, 400), (1, 400)]


@pytest.mark.parametrize("B, n_masks", RUNS)
def test_plain_compaction_runs_over_units(B, n_masks):
    """The plain compaction of runs_case: each mask's hit one triple, runs
    over the units' boundaries, the first and last rows hit in every query."""
    stacked, order, want = runs_case(B, n_masks, 3, 4)
    assert order.perm.shape[0] == 3 * n_masks
    # a unit boundary inside a mask's three rows cuts its run
    cuts = sum(1 for r in range(SC.SPAN, 3 * n_masks, SC.SPAN) if r % 3)
    assert cuts and unit_crossings(order, want) == B * cuts
    assert unit_crossings(order, want, SC.TILE) == (B if n_masks == 400 else 0)
    assert listed(split_triples(*SC.seed_compact(stacked, B, order))) == listed(want)


# the card's cases of one-entry chunk rows: (B, masks, buckets, max_count),
# runs of up to 60 rows, and up to 400 (longer than two warps' spans)
ONE_ENTRY_ROWS = [(4, 400, 3, 60), (3, 80, 2, 400)]


@pytest.mark.parametrize("B, n_masks, n_buckets, max_count", ONE_ENTRY_ROWS)
def test_one_entry_rows_runs_cross_units(B, n_masks, n_buckets, max_count):
    """The card's cases of one-entry chunk rows have runs over the
    boundaries of warps' spans and of blocks' tiles inside a query, and the
    plain compaction sums them."""
    stacked, order, want = seed_compact_case(B, n_masks, seed=B + n_masks, e_cap=1,
                                             n_buckets=n_buckets, hit_rate=0.9,
                                             max_count=max_count)
    assert unit_crossings(order, want) > 0 and unit_crossings(order, want, SC.TILE) > 0
    if max_count > 2 * SC.SPAN:
        assert max(int(w[2].max()) for w in want[1:]) > 2 * SC.SPAN
    assert listed(split_triples(*SC.seed_compact(stacked, B, order))) == listed(want)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B, n_masks, n_buckets, e_cap, hit_rate, max_count", [
    (1, 40, 1, 8, 0.5, 60), (32, 3000, 4, 16, 0.5, 60), (33, 200, 3, 5, 0.9, 60),
    (4, 30, 2, 8, 0.0, 60), (2, 20000, 32, 8, 0.3, 60), (32, 5, 2, 3, 1.0, 60),
    (32, 55000, 4, 8, 0.5, 60), (1, 55000, 7, 8, 0.5, 60),
    *[(B, m, nb, 1, 0.9, mc) for B, m, nb, mc in ONE_ENTRY_ROWS]])
def test_cuda_seed_compact_equals_plain(cuda_device, B, n_masks, n_buckets, e_cap, hit_rate,
                                        max_count):
    """The kernel == its plain version == the ranges the inputs were made
    from, on random B1-shaped outputs of chunked masks spread over 1 to 32
    buckets: B = 1 to 33, no hit at all, every cell a hit, ordered rows over
    many warps' spans; a look-back over thousands of tiles (55,000 masks,
    over 200,000 ordered rows: some 7,000 tiles of 1,024 rows at B = 32),
    and at B = 1; chunk rows of one entry, whose runs cross warps' spans and
    blocks' tiles inside a query, some longer than two spans."""
    stacked, order, want = seed_compact_case(B, n_masks, seed=B + n_masks, e_cap=e_cap,
                                             n_buckets=n_buckets, hit_rate=hit_rate,
                                             max_count=max_count, device=cuda_device)
    if n_masks == 55000:
        assert order.perm.shape[0] >= 200_000
    if e_cap == 1:
        assert unit_crossings(order, want) > 0 and unit_crossings(order, want, SC.TILE) > 0
    before = SC.seed_compact.launches
    got = SC.seed_compact(stacked, B, order)
    torch.cuda.synchronize()
    assert SC.seed_compact.launches == before + 1
    plain = SC.seed_compact_plain(stacked, B, order)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    assert listed(split_triples(*got)) == listed(want)


@pytest.mark.cuda
@pytest.mark.parametrize("B, n_masks", RUNS)
def test_cuda_seed_compact_runs_over_units(cuda_device, B, n_masks):
    """runs_case on the card: runs over the units' boundaries merged, and
    between a query's last tile and the next query's first no merge, the
    offsets exact, with R a multiple of SPAN or not."""
    stacked, order, want = runs_case(B, n_masks, 3, 4, device=cuda_device)
    got = SC.seed_compact(stacked, B, order)
    plain = SC.seed_compact_plain(stacked, B, order)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    assert listed(split_triples(*got)) == listed(want)


@pytest.mark.cuda
def test_cuda_seed_compact_back_to_back(cuda_device):
    """Calls on one row order, queued without a wait between them (each
    returns after its own offsets), with other hit patterns and another
    order's call between them: stale status words or a stale tile counter
    would show as a wrong or a missing triple."""
    B = 32
    stacked, order, _ = seed_compact_case(B, 3000, seed=5, e_cap=16, n_buckets=4,
                                          hit_rate=0.5, device=cuda_device)
    g = torch.Generator(device="cpu").manual_seed(5)
    sparse = stacked.clone().view(2, -1)
    keep = (torch.rand(sparse.shape[1], generator=g) < 0.1).to(cuda_device)
    sparse[0] = torch.where(keep, sparse[0], 0)
    sparse = sparse.view(-1)
    other, other_order, _ = seed_compact_case(1, 40, seed=41, device=cuda_device)
    runs = [(stacked, B, order), (sparse, B, order), (other, 1, other_order),
            (torch.zeros_like(stacked), B, order), (stacked, B, order), (sparse, B, order)]
    got = [SC.seed_compact(*run) for run in runs]
    torch.cuda.synchronize()
    for run, (off, trip) in zip(runs, got):
        want_off, want_trip = SC.seed_compact_plain(*run)
        assert torch.equal(off, want_off) and torch.equal(trip, want_trip)
    assert got[3][1].shape[1] == 0 and 0 < got[1][1].shape[1] < got[0][1].shape[1]


@pytest.mark.cuda
def test_cuda_seed_compact_side_stream(cuda_device):
    """A call on a side stream (the kernel and its memset follow the
    current stream) == the plain version, with the default stream busy."""
    B = 32
    stacked, order, want = seed_compact_case(B, 3000, seed=6, e_cap=16, n_buckets=4,
                                             hit_rate=0.5, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    busy = torch.randn(2048, 2048, device=cuda_device)
    for _ in range(4):
        busy = busy @ busy / 2048
    with torch.cuda.stream(side):
        got = SC.seed_compact(stacked, B, order)
        trip = got[1].clone()
    torch.cuda.synchronize()
    plain = SC.seed_compact_plain(stacked, B, order)
    assert torch.equal(got[0], plain[0]) and torch.equal(trip, plain[1])
    assert listed(split_triples(got[0], trip)) == listed(want)
