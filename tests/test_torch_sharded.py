"""The port's mask-sharded seed matcher (parallel/sharded.py) against the
JAX package's on its virtual 8-device CPU mesh.

JAX's make_mesh(8) is dp = 2 x tp = 4; the port runs one gloo rank with
L = 4 local shards (dp = 1, tp = 4): the same tp, so the same deal of masks
to shards, the same padded row counts and the same hit capacities (dp only
pads the batch).  B11 (seed_match_shard) and B12's compaction (shard_compact)
run through their plain twins here; tests/test_torch_cuda.py holds the
kernels to the twins on the card.  Inputs come from numpy seeds; every
comparison is exact."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from torch_parity import (
    SHARD_CASES,
    compact_case,
    rows_of,
    SHARD_STACK_KINDS,
    screening_case,
    shard_kernel_case,
    shard_match_replay,
    shard_stack_case,
    sharded_db,
)
from torch_parity import one_intra_op_thread  # noqa: F401  (autouse fixture)
from torch_parity import rec  # noqa: F401  (fixture)

import jax.numpy as jnp

from lexicmap_tpu.index.search import IndexSearcher as JaxSearcher
from lexicmap_tpu.index.search import SearchOptions as JaxOptions
from lexicmap_tpu.parallel import sharded as JS
from lexicmap_tpu_torch import entry as TE
from lexicmap_tpu_torch.index.search import IndexSearcher, SearchOptions
from lexicmap_tpu_torch.kernels import seed_locate as SL
from lexicmap_tpu_torch.kernels.seed_match_shard import seed_match_shard, seed_match_shard_plain
from lexicmap_tpu_torch.kernels.shard_compact import (
    shard_compact,
    shard_compact_all_plain,
    shard_compact_plain,
)
from lexicmap_tpu_torch.parallel import sharded as TS
from lexicmap_tpu_torch.parallel.engine import DeviceSearchEngine
from lexicmap_tpu_torch.utils.kmers import seq_to_codes


def i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    return sharded_db(tmp_path_factory.mktemp("sharded"))


@pytest.fixture(scope="module")
def jax_mesh():
    return JS.make_mesh(8)


def masked_batch(idx, queries):
    codes = [seq_to_codes(q) for q in queries]
    masked = [idx._mask_query(c) for c in codes]
    return codes, masked, np.stack([m[0] for m in masked])


@pytest.mark.parametrize("name", SHARD_CASES)
def test_seed_match_shard_plain_equals_jax(name):
    seeds, queries, k, p = shard_kernel_case(name, seed=3)
    n_hits, lcp = jax.jit(lambda s, q: JS.seed_match_shard(s, q, k, p))(seeds, queries)
    score = np.asarray(jnp.sum(n_hits.astype(jnp.float32) * lcp.astype(jnp.float32), axis=1))
    before = seed_match_shard.launches
    got = seed_match_shard(i32(seeds), i32(queries), k, p)
    assert seed_match_shard.launches == before  # the CPU runs the plain twin
    for g, w in zip(got, (n_hits, lcp, score)):
        assert np.array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(seed_match_shard_plain(i32(seeds), i32(queries), k, p), got):
        assert torch.equal(g, w)
    nh = got[0].numpy()
    if name == "pad_all_T":
        # the all-T query's range reaches the pad words, which count
        row = seeds[0]
        assert nh[0, 0] == int((row >= (queries[0, 0] & ~np.uint32(0xFF))).sum())
        assert (nh[: queries.shape[0] // 2].sum() > 0)
    if name == "zero_queries":
        assert not nh.any() and not got[1].numpy().any()
    if name == "e0_is_E":
        assert not nh[: queries.shape[0] // 2].any()
    if name == "random":
        assert (nh[queries != 0] >= 1).mean() > 0.9


@pytest.mark.parametrize("name", SHARD_CASES)
def test_seed_match_shard_stacked_plain_equals_jax_sum(name):
    """A rank's L = 4 shards in one call ([L, M, E] seeds, [L, B, M]
    queries, as shard_arrays lays them out): n_hits and lcp are JAX's
    seed_match_shard on each shard, the score the exact sum of JAX's
    per-shard products over every shard."""
    seeds, queries, k, p = shard_kernel_case(name, seed=4)
    L = 4
    ml = seeds.shape[0] // L
    fn = jax.jit(lambda s, q: JS.seed_match_shard(s, q, k, p))
    parts = [[np.asarray(a) for a in fn(seeds[l * ml: (l + 1) * ml],
                                       queries[:, l * ml: (l + 1) * ml])] for l in range(L)]
    s3 = seeds[: L * ml].reshape(L, ml, -1)
    q3 = queries[:, : L * ml].reshape(queries.shape[0], L, ml).transpose(1, 0, 2)
    got = seed_match_shard(i32(s3), i32(q3), k, p)
    assert got[0].shape == got[1].shape == (L, queries.shape[0], ml)
    for l, (nh, lcp) in enumerate(parts):
        assert np.array_equal(got[0][l].numpy(), nh) and np.array_equal(got[1][l].numpy(), lcp)
    total = sum((nh.astype(np.int64) * lcp).sum(1) for nh, lcp in parts)
    assert total.max() < 1 << 24
    assert np.array_equal(got[2].numpy(), total.astype(np.float32))
    # the 2-D call on one shard is the L = 1 case
    one = seed_match_shard(i32(s3[:1]), i32(q3[:1]), k, p)
    two = seed_match_shard(i32(s3[0]), i32(q3[0]), k, p)
    assert all(torch.equal(a[0], b) for a, b in zip(one[:2], two[:2]))
    assert torch.equal(one[2], two[2])


@pytest.mark.parametrize("kind", SHARD_STACK_KINDS)
@pytest.mark.parametrize("E", [1, 20, 100])
def test_shard_match_replay_equals_plain(kind, E):
    """The torch replay of match_shard's sampled search (which the smoke
    counts B11's sectors with) gives the plain twin's n_hits, and its e0
    the first word of each hit's range, on every shard."""
    seeds, queries, k, p = shard_stack_case(4, 33, 29, E, kind=kind, seed=3, p=12)
    nh, _, _ = seed_match_shard_plain(i32(seeds), i32(queries), k, p)
    for l in range(4):
        rn, re0, sectors = shard_match_replay(i32(seeds[l]), i32(queries[l]), p)
        assert torch.equal(rn, nh[l])
        hit = rn > 0
        lb = torch.from_numpy(queries[l].astype(np.int64) & ~((1 << (2 * (k - p))) - 1))
        words = torch.from_numpy(seeds[l].astype(np.int64))
        first = torch.gather(words.expand(33, -1, -1), 2, re0.long().clamp(max=E - 1)[..., None])
        assert (first[..., 0][hit] >= lb[hit]).all()
        assert sectors.numel() <= -(-seeds[l].size // 8)


def test_seed_match_shard_refuses_other_words():
    seeds, queries, k, p = shard_kernel_case("random")
    with pytest.raises(TypeError, match="int32"):
        seed_match_shard(torch.from_numpy(seeds.astype(np.int64)), i32(queries), k, p)
    with pytest.raises(ValueError, match="k <= 16"):
        seed_match_shard(i32(seeds), i32(queries), 31, 15)
    with pytest.raises(ValueError, match="L >= 1"):
        seed_match_shard(torch.zeros((0, 64, 32), dtype=torch.int32),
                         torch.zeros((0, 4, 64), dtype=torch.int32), 16, 12)
    with pytest.raises(ValueError, match="queries must be"):
        seed_match_shard(i32(seeds).reshape(2, 32, 32), i32(queries).reshape(2, 32, 4), 16, 12)


@pytest.mark.parametrize("H", [0, 1, 7, 100, 128, 150])
def test_shard_compact_plain_equals_jax_sort(H):
    """The compaction against jax.lax.sort of (gid where hit, else
    0xFFFFFFFF; e0; n_hits), JAX's step, on rows with padding."""
    nh, e0, gids = compact_case(B=5, mb=128, hit_rate=0.3, seed=H, n_pad=9)
    nh[1] = 0  # a query without hits
    nh[2, :119] = 1  # one with every real row
    keys = np.where(nh.numpy() > 0, gids.numpy().view(np.uint32)[None, :], np.uint32(0xFFFFFFFF))
    sk, se, sn = (np.asarray(a) for a in jax.lax.sort(
        (jnp.asarray(keys), jnp.asarray(e0.numpy()), jnp.asarray(nh.numpy())),
        dimension=1, num_keys=1, is_stable=False))
    before = shard_compact.launches
    kk, ke, kn, n = shard_compact(nh, e0, gids, H)
    assert shard_compact.launches == before
    assert np.array_equal(n.numpy(), (nh.numpy() > 0).sum(1))
    for b in range(nh.shape[0]):
        c = min(int(n[b]), H)
        assert np.array_equal(kk[b, :c].numpy().view(np.uint32), sk[b, :c])
        assert np.array_equal(ke[b, :c].numpy(), se[b, :c])
        assert np.array_equal(kn[b, :c].numpy(), sn[b, :c])
        assert (kk[b, c:] == -1).all() and not ke[b, c:].any() and not kn[b, c:].any()
    out = torch.full((5, 3 * H + 1), 7, dtype=torch.int32)
    views = shard_compact_plain(nh, e0, gids, H, out=out)
    assert all(torch.equal(a, b) for a, b in zip(views, (kk, ke, kn, n)))


@pytest.mark.parametrize("L", [1, 2, 4])
def test_shard_compact_stacked_plain_equals_jax_sort(L):
    """The L-shard form ([L, B, mb], one launch on the card) against
    jax.lax.sort shard by shard, and against L calls of the one-shard
    shard_compact_plain; 45 rows, not a multiple of the kernel's warp
    spans; H = 12, under some queries' hits and over others'."""
    H = 12
    nh, e0, gids = compact_case(B=4, mb=45, hit_rate=0.3, seed=L, n_pad=3, L=L)
    nh[:, 0, :42] = 1  # a query over H on every shard
    nh[:, 1] = 0  # one without hits
    nh[:, 2] = 0
    nh[:, 2, :42:11] = 2  # one under H
    before = shard_compact.launches
    kk, ke, kn, n = shard_compact(nh, e0, gids, H)
    assert shard_compact.launches == before
    assert kk.shape == (L, 4, H) and n.shape == (L, 4)
    assert (n > H).any() and ((n <= H) & (n > 0)).any()
    out = torch.full((L, 4, 3 * H + 1), 7, dtype=torch.int32)
    views = shard_compact_all_plain(nh, e0, gids, H, out=out)
    assert all(torch.equal(a, b) for a, b in zip(views, (kk, ke, kn, n)))
    for l in range(L):
        one = shard_compact_plain(nh[l], e0[l], gids[l], H)
        assert all(torch.equal(a[l], b) for a, b in zip((kk, ke, kn, n), one))
        keys = np.where(nh[l].numpy() > 0, gids[l].numpy().view(np.uint32)[None, :],
                        np.uint32(0xFFFFFFFF))
        sk, se, sn = (np.asarray(a) for a in jax.lax.sort(
            (jnp.asarray(keys), jnp.asarray(e0[l].numpy()), jnp.asarray(nh[l].numpy())),
            dimension=1, num_keys=1, is_stable=True))
        c = torch.clamp(n[l], max=H)
        for b in range(4):
            assert np.array_equal(kk[l, b, : c[b]].numpy().view(np.uint32), sk[b, : c[b]])
            assert np.array_equal(ke[l, b, : c[b]].numpy(), se[b, : c[b]])
            assert np.array_equal(kn[l, b, : c[b]].numpy(), sn[b, : c[b]])


def test_search_step_equals_jax(tmp_path, jax_mesh):
    """make_sharded_search_step on one gloo rank with L = 4 against JAX's on
    make_mesh(8), on the hi-word table of a real index: equal scores."""
    table, qarr = screening_case(tmp_path)
    jstep = JS.make_sharded_search_step(jax_mesh, k=16, min_prefix=15)
    want = np.asarray(jstep(*JS.shard_arrays(jax_mesh, table, qarr)))
    with TS.make_mesh(local_shards=4, device="cpu") as mesh:
        assert (mesh.dp, mesh.tp, mesh.tp_ranks) == (1, 4, 1)
        before = seed_match_shard.launches
        got = TS.make_sharded_search_step(mesh, k=16, min_prefix=15)(
            *TS.shard_arrays(mesh, table, qarr)).numpy()
        assert seed_match_shard.launches == before
    assert got.dtype == np.float32 and got.shape == (8,)
    assert (got > 0).all() and want.max() < 1 << 24
    assert np.array_equal(got, want)


def jax_matcher_at(monkeypatch, h_shard, idx, mesh):
    monkeypatch.setattr(JS.ShardedSeedMatcher, "H_SHARD", h_shard)
    return JS.ShardedSeedMatcher(idx, mesh)


def capacity_splitting(jax_matcher, kmers, p):
    """An H_SHARD under which some queries of `kmers` overflow a shard and
    some with hits do not: the least over the queries with hits of their
    fullest shard's hits (from JAX's triples at its default capacity)."""
    tp = jax_matcher.tp
    fullest = []
    for hm, _, _ in jax_matcher.match_batch(kmers, p):
        fullest.append(int(np.bincount(hm % tp, minlength=tp).max()))
    h = min(f for f in fullest if f)
    assert h < max(fullest), fullest
    return h


def kept_or_host(got, want, idx, kmers, p):
    """JAX declines some queries and keeps others; the port returns
    triples for every query: JAX's where JAX keeps one, the host
    bisection's (tests/torch_parity.py::host_triples) where it declines."""
    from torch_parity import host_triples

    assert len(got) == len(want)
    assert any(w is None for w in want) and any(w is not None for w in want)
    for b, (g, w) in enumerate(zip(got, want)):
        assert g is not None
        ref = w if w is not None else host_triples(idx, kmers[b], p)
        assert all(np.array_equal(x, y) for x, y in zip(g, ref))


def test_matcher_equals_jax_with_overflow(db, jax_mesh, monkeypatch, rec):
    """ShardedSeedMatcher on one rank with L = 4 against JAX's on
    make_mesh(8), H_SHARD set small on both so that some queries overflow:
    JAX declines those, the port compacts their buckets again at the
    largest gathered count, so every query's triples are JAX's or, where
    JAX declines, the host bisection's."""
    path, seqs, queries = db
    jidx = JaxSearcher(path, JaxOptions())
    idx = IndexSearcher(path, SearchOptions())
    rnd = bytes(np.random.default_rng(2).choice(np.frombuffer(b"ACGT", np.uint8), 1500))
    _, _, kmers = masked_batch(idx, queries + [rnd])
    p = idx.opt.min_prefix
    h = capacity_splitting(JS.ShardedSeedMatcher(jidx, jax_mesh), kmers, p)
    want = jax_matcher_at(monkeypatch, h, jidx, jax_mesh).match_batch(kmers, p)
    monkeypatch.setattr(TS.ShardedSeedMatcher, "H_SHARD", h)
    with TS.make_mesh(local_shards=4, device="cpu") as mesh:
        m = TS.ShardedSeedMatcher(idx, mesh)
        launches = (SL.seed_locate_batch.launches, shard_compact.launches)
        got = m.match_batch(kmers, p)
        assert (SL.seed_locate_batch.launches, shard_compact.launches) == launches
        assert [m.capacity(b) for b in m.buckets] == [min(h, b.mb_pad) for b in m.buckets]
        declined = sum(w is None for w in want)
        t = rec.totals
        assert t["match.second_pass_queries"] == declined and t["match.second_passes"] >= 1
        passes = t["match.second_passes"]
        m.H_SHARD = 1 << 20  # over every bucket's rows: the capacity is the rows
        assert [m.capacity(b) for b in m.buckets] == [b.mb_pad for b in m.buckets]
        full = m.match_batch(kmers, p)
        # a second batch, compacted once: each counter tallied once a batch
        assert rec.counts["match.second_passes"] == rec.counts["match.second_pass_queries"] == 2
        assert (t["match.second_passes"], t["match.second_pass_queries"]) == (passes, declined)
    kept_or_host(got, want, idx, kmers, p)
    assert all(all(np.array_equal(x, y) for x, y in zip(f, g)) for f, g in zip(full, got))


def test_shards_from_jax_matcher_round_trip(db, jax_mesh):
    """The JAX matcher's bucket arrays, through shards_from_jax_matcher,
    are the port's own packing (one rank holds every shard at L = tp), and
    give back the same arrays."""
    path = db[0]
    jm = JS.ShardedSeedMatcher(JaxSearcher(path, JaxOptions()), jax_mesh)
    arrays = [(E, tile, np.asarray(h), np.asarray(c), np.asarray(g), mb, ids)
              for E, tile, h, c, g, mb, ids in jm.buckets]
    tables = TS.shards_from_jax_matcher(arrays)
    with TS.make_mesh(local_shards=4, device="cpu") as mesh:
        own = TS.ShardedSeedMatcher(IndexSearcher(path, SearchOptions()), mesh)
    assert len(tables) == len(own.buckets) == len(arrays)
    assert own.hbm_bytes == jm.hbm_bytes
    for t, o, (E, tile, h, c, g, mb, ids) in zip(tables, own.buckets, arrays):
        assert (t.E, t.tile, t.mb_pad) == (o.E, o.tile, o.mb_pad) == (E, tile, mb)
        assert all(np.array_equal(a, b) and np.array_equal(a, i)
                   for a, b, i in zip(t.ids_per_shard, o.ids_per_shard, ids))
        for x, y in ((t.hi, o.hi), (t.cnt, o.cnt), (t.gids, o.gids)):
            assert torch.equal(x, y)
        assert np.array_equal(t.hi.numpy().view(np.uint32), h)
        assert np.array_equal(t.cnt.numpy(), c)
        assert np.array_equal(t.gids.numpy().view(np.uint32), g)


def test_mesh_engine_equals_jax_mesh_engine_and_host(db, jax_mesh, rec):
    """DeviceSearchEngine with a one-rank mesh of L = 4 (and with the
    chain1 and WFA stages on the device too) against JAX's
    DeviceSearchEngine on make_mesh(8) and the host rows."""
    from lexicmap_tpu.parallel.engine import DeviceSearchEngine as JaxEngine

    path, _, queries = db
    qs = queries[:2] + queries[3:]
    host = IndexSearcher(path, SearchOptions())
    want = [rows_of(host.search_bytes(q), f"q{i}") for i, q in enumerate(qs)]
    jeng = JaxEngine(JaxSearcher(path, JaxOptions()), mesh=jax_mesh)
    assert [rows_of(r, f"q{i}") for i, r in enumerate(jeng.search_batch(qs))] == want
    with TS.make_mesh(local_shards=4, device="cpu") as mesh:
        for twins in ("host", "device"):
            idx = IndexSearcher(path, SearchOptions(device="cpu", chain_engine=twins,
                                                    wfa_engine=twins))
            eng = DeviceSearchEngine(idx, mesh=mesh)
            assert isinstance(eng.matcher, TS.ShardedSeedMatcher) and eng.matcher.tp == 4
            got = eng.finish_batch(eng.prepare_batch(qs))
            assert [rows_of(r, f"q{i}") for i, r in enumerate(got)] == want, twins
            assert (idx.device_chainer is not None) == (twins == "device")
            t = idx.spans.totals
            assert t["pseudo.card_windows"] + t["pseudo.host_windows"] >= 3
    assert all(want)


def test_entry_equals_jax_entry():
    import importlib.util

    spec = importlib.util.spec_from_file_location("graft_entry_t", "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jfn, jargs = mod.entry()
    fn, args = TE.entry("cpu")
    assert all(np.array_equal(a.numpy().view(np.uint32), np.asarray(j))
               for a, j in zip(args, jargs))
    want = np.asarray(jax.jit(jfn)(*jargs))
    got = fn(*args).numpy()
    assert np.array_equal(got, want) and (got > 0).all()
    assert np.array_equal(TE._example_arrays(n_masks=64, entries=8, batch=2)[1],
                          mod._example_arrays(n_masks=64, entries=8, batch=2)[1])


def test_dryrun_multichip_8(capsys):
    TE.dryrun_multichip(8, "cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip ok: mesh dp=1 tp=8" in out
    assert "dryrun real pipeline ok" in out
    import torch.distributed as dist

    assert not dist.is_initialized()  # the dry run's own group is gone
