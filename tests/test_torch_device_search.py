"""The port's DeviceSeedMatcher (device='cpu': the kernel's plain twin) vs
the JAX package's DeviceSeedMatcher (Pallas in interpret mode) on the same
index and queries.  Triples are integers: every comparison is exact."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from torch_parity import host_triples, mutated_queries, write_genomes
from torch_parity import rec  # noqa: F401  (fixture)

from lexicmap_tpu.index.build import BuildOptions, build_index
from lexicmap_tpu.index.search import IndexSearcher as JaxSearcher
from lexicmap_tpu.index.search import SearchOptions as JaxOptions
from lexicmap_tpu.parallel import device_search as jds
from lexicmap_tpu_torch.index.search import IndexSearcher, SearchOptions
from lexicmap_tpu_torch.parallel import device_search as tds
from lexicmap_tpu_torch.utils.kmers import seq_to_codes

P = 15


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    files, seqs = write_genomes(tmp_path_factory.mktemp("trefs"))
    out = str(tmp_path_factory.mktemp("tdb") / "d.lmt")
    build_index(out, files, BuildOptions(k=31, n_masks=512, chunks=2))
    return out, seqs


@pytest.fixture(scope="module")
def port_idx(db):
    return IndexSearcher(db[0], SearchOptions(engine="host"))


def query_batch(idx, seqs, seed):
    qs = mutated_queries(seqs, ["D0", "D1", "D2"], 10000 + 3000 * seed, 1500, 15, seed)
    qs.append(seqs["D1"][40000:41500])  # exact substring
    return np.stack([idx._mask_query(seq_to_codes(q.upper()))[0] for q in qs])


def assert_triples_equal(got, want):
    for g, w in zip(got, want):
        assert [a.tolist() for a in g] == [a.tolist() for a in w]


def check_against_jax(port_m, jax_m, idx, batch):
    got = port_m.match_batch(batch, P)
    want = jax_m.match_batch(batch, P)
    assert len(got) == len(want) == batch.shape[0]
    n_hits = 0
    for b, (g, w) in enumerate(zip(got, want)):
        assert g is not None
        if w is None:  # the JAX matcher overflowed: hold to host bisection
            w = host_triples(idx, batch[b], P)
        assert_triples_equal([g], [w])
        assert g[0].dtype == np.int64
        n_hits += g[0].shape[0]
    assert n_hits > 0


def jax_matcher(db, monkeypatch=None, budget=None):
    if budget is not None:
        monkeypatch.setenv("LEXICMAP_TPU_HBM_BUDGET", str(budget))
    return JaxSearcher(db[0], JaxOptions(engine="device")).device_matcher


@pytest.mark.parametrize("seed", [0, 1])
def test_default_matches_jax(db, port_idx, seed):
    pm = tds.DeviceSeedMatcher(port_idx, device="cpu")
    check_against_jax(pm, jax_matcher(db), port_idx, query_batch(port_idx, db[1], seed))
    assert pm.host_rows == 0 and pm.hbm_bytes > 0


def test_default_tables_equal_jax(db, port_idx):
    """Both matchers pack the same rows: E, mask routing, hi words, counts
    and chunk bases (tables_from_jax_matcher drops the JAX tile padding)."""
    pm = tds.DeviceSeedMatcher(port_idx, device="cpu")
    jt = tds.tables_from_jax_matcher(jax_matcher(db))
    assert len(pm.buckets) == len(jt)
    for a, b in zip(pm.buckets, jt):
        assert a.E == b.E
        assert np.array_equal(a.row_masks, b.row_masks)
        for f in ("hi", "cnt", "gids", "base"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_column_chunked_matches_jax(db, port_idx, monkeypatch):
    """E_CAP forced tiny: every mask splits into many chunk rows, and range
    hits spanning chunk boundaries must come back merged."""
    monkeypatch.setattr(tds, "E_CAP", 4)
    monkeypatch.setattr(jds, "E_CAP", 4)
    pm = tds.DeviceSeedMatcher(port_idx, device="cpu")
    jm = jax_matcher(db)
    n_rows = sum(b.row_masks.shape[0] for b in pm.buckets)
    assert n_rows > pm.m, "no mask was column-chunked"
    # same packed rows over the real lanes (the JAX bucket width is not capped)
    jt = tds.tables_from_jax_matcher(jm)
    pr = np.concatenate([b.row_masks for b in pm.buckets])
    jr = np.concatenate([b.row_masks for b in jt])
    assert np.array_equal(pr, jr)
    for f in ("cnt", "gids", "base"):
        assert torch.equal(torch.cat([getattr(b, f) for b in pm.buckets]),
                           torch.cat([getattr(b, f) for b in jt])), f
    batch = query_batch(port_idx, db[1], 2)
    check_against_jax(pm, jm, port_idx, batch)
    for hm, _, _ in pm.match_batch(batch, P):
        assert len(np.unique(hm)) == hm.shape[0], "unmerged chunk triples"


def test_budget_host_tier_matches_jax(db, port_idx, monkeypatch):
    """A starved device budget spills most rows to the host tier; the
    triples must not change."""
    pm = tds.DeviceSeedMatcher(port_idx, device="cpu", hbm_budget=200000)
    assert pm.budget_spill > 0 and pm.host_entries > 0
    assert pm.hbm_bytes <= 200000 and "host tier" in pm.describe()
    check_against_jax(pm, jax_matcher(db, monkeypatch, 200000), port_idx,
                      query_batch(port_idx, db[1], 3))


def test_all_on_host_tier(db, port_idx):
    """A zero budget: no bucket at all, every row on the host tier."""
    pm = tds.DeviceSeedMatcher(port_idx, device="cpu", hbm_budget=0)
    assert pm.buckets == [] and pm.host_rows > 0
    batch = query_batch(port_idx, db[1], 4)
    for b, got in enumerate(pm.match_batch(batch, P)):
        assert_triples_equal([got], [host_triples(port_idx, batch[b], P)])


@pytest.mark.parametrize("e_cap", [4, 1 << 14])
def test_match_equals_match_batch(port_idx, db, monkeypatch, e_cap):
    monkeypatch.setattr(tds, "E_CAP", e_cap)
    pm = tds.DeviceSeedMatcher(port_idx, device="cpu")
    batch = query_batch(port_idx, db[1], 5)
    batched = pm.match_batch(batch, P)
    for b in range(batch.shape[0]):
        assert_triples_equal([pm.match(batch[b], P)], [batched[b]])


def test_queries_without_kmers_give_empty_triples(port_idx, db):
    """A query row that captured nothing gets three empty int64 arrays,
    never None, beside a row that hits."""
    pm = tds.DeviceSeedMatcher(port_idx, device="cpu")
    batch = query_batch(port_idx, db[1], 0)[:2].copy()
    batch[1] = 0
    got = pm.match_batch(batch, P)
    assert got[0][0].shape[0] > 0
    assert [a.shape[0] for a in got[1]] == [0, 0, 0]
    assert all(a.dtype == np.int64 for a in got[1])


def test_cuda_requested_without_cuda_raises(port_idx, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tds.DeviceSeedMatcher(port_idx)


def test_out_of_memory_raises(port_idx, db, monkeypatch):
    """A device OOM at dispatch propagates: the batch is not moved to host
    bisection, and the next batch dispatches to the device again."""
    pm = tds.DeviceSeedMatcher(port_idx, device="cpu")
    batch = query_batch(port_idx, db[1], 0)
    real = tds.seed_locate_batch

    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")

    monkeypatch.setattr(tds, "seed_locate_batch", oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        pm.match_batch(batch, P)
    monkeypatch.setattr(tds, "seed_locate_batch", real)
    assert pm.match_batch(batch, P)[0][0].shape[0] > 0


def test_default_budget(port_idx, monkeypatch):
    """No cap on the CPU; on CUDA the card's free memory less an eighth and
    less phase 4's per-launch working set."""
    assert tds.default_budget(torch.device("cpu")) >= 1 << 62
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d=None: (8 << 30, 80 << 30))
    assert tds.default_budget(torch.device("cuda")) == (7 << 30) - tds.WORKING_BYTES
    assert 300e6 < tds.WORKING_BYTES < 400e6
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d=None: (256 << 20, 80 << 30))
    assert tds.default_budget(torch.device("cuda")) == 0
    pm = tds.DeviceSeedMatcher(port_idx, device="cpu")
    assert pm.host_rows == 0 and pm.budget_spill == 0


def test_match_batch_fetches_triples_once(port_idx, db, monkeypatch, rec):
    """A batch waits on the card twice: for the compaction's per-query
    offsets (they size its output), then for all its triples in one copy
    of the [T, 3] records."""
    pm = tds.DeviceSeedMatcher(port_idx, device="cpu")
    batch = query_batch(port_idx, db[1], 1)
    fetched = []
    fetch = tds.fetch_numpy

    def spy(label, *ts):
        fetched.append((label, [tuple(t.shape) for t in ts]))
        return fetch(label, *ts)

    monkeypatch.setattr(tds, "fetch_numpy", spy)
    got = pm.match_batch(batch, P)
    T = sum(g[0].shape[0] for g in got)
    assert T > 0
    assert fetched == [("device seed matching", [(T, 3)])]
    assert rec.counts["card_wait"] == 2

