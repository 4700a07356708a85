"""Phase 2b's reversed-k-mer dispatch for a batch
(lexicmap_tpu_torch/kernels/reverse_dispatch.py): its plain version and the
wrapper on CPU tensors equal the JAX package's (and the port's host's)
IndexSearcher._reversed_query_kmers array for array (values, dtypes, order)
on captured queries of 300 bp to 5 kb at k = 31 and 21, captures with
zeros, an all-zero query, a low-complexity query, and a mask set with a
repeated value; the crit-bit tree the kernel walks gives the reference's
nearest masks; a query the card declines is dispatched on the host, alone,
and the rows equal the JAX package's; an index of more masks than the
kernel takes stays on the host's dispatch.  The kernel's own cases need a
CUDA device and skip without one; they hold the kernel to the plain version
and the port's host dispatch (the JAX package does not run on the card)."""

import zlib

import numpy as np
import pytest
import torch

from torch_parity import masks_searcher, mutated_queries, rows_of, write_genomes
from torch_parity import one_intra_op_thread  # noqa: F401  (autouse fixture)

from lexicmap_tpu_torch.index.build import BuildOptions, build_index
from lexicmap_tpu_torch.index.search import IndexSearcher, SearchOptions
from lexicmap_tpu_torch.kernels import reverse_dispatch as RD
from lexicmap_tpu_torch.masks import MaskSet
from lexicmap_tpu_torch.utils.kmers import reverse_kmers, seq_to_codes

M = 20_000
PORT, JAX = "lexicmap_tpu_torch", "lexicmap_tpu"


def random_seq(rng, n: int) -> bytes:
    return bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=n))


def captured(s: IndexSearcher, seqs) -> np.ndarray:
    """Phase 1 of each query: its masked captures, [len(seqs), m] uint64."""
    return np.stack([s._mask_query(seq_to_codes(q))[0] for q in seqs])


def case(name: str):
    """(host searcher, k-mers [B, m]) of a named case."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    kind, _, arg = name.partition("-")
    if kind == "len":  # three queries of one length, at k = 31 and 21
        n, k = (int(x) for x in arg.split("k"))
        s = masks_searcher(PORT, MaskSet.generate(k, M, 1).masks, k)
        return s, captured(s, [random_seq(rng, n) for _ in range(3)])
    s = masks_searcher(PORT, MaskSet.generate(31, M, 1).masks, 31)
    if kind == "zeros_among":  # every third capture zeroed, and the DUST filter's
        kmers = captured(s, [random_seq(rng, 1000),
                             random_seq(rng, 400) + b"AT" * 60 + random_seq(rng, 400)])
        kmers[0, ::3] = 0
        assert (kmers[1] == 0).any()
        return s, kmers
    if kind == "all_zero":  # between two queries, one with no capture at all
        kmers = captured(s, [random_seq(rng, 1000)] * 3)
        kmers[1] = 0
        return s, kmers
    if kind == "low_complexity":  # a 37-base unit in tandem: ~37 distinct k-mers
        unit = random_seq(rng, 37)
        kmers = captured(s, [unit * 30, random_seq(rng, 800)])
        nz = kmers[0][kmers[0] != 0]
        assert nz.shape[0] > 10_000 and np.unique(nz).shape[0] < 80
        return s, kmers
    if kind == "repeated_mask":  # masks with equal values; k-mers whose
        # reversed values are the repeated masks themselves, and their neighbours
        masks = np.sort(rng.integers(0, 1 << 62, 3000, dtype=np.uint64))
        masks[101] = masks[100]
        masks[2001:2004] = masks[2000]
        s = masks_searcher(PORT, masks, 31)
        kmers = np.zeros((2, 3000), dtype=np.uint64)
        kmers[0] = rng.integers(1, 1 << 62, 3000, dtype=np.uint64)
        near = np.concatenate([masks[[100, 2000, 2002]], masks[[99, 102, 1999, 2004]] ^ np.uint64(5)])
        kmers[0, ::7][: near.shape[0]] = reverse_kmers(near, 31)
        kmers[1] = kmers[0][::-1]
        return s, kmers
    raise ValueError(name)


CASES = ["len-300k31", "len-1000k31", "len-5000k31", "len-300k21", "len-1000k21",
         "len-5000k21", "zeros_among", "all_zero", "low_complexity", "repeated_mask"]


def assert_equal_host(s: IndexSearcher, kmers: np.ndarray, res: RD.Reversed, pkgs=(JAX, PORT)):
    """res == the host's _reversed_query_kmers of each package of `pkgs`
    over s's masks, query for query."""
    assert res.offsets.dtype == np.int64 and res.offsets.shape == (kmers.shape[0] + 1,)
    for pkg in pkgs:
        ref = masks_searcher(pkg, s.mask_set.masks, s.k)
        for b in range(kmers.shape[0]):
            got, want = res.query(b), ref._reversed_query_kmers(kmers[b])
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w), (pkg, b)


@pytest.mark.parametrize("name", CASES)
def test_dispatch_equals_host(name):
    s, kmers = case(name)
    mt = RD.mask_tree(s.mask_set.masks, s.k, "cpu")
    t = torch.from_numpy(kmers.view(np.int64))
    plain = RD.reverse_dispatch_plain(t, mt)
    before = RD.reverse_dispatch.launches
    wrapped = RD.reverse_dispatch(t, mt)()
    assert RD.reverse_dispatch.launches == before  # CPU: the plain version
    assert not plain.declined.any() and not wrapped.declined.any()
    assert_equal_host(s, kmers, plain)
    assert_equal_host(s, kmers, wrapped)
    if name == "all_zero":
        assert plain.offsets[2] == plain.offsets[1]
    if name == "repeated_mask":  # the lowest index of a run of equal masks
        assert {100, 2000} <= set(plain.new_mask.tolist())
        assert not {101, 2001, 2002, 2003} & set(plain.new_mask.tolist())


def walk(mt: RD.MaskTree, rev: np.ndarray) -> np.ndarray:
    """The kernel's descent over the tree, in Python."""
    tree = mt.tree.numpy().view(np.uint64)
    out = np.empty(rev.shape[0], dtype=np.int64)
    child = (1 << 29) - 1
    for i, r in enumerate(rev.tolist()):
        node = mt.root
        while not node & RD.LEAF:
            w = int(tree[node])
            node = (w >> 29) & child if (r >> (w >> 58)) & 1 else w & child
        out[i] = node & ~RD.LEAF
    return out


@pytest.mark.parametrize("k, m, repeats", [(31, M, False), (21, 5000, True), (32, 3000, True),
                                           (5, 40, True), (31, 1, False)])
def test_mask_tree_walk_equals_nearest_mask(k, m, repeats):
    """The tree's walk gives MaskSet.nearest_mask's index (native XOR argmin),
    the JAX package's and the port's, for every reversed k-mer: the
    gtdb.genes masks, random masks with runs of equal values, 64-bit k-mers
    (k = 32), one mask."""
    rng = np.random.default_rng(k * m)
    if m == M:
        masks = MaskSet.generate(k, m, 1).masks
    else:
        masks = np.sort(rng.integers(0, 1 << 63, m, dtype=np.uint64) * np.uint64(2)
                        >> np.uint64(64 - 2 * k))
    if repeats:
        masks[m // 2 + 1: m // 2 + 4] = masks[m // 2]
        masks[-1] = masks[-2]
    rev = (rng.integers(0, 1 << 63, 3000, dtype=np.uint64) * np.uint64(2)
           + rng.integers(0, 2, 3000, dtype=np.uint64)) >> np.uint64(64 - 2 * k)
    rev = np.concatenate([rev, masks[:50], masks[-3:]])
    mt = RD.mask_tree(masks, k, "cpu")
    for pkg in (JAX, PORT):
        assert np.array_equal(walk(mt, rev), masks_searcher(pkg, masks, k).mask_set.nearest_mask(rev))


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    files, seqs = write_genomes(tmp_path_factory.mktemp("rrefs"))
    out = str(tmp_path_factory.mktemp("rdb") / "d.lmt")
    build_index(out, files, BuildOptions(k=31, n_masks=512, chunks=2, threads=2))
    return out, seqs


def buckets_largest(res: RD.Reversed) -> list[int]:
    out = []
    for b in range(res.declined.shape[0]):
        nm = res.query(b)[0]
        out.append(int(np.unique(nm, return_counts=True)[1].max()) if nm.shape[0] else 0)
    return out


def test_declined_query_dispatched_on_host(db, monkeypatch):
    """A RUN_CAP under one query's largest bucket: that query alone goes to
    anchors.reverse_host (one host dispatch, of its captures), the others
    keep the card's arrays, and the rows equal the JAX package's host
    engine's."""
    path, seqs = db
    qs = mutated_queries(seqs, ["D0", "D1", "D2"], 3000, 1500, 15, 21)
    qs += mutated_queries(seqs, ["D2", "D0"], 20000, 600, 6, 22)
    dev = IndexSearcher(path, SearchOptions(engine="device", device="cpu"))
    kmers = captured(dev, qs)
    largest = buckets_largest(RD.reverse_dispatch_plain(
        torch.from_numpy(kmers.view(np.int64)), RD.mask_tree(dev.mask_set.masks, 31, "cpu")))
    top = int(np.argmax(largest))
    cap = sorted(largest)[-2]
    assert largest[top] > cap  # exactly one query over the cap
    monkeypatch.setattr(RD, "RUN_CAP", cap)
    calls = []
    host_dispatch = dev._reversed_query_kmers

    def recording(k):
        calls.append(k.copy())
        return host_dispatch(k)

    monkeypatch.setattr(dev, "_reversed_query_kmers", recording)
    got = [rows_of(r, f"q{i}") for i, r in enumerate(dev.search_many(qs))]
    c = dev.spans.counts
    assert c["anchors.reverse_host"] == 1 and c["match.reverse"] == 1
    assert c["anchors.reverse"] == len(qs)
    assert len(calls) == 1 and np.array_equal(calls[0], kmers[top])
    assert got == jax_rows(path, qs)
    assert sum(map(len, got)) >= 5


def jax_rows(path, qs):
    from lexicmap_tpu.index.search import IndexSearcher as JaxSearcher
    from lexicmap_tpu.index.search import SearchOptions as JaxOptions

    host = JaxSearcher(path, JaxOptions(engine="host"))
    return [rows_of(host.search_bytes(q), f"q{i}") for i, q in enumerate(qs)]


def test_mask_set_over_max_m_stays_on_host(db, monkeypatch):
    """An index of more masks than the kernel takes (here MAX_M under the
    db's 512): the device engine keeps no mask tree, uploads and counts no
    match.reverse, dispatches every query on the host's path as before
    (anchors.reverse, no anchors.reverse_host), and its rows equal the JAX
    package's; the wrapper refuses such a batch."""
    path, seqs = db
    qs = mutated_queries(seqs, ["D0", "D1", "D2"], 3000, 1500, 15, 23)
    monkeypatch.setattr(RD, "MAX_M", 511)
    dev = IndexSearcher(path, SearchOptions(engine="device", device="cpu"))
    got = [rows_of(r, f"q{i}") for i, r in enumerate(dev.search_many(qs))]
    assert dev._device_engine.masks is None
    c = dev.spans.counts
    assert c["match.reverse"] == 0 and c["anchors.reverse_host"] == 0
    assert c["anchors.reverse"] == len(qs)
    assert got == jax_rows(path, qs)
    assert all(got)
    mt = RD.mask_tree(dev.mask_set.masks, 31, "cpu")
    t = torch.from_numpy(captured(dev, qs[:1]).view(np.int64))
    for fn in (RD.reverse_dispatch, RD.reverse_dispatch_plain):
        with pytest.raises(ValueError, match="at most 511"):
            fn(t, mt)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_cuda_dispatch_equals_plain_and_host(cuda_device, name):
    s, kmers = case(name)
    mt = RD.mask_tree(s.mask_set.masks, s.k, cuda_device)
    t = torch.from_numpy(kmers.view(np.int64)).to(cuda_device)
    before = RD.reverse_dispatch.launches
    got = RD.reverse_dispatch(t, mt)()
    assert RD.reverse_dispatch.launches == before + 1
    plain = RD.reverse_dispatch_plain(t, mt)
    for a, b in zip((got.offsets, got.declined, got.new_mask, got.rev_kmer, got.orig_mask),
                    (plain.offsets, plain.declined, plain.new_mask, plain.rev_kmer,
                     plain.orig_mask)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert_equal_host(s, kmers, got, pkgs=(PORT,))


@pytest.mark.cuda
def test_cuda_declines_over_the_cap(cuda_device, monkeypatch):
    """Queued back to back without a wait: the card's declined flags and
    records follow RUN_CAP as the plain version's do, at B = 1, 2 and 40
    (the second query's largest bucket, 10, over a cap of 3; the first's 3)."""
    s, kmers = case("zeros_among")
    mt = RD.mask_tree(s.mask_set.masks, 31, cuda_device)
    t = torch.from_numpy(kmers.view(np.int64)).to(cuda_device)
    assert buckets_largest(RD.reverse_dispatch_plain(t, mt)) == [3, 10]
    monkeypatch.setattr(RD, "RUN_CAP", 3)
    runs = [t[:1], t, t.repeat(20, 1)]
    fetches = [RD.reverse_dispatch(r, mt) for r in runs]
    got = [f() for f in fetches]
    for r, g in zip(runs, got):
        plain = RD.reverse_dispatch_plain(r, mt)
        for a, b in zip((g.offsets, g.declined, g.new_mask, g.rev_kmer, g.orig_mask),
                        (plain.offsets, plain.declined, plain.new_mask, plain.rev_kmer,
                         plain.orig_mask)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[1].declined.tolist() == [False, True]
