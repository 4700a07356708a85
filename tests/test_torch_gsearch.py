"""The port's genome search / pair / compare (`index/gsearch.py`) against
the JAX package's, on tests/test_gsearch.py's synthetic fixture: three
120 kb genomes (GA; GB, 2% diverged from it; GC, unrelated) and a 512-mask
index.  The port's index is built with its device capture (the capture
kernels' plain twin on the CPU) and the JAX package's with its host
capture; each test runs both packages' function on the same inputs.

Tolerance: exact, floats included (the two packages run the same host
code in the same order).  tests/test_gsearch.py's own bounds (ANI 0.98 +-
0.01 for the 2% relative) are checked on the port's results too."""

import dataclasses
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from torch_parity import one_intra_op_thread  # noqa: F401  (autouse fixture)

from lexicmap_tpu.index import gsearch as JG
from lexicmap_tpu.index.build import BuildOptions as JaxBuildOptions
from lexicmap_tpu.index.build import build_index as jax_build_index
from lexicmap_tpu.index.search import IndexSearcher as JaxSearcher
from lexicmap_tpu.index.search import SearchOptions as JaxSearchOptions
from lexicmap_tpu_torch.index import gsearch as TG
from lexicmap_tpu_torch.index.build import BuildOptions, build_index
from lexicmap_tpu_torch.index.search import IndexSearcher, SearchOptions


def mutate(rng, seq, rate):
    arr = np.frombuffer(seq, dtype=np.uint8).copy()
    n = int(len(arr) * rate)
    pos = rng.choice(len(arr), size=n, replace=False)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    for p in pos:
        arr[p] = bases[(np.nonzero(bases == arr[p])[0][0] + rng.integers(1, 4)) % 4]
    return arr.tobytes()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(77)
    base = bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=120000))
    genomes = {
        "GA": base,
        "GB": mutate(rng, base, 0.02),
        "GC": bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=120000)),
    }
    d = tmp_path_factory.mktemp("grefs")
    files = []
    for name, seq in genomes.items():
        p = d / f"{name}.fasta"
        with open(p, "wb") as fh:
            fh.write(b">c0\n" + seq + b"\n")
        files.append(str(p))
    jout = str(tmp_path_factory.mktemp("gdb") / "jax.lmt")
    tout = str(tmp_path_factory.mktemp("gdb") / "port.lmt")
    jax_build_index(jout, files, JaxBuildOptions(k=31, n_masks=512, chunks=2))
    build_index(tout, files, BuildOptions(k=31, n_masks=512, chunks=2, engine="device",
                                          device="cpu"))
    jidx = JaxSearcher(jout, JaxSearchOptions(min_prefix=21))
    tidx = IndexSearcher(tout, SearchOptions(min_prefix=21))
    return jidx, tidx, d, tout


def queries(d, name, k):
    return (JG.read_genome_query(str(d / f"{name}.fasta"), k),
            TG.read_genome_query(str(d / f"{name}.fasta"), k))


def same_results(a, b):
    return [dataclasses.asdict(x) for x in a] == [dataclasses.asdict(x) for x in b]


def test_seqs2fragments():
    seqs = [np.zeros(2500, dtype=np.uint8), np.zeros(90, dtype=np.uint8),
            np.ones(1100, dtype=np.uint8)]
    jf, jt = JG.seqs2fragments(seqs, 1020, 100)
    tf, tt = TG.seqs2fragments(seqs, 1020, 100)
    assert jt == tt and len(jf) == len(tf) >= 4
    assert all(np.array_equal(a, b) for a, b in zip(jf, tf))


@pytest.mark.parametrize("scale", [1, 4, 10])
def test_sample_fragment_kmers(scale):
    frag = np.random.default_rng(1).integers(0, 4, size=1020).astype(np.uint8)
    jk, jp = JG.sample_fragment_kmers(frag, scale)
    tk, tp = TG.sample_fragment_kmers(frag, scale)
    assert np.array_equal(jk, tk) and np.array_equal(jp, tp)
    assert tk.shape[0] > 0


@pytest.mark.parametrize("name", ["GA", "GB"])
def test_screen_ranking(setup, name):
    jidx, tidx, d, _ = setup
    jq, tq = queries(d, name, tidx.k)
    jg = JG.gsearch_screen(jidx, jq, JG.GSearchOptions())
    tg = TG.gsearch_screen(tidx, tq, TG.GSearchOptions())
    assert tg == jg
    ids = [tidx.id_of_code[codes[0]].decode() for codes, _ in tg]
    assert ids[0] == name and {"GA", "GB"} <= set(ids)


def test_gsearch_align_ani_af(setup):
    jidx, tidx, d, _ = setup
    jq, tq = queries(d, "GB", tidx.k)
    jr = JG.gsearch_align(jidx, jq, JG.gsearch_screen(jidx, jq, JG.GSearchOptions()),
                          JG.GSearchOptions())
    tr = TG.gsearch_align(tidx, tq, TG.gsearch_screen(tidx, tq, TG.GSearchOptions()),
                          TG.GSearchOptions())
    assert tr and same_results(jr, tr)
    by_id = {r.genome_id.decode(): r for r in tr}
    assert by_id["GB"].ani == pytest.approx(1.0, abs=0.001)
    assert by_id["GA"].ani == pytest.approx(0.98, abs=0.01)
    assert "GC" not in by_id


def test_compare_two_genomes(setup):
    _, _, d, _ = setup
    (j1, t1), (j2, t2) = queries(d, "GA", 13), queries(d, "GB", 13)
    jr = JG.compare_two_genomes(j1, j2, JG.GSearchOptions())
    tr = TG.compare_two_genomes(t1, t2, TG.GSearchOptions())
    assert same_results([jr], [tr])
    assert tr.ani == pytest.approx(0.98, abs=0.01) and tr.af_q > 0.8


@pytest.mark.parametrize("subset", [False, True], ids=["all_masks", "mask_subset"])
def test_genome_pairs(setup, subset):
    jidx, tidx, _, _ = setup
    nm = 4 ** int(math.log(tidx.mask_set.m, 4)) if subset else 0
    jp = JG.genome_pairs(jidx, min_prefix=21, min_mask_fraction=0.01, n_masks=nm)
    tp = TG.genome_pairs(tidx, min_prefix=21, min_mask_fraction=0.01, n_masks=nm)
    assert tp == jp and tp
    top = {tidx.id_of_code[tp[0][0]].decode(), tidx.id_of_code[tp[0][1]].decode()}
    assert top == {"GA", "GB"}
    if subset:
        assert all(p[2] <= nm for p in tp)


def test_ortho_ani_compare(setup):
    _, _, d, _ = setup
    (j1, t1), (j2, t2) = queries(d, "GA", 13), queries(d, "GB", 13)
    jr = JG.ortho_ani_compare(j1, j2, JG.GSearchOptions())
    tr = TG.ortho_ani_compare(t1, t2, TG.GSearchOptions())
    assert tr == jr
    assert tr[3] > 50 and tr[0] == pytest.approx(0.98, abs=0.01)


@pytest.mark.parametrize("args", [
    (100, 30, 0.25, 100, 0.001), (90, 1, 0.25, 100, 0.001), (1, 1, 0.25, 1024, 0.001),
    (512, 10, 0.25, 1024, 0.001), (512, 200, 0.25, 1024, 0.001), (300, 80, 0.25, 1024, 0.01),
])
def test_should_keep_pair_bounds(args):
    assert TG.should_keep_pair(*args) == JG.should_keep_pair(*args)


def test_screen_device_matches_host(setup):
    """Screening through the port's device matcher (B1's plain twin on the
    CPU, host lo-word refinement for the 21-base prefix) gives the host
    range search's scores, on an index the port's device capture built."""
    _, tidx, d, tout = setup
    didx = IndexSearcher(tout, SearchOptions(min_prefix=21, engine="device", device="cpu"))
    assert didx.device_matcher is not None
    for name in ("GA", "GB", "GC"):
        q = TG.read_genome_query(str(d / f"{name}.fasta"), tidx.k)
        for windows in (1, 3):
            opt = TG.GSearchOptions(windows=windows)
            assert TG.gsearch_screen(didx, q, opt) == TG.gsearch_screen(tidx, q, opt), name
