"""The port's reference (.lmi) format against the JAX package's: the
codecs' round trips and their bytes, and the whole-index conversion.  The
port's export is byte-identical to JAX's, its import of JAX's export is
byte-identical to JAX's import (with and without a masks text file, also
one in another mask order), and the port's engines search the imported
index with the rows of the host engine on the original.  Twins of
tests/test_refformat.py's five tests, plus those."""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from torch_parity import rows_of, tree_bytes
from torch_parity import one_intra_op_thread  # noqa: F401  (autouse fixture)

from lexicmap_tpu.cli import format_hit_rows as jax_rows
from lexicmap_tpu.index import convert as jconv
from lexicmap_tpu.index import refformat as jrf
from lexicmap_tpu.index.search import IndexSearcher as JaxSearcher
from lexicmap_tpu.index.search import SearchOptions as JaxOptions
from lexicmap_tpu_torch.index import refformat as rf
from lexicmap_tpu_torch.index.build import BuildOptions, build_index
from lexicmap_tpu_torch.index.convert import export_reference_index, import_reference_index
from lexicmap_tpu_torch.index.search import IndexSearcher, SearchOptions
from lexicmap_tpu_torch.index.store import pack_2bit


def test_varint_gb_roundtrip():
    rng = np.random.default_rng(0)
    for _ in range(200):
        v1 = int(rng.integers(0, 1 << 62))
        v2 = int(rng.integers(0, 1 << 62))
        ctrl, data = rf.put_uint64s(v1, v2)
        assert (ctrl, data) == jrf.put_uint64s(v1, v2)
        r1, r2, n = rf.get_uint64s(ctrl, data, 0)
        assert (r1, r2, n) == (v1, v2, len(data))


def kv_case(seed, n_masks=8):
    rng = np.random.default_rng(seed)
    per_mask = []
    for _ in range(n_masks):
        nk = int(rng.integers(0, 30))
        kmers = np.sort(
            rng.choice(1 << 62, size=nk, replace=False).astype(np.uint64)
        ) if nk else np.empty(0, dtype=np.uint64)
        values = [
            rng.integers(0, 1 << 47, size=int(rng.integers(1, 5))).astype(np.uint64)
            for _ in range(nk)
        ]
        per_mask.append((kmers, values))
    return per_mask


def same_kv_files(per_mask, tmp_path, mask_offset, **kw):
    """Both writers' chunk (and .idx) of `per_mask` are the same bytes;
    returns the port's path."""
    paths = [str(tmp_path / f"{n}.bin") for n in ("torch", "jax")]
    for mod, path in zip((rf, jrf), paths):
        mod.write_kv_chunk(path, mask_offset, per_mask, k=31, mask_prefix=2, anchor_prefix=2,
                           **kw)
    for ext in ("", ".idx"):
        assert open(paths[0] + ext, "rb").read() == open(paths[1] + ext, "rb").read()
    return paths[0]


def test_kv_chunk_roundtrip(tmp_path):
    """The port reads back what it wrote, as does JAX's reader."""
    per_mask = kv_case(1)
    path = same_kv_files(per_mask, tmp_path, 16)
    for reader in (rf.read_kv_chunk, jrf.read_kv_chunk):
        mask_offset, got = reader(path)
        assert mask_offset == 16 and len(got) == 8
        for (k1, v1), (k2, v2) in zip(per_mask, got):
            assert k1.tolist() == k2.tolist()
            assert [a.tolist() for a in v1] == [a.tolist() for a in v2]


def test_kv_chunk_roundtrip_7byte(tmp_path):
    rng = np.random.default_rng(2)
    kmers = np.sort(rng.choice(1 << 62, size=11, replace=False).astype(np.uint64))
    values = [rng.integers(0, 1 << 47, size=2).astype(np.uint64) for _ in range(11)]
    path = same_kv_files([(kmers, values)], tmp_path, 0, use3=True)
    for reader in (rf.read_kv_chunk, jrf.read_kv_chunk):
        _, got = reader(path)
        assert got[0][0].tolist() == kmers.tolist()
        assert [a.tolist() for a in got[0][1]] == [a.tolist() for a in values]


def test_genome_file_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    recs = []
    for i in range(3):
        nb = int(rng.integers(50, 5000))
        codes = rng.integers(0, 4, size=nb).astype(np.uint8)
        recs.append(
            (f"G{i}".encode(), pack_2bit(codes).tobytes(), nb, nb - 10,
             [nb], [f"s{i}".encode()])
        )
    path = str(tmp_path / "genomes.bin")
    rf.write_genome_file(path, 7, recs)
    jrf.write_genome_file(str(tmp_path / "j.bin"), 7, recs)
    for ext in ("", ".idx"):
        assert open(path + ext, "rb").read() == open(str(tmp_path / "j.bin") + ext, "rb").read()
    batch, got = rf.read_genome_file(path)
    assert batch == 7
    for a, b in zip(recs, got):
        assert a == (b[0], b[1], b[2], b[3], b[4], b[5])


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """tests/test_refformat.py's index: three genomes of two contigs, in
    two genome batches, and JAX's export of it."""
    rng = np.random.default_rng(4)
    d = tmp_path_factory.mktemp("rrefs")
    files, seqs = [], {}
    for i in range(3):
        name = f"R{i}"
        contigs = [
            bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=25000)),
            bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=15000)),
        ]
        seqs[name] = contigs
        p = d / f"{name}.fasta"
        with open(p, "wb") as fh:
            for j, s in enumerate(contigs):
                fh.write(b">" + f"c{j}".encode() + b"\n" + s + b"\n")
        files.append(str(p))
    base = tmp_path_factory.mktemp("rdb")
    native1 = str(base / "n1.lmt")
    build_index(native1, files, BuildOptions(k=31, n_masks=512, chunks=3, batch_size=2))
    jref = str(base / "jax.lmi")
    jconv.export_reference_index(native1, jref)
    queries = []
    for name in seqs:
        q = bytearray(seqs[name][0][3000:4500])
        for _ in range(15):
            p = int(rng.integers(0, len(q)))
            q[p] = ord("ACGT"[int(rng.integers(0, 4))])
        queries.append(bytes(q))
    return native1, jref, queries


def rows_all(idx, queries, many):
    res = idx.search_many(queries) if many else [idx.search_bytes(q) for q in queries]
    return [rows_of(r, f"q{i}") for i, r in enumerate(res)]


def test_full_index_roundtrip(native, tmp_path):
    """native -> export(.lmi) -> import -> identical search results, through
    the host engine and the device engine (on the CPU)."""
    native1, _, queries = native
    ref = str(tmp_path / "ref.lmi")
    export_reference_index(native1, ref)
    for f in ("info.toml", "seeds/chunk_000.bin", "seeds/chunk_000.bin.idx",
              "genomes/batch_0000/genomes.bin.idx", "genomes/batch_0001/genomes.bin",
              "genomes.map.bin", "genomes.chunks.bin", "masks.tsv"):
        assert os.path.exists(os.path.join(ref, f)), f
    native2 = str(tmp_path / "n2.lmt")
    import_reference_index(ref, native2)
    want = rows_all(IndexSearcher(native1, SearchOptions(engine="host")), queries, False)
    assert all(want) and [r[0].split("\t")[3] for r in want] == ["R0", "R1", "R2"]
    assert rows_all(IndexSearcher(native2, SearchOptions(engine="host")), queries, False) == want
    dev = IndexSearcher(native2, SearchOptions(engine="device", device="cpu"))
    assert rows_all(dev, queries, True) == want
    jidx = JaxSearcher(native1, JaxOptions(engine="host"))
    assert [list(jax_rows(f"q{i}", 0, jidx.search_bytes(q)))
            for i, q in enumerate(queries)] == want


def test_export_equals_jax_export(native, tmp_path):
    native1, jref, _ = native
    ref = str(tmp_path / "ref.lmi")
    export_reference_index(native1, ref, verbose=True)
    got, want = tree_bytes(ref), tree_bytes(jref)
    assert sorted(got) == sorted(want) and len(got) >= 12
    for path in want:
        assert got[path] == want[path], path


def permuted_lmi(src, dst, seed):
    """A copy of the .lmi at `src` whose masks are in another order, as the
    reference keeps them (its mask order is not sorted): the seed chunks
    rewritten with each mask's postings under its new index, and a masks
    text file in the new order."""
    import shutil

    shutil.copytree(src, dst)
    info = rf.read_ref_info(os.path.join(src, "info.toml"))
    m = int(info["masks"])
    names = sorted(f for f in os.listdir(os.path.join(src, "seeds")) if f.endswith(".bin"))
    per_mask, bounds = [], []
    for n in names:
        off, pm = rf.read_kv_chunk(os.path.join(src, "seeds", n))
        bounds.append((off, off + len(pm)))
        per_mask += pm
    perm = np.random.default_rng(seed).permutation(m)  # new index -> old index
    per_mask = [per_mask[i] for i in perm]
    for n, (b, e) in zip(names, bounds):
        rf.write_kv_chunk(os.path.join(dst, "seeds", n), b, per_mask[b:e], int(info["max-K"]),
                          4, 6, use3=True)
    lines = open(os.path.join(src, "masks.tsv")).read().splitlines()
    codes = [s.split("\t")[-1] for s in lines]
    with open(os.path.join(dst, "masks.tsv"), "w") as fh:
        for new, old in enumerate(perm):
            fh.write(f"{new + 1}\t{codes[old]}\n")
    os.remove(os.path.join(dst, "masks.bin"))  # only the text file knows the order
    return os.path.join(dst, "masks.tsv")


@pytest.mark.parametrize("masks", ["bin", "text", "text_permuted"])
def test_import_equals_jax_import(native, tmp_path, masks):
    """The port's import of JAX's export (masks from masks.bin, from the
    masks text file, or from a masks text file in another order with the
    seeds re-tagged to match) is JAX's import byte for byte, and its
    postings are the original index's."""
    native1, jref, queries = native
    src, mfile = jref, None
    if masks == "text":
        mfile = os.path.join(jref, "masks.tsv")
    elif masks == "text_permuted":
        src = str(tmp_path / "perm.lmi")
        mfile = permuted_lmi(jref, src, seed=9)
    got, want = str(tmp_path / "t.lmt"), str(tmp_path / "j.lmt")
    import_reference_index(src, got, mfile)
    jconv.import_reference_index(src, want, mfile)
    tg, tw = tree_bytes(got), tree_bytes(want)
    assert sorted(tg) == sorted(tw)
    for path in tw:
        assert tg[path] == tw[path], path
    orig = tree_bytes(native1)
    for path in orig:
        if path.startswith("seeds") or path == "masks.bin":
            assert tg[path] == orig[path], path
    host = IndexSearcher(native1, SearchOptions(engine="host"))
    assert rows_all(IndexSearcher(got, SearchOptions(engine="device", device="cpu")),
                    queries, True) == rows_all(host, queries, False)


def test_import_refuses_mismatched_masks_text(native, tmp_path):
    native1, jref, _ = native
    bad = tmp_path / "m.tsv"
    bad.write_text("".join(open(os.path.join(jref, "masks.tsv")).readlines()[:100]))
    for fn in (import_reference_index, jconv.import_reference_index):
        with pytest.raises(ValueError, match="does not match"):
            fn(jref, str(tmp_path / "x.lmt"), str(bad))
