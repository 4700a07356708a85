"""The port's resident genome blob (parallel/resident.py) vs the JAX
package's: extract_packed_plain (kernels/pseudo_align.py) == JAX
extract_packed == the host's pack_codes_2bit over GenomeStoreReader
windows, both strands, across word boundaries and store batches (a twin of
tests/test_resident.py)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from lexicmap_tpu.index.store import GenomeStoreReader as JaxStoreReader
from lexicmap_tpu.parallel.resident import DeviceGenomeBlob as JaxBlob
from lexicmap_tpu.parallel.resident import extract_packed
from lexicmap_tpu_torch.index.store import GenomeStoreReader, GenomeStoreWriter, pack_2bit
from lexicmap_tpu_torch.kernels.pseudo_align import extract_packed_plain, unpack_codes
from lexicmap_tpu_torch.parallel.pseudo_device import pack_codes_2bit
from lexicmap_tpu_torch.parallel.resident import DeviceGenomeBlob, normalize_blob


def _write_store(d, batch, lens, seed):
    w = GenomeStoreWriter(str(d), batch)
    rng = np.random.default_rng(seed)
    for i, L in enumerate(lens):
        w.write(b"g%d" % i, rng.integers(0, 4, L).astype(np.uint8), [L], [b"s%d" % i])
    w.close()
    return GenomeStoreReader(str(d))


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return _write_store(tmp_path_factory.mktemp("tgstore"), 0, [1000, 37, 4096, 517], 7)


def test_normalize_blob_roundtrip():
    codes = np.random.default_rng(1).integers(0, 4, 64).astype(np.uint8)
    norm = normalize_blob(pack_2bit(codes))
    assert [(int(norm[i // 16]) >> (2 * (i % 16))) & 3 for i in range(64)] == codes.tolist()


def _host_window(store, g, t0, t1, rc):
    codes = store.subseq_codes(g, t0, t1)
    return (np.uint8(3) - codes)[::-1] if rc else codes


def _extract_both(blob, jblob, cases, words_out, batch=0):
    geo = [blob.geometry(batch, g, t0, t1, rc, words_out) for g, t0, t1, rc in cases]
    assert geo == [jblob.geometry(batch, g, t0, t1, rc, words_out) for g, t0, t1, rc in cases]
    wb = np.array([x[0] for x in geo], dtype=np.int64)
    ph = np.array([x[1] for x in geo], dtype=np.int32)
    ln = np.array([x[2] for x in geo], dtype=np.int32)
    rcs = np.array([c[3] for c in cases], dtype=bool)
    got = extract_packed_plain(blob.words, torch.from_numpy(wb), torch.from_numpy(ph),
                               torch.from_numpy(ln), torch.from_numpy(rcs), words_out)
    want = np.asarray(jax.jit(extract_packed, static_argnums=5)(
        jblob.d_blob, wb.astype(np.int32), ph, ln, rcs, words_out))
    return got.numpy().view(np.uint32), want


@pytest.mark.parametrize("words_out", [8, 256])
def test_extract_matches_jax_and_host(store, words_out):
    blob = DeviceGenomeBlob([store], device="cpu")
    jblob = JaxBlob([JaxStoreReader(store.dir)])
    assert np.array_equal(blob.words.numpy().view(np.uint32), np.asarray(jblob.d_blob))
    rng = np.random.default_rng(3)
    cases = []
    for g in range(len(store)):
        glen = int(store.lens[g])
        for _ in range(6):
            t0 = int(rng.integers(0, glen))
            t1 = min(int(t0 + rng.integers(1, 16 * words_out)), glen - 1)
            cases += [(g, t0, t1, False), (g, t0, t1, True)]
    cases += [(0, 0, 15, False), (0, 0, 15, True), (2, 0, 16 * words_out - 1, False),
              (2, 4080, 4095, True), (1, 0, 36, True), (1, 0, 36, False)]
    cases = [c for c in cases if c[2] - c[1] + 1 <= 16 * words_out]
    got, want = _extract_both(blob, jblob, cases, words_out)
    assert np.array_equal(got, want)
    for i, (g, t0, t1, rc) in enumerate(cases):
        assert np.array_equal(got[i], pack_codes_2bit(_host_window(store, g, t0, t1, rc),
                                                      16 * words_out)), cases[i]


def test_unpack_codes(store):
    blob = DeviceGenomeBlob([store], device="cpu")
    wb, ph, ln = blob.geometry(0, 2, 100, 1000, False, 64)
    packed = extract_packed_plain(blob.words, torch.tensor([wb]), torch.tensor([ph]),
                                  torch.tensor([ln]), torch.tensor([False]), 64)
    codes = unpack_codes(packed)[0].numpy()
    want = store.subseq_codes(2, 100, 1000)
    assert np.array_equal(codes[: want.shape[0]], want)
    assert (codes[want.shape[0]:] == 0).all()


def test_multi_store_code_base(tmp_path):
    """A later batch's windows resolve through store_code_base; the blob is
    filled batch by batch into one allocation equal to the JAX blob."""
    rng = np.random.default_rng(11)
    stores = [_write_store(tmp_path / f"b{b}", b, rng.integers(50, 300, size=3).tolist(), b)
              for b in range(3)]
    blob = DeviceGenomeBlob(stores, device="cpu")
    jblob = JaxBlob([JaxStoreReader(s.dir) for s in stores])
    assert blob.store_code_base == jblob.store_code_base
    assert np.array_equal(blob.words.numpy().view(np.uint32), np.asarray(jblob.d_blob))
    for b, st in enumerate(stores):
        cases = []
        for g in range(len(st)):
            glen = int(st.lens[g])
            cases += [(g, 3, glen - 2, False), (g, 3, glen - 2, True)]
        got, want = _extract_both(blob, jblob, cases, 32, batch=b)
        assert np.array_equal(got, want)
        for i, (g, t0, t1, rc) in enumerate(cases):
            assert np.array_equal(got[i], pack_codes_2bit(_host_window(st, g, t0, t1, rc), 512))
