"""The port's device capture (`DeviceCaptureEngine`, the capture kernels'
plain twin on the CPU) against the JAX package's `DeviceCaptureEngine` (JAX
on the CPU) and the port's native `capture_native_call`, on the same
numpy-seeded genomes.  Tolerance: exact; the outputs are integers (equal
counts, equal k-mers on every mask, equal positions).

The JAX engine runs over small slabs here (its module's SLAB patched, as
tests/test_build_device.py does), so that winners sit on slab boundaries
and its CPU compile stays short; the port has no slabs."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from torch_parity import capture_cases
from torch_parity import one_intra_op_thread  # noqa: F401  (autouse fixture)

from lexicmap_tpu.masks import MaskSet as JaxMaskSet
from lexicmap_tpu.parallel import build_device as JBD
from lexicmap_tpu_torch.kernels.capture import DENSE_MAX_P, bucket_table
from lexicmap_tpu_torch.masks import MaskSet
from lexicmap_tpu_torch.native import capture_native_call, get_lib
from lexicmap_tpu_torch.parallel.build_device import DeviceCaptureEngine
from lexicmap_tpu_torch.utils.kmers import kmers_fwd_rc

pytestmark = pytest.mark.skipif(get_lib() is None, reason="native lib unavailable")

SLAB = 1 << 15


@pytest.fixture
def small_slab(monkeypatch):
    monkeypatch.setattr(JBD, "SLAB", SLAB)


def native(ms, codes, exclude):
    fwd, rc = kmers_fwd_rc(codes, ms.k)
    return capture_native_call(fwd, rc, exclude, ms.masks, ms.k, ms.distinct_prefix_len, False)


def assert_same(got, want):
    assert got is not None and want is not None
    for a, b, name in zip(got, want, ("kmers", "counts", "pos_flat")):
        assert a.dtype == b.dtype, name
        assert a.shape == b.shape, name
        assert (a == b).all(), (name, np.nonzero(a != b)[0][:5])


def check(ms, codes, exclude=None, jax_too=True):
    """The port's capture == native, and == the JAX engine's when
    `jax_too`; returns the port's result."""
    got = DeviceCaptureEngine(ms, device="cpu").capture(codes, exclude)
    assert_same(got, native(ms, codes, exclude))
    if jax_too:
        jms = JaxMaskSet(ms.masks, ms.k, ms.seed)
        assert_same(got, JBD.DeviceCaptureEngine(jms).capture(codes, exclude))
    return got


def rand_codes(seed, n):
    return np.random.default_rng(seed).integers(0, 4, size=n, dtype=np.uint8)


@pytest.fixture(scope="module")
def ms():
    return MaskSet.generate(31, 512, 1)


def test_random_genome(ms, small_slab):
    got = check(ms, rand_codes(31, 80_000))
    assert (got[1] > 0).sum() > 100


def test_winners_on_slab_boundaries(small_slab):
    """Strong winners planted across the JAX slab boundaries, read by both
    strands (the rc k-mer at i reads codes[i+k-1] down to codes[i]), and at
    the genome's first and last positions."""
    ms2 = MaskSet.generate(31, 64, 1)
    codes = rand_codes(35, 3 * SLAB + 777)
    k = ms2.k
    for j, s in enumerate((SLAB, 2 * SLAB, 3 * SLAB)):
        codes[s - 15: s - 15 + k] = mask_kmer_codes(ms2.masks[7 * j + 3], k)
    codes[:k] = mask_kmer_codes(ms2.masks[1], k)
    codes[-k:] = 3 - np.array([(int(ms2.masks[2]) >> (2 * t)) & 3 for t in range(k)],
                              dtype=np.uint8)
    got = check(ms2, codes)
    assert got[0][1] == ms2.masks[1] and got[0][2] == ms2.masks[2]
    assert got[2][got[1][:1].sum()] == 0  # mask 1 wins at location 0 (forward, position 0)


def test_with_exclusions_and_repeats(ms, small_slab):
    codes = rand_codes(32, 60_000)
    codes[30_000:31_000] = codes[10_000:11_000]
    codes[45_000:45_500] = codes[10_000:10_500]
    exclude = np.zeros(codes.shape[0] - ms.k + 1, dtype=bool)
    exclude[20_000:21_500] = True
    exclude[:50] = True
    exclude[-40:] = True
    got = check(ms, codes, exclude)
    assert (got[1] > 1).any()


def test_several_slabs(small_slab):
    ms2 = MaskSet.generate(31, 256, 1)
    codes = rand_codes(33, 150_000)
    codes[100_000:101_000] = codes[20_000:21_000]  # a repeat across slabs
    check(ms2, codes)


@pytest.mark.parametrize("k", [21, 31, 32])
def test_k(k, small_slab):
    """k = 32 fills the 64 bits: kmer ^ mask must compare unsigned."""
    ms2 = MaskSet.generate(k, 256, 7)
    codes = rand_codes(40 + k, 50_000)
    codes[30_000:30_600] = codes[5_000:5_600]
    got = check(ms2, codes)
    if k == 32:
        assert (got[0] >= np.uint64(1 << 63)).any()


def mask_kmer_codes(mask, k):
    """The k bases whose forward k-mer is `mask`."""
    return np.array([(int(mask) >> (2 * (k - 1 - t))) & 3 for t in range(k)], dtype=np.uint8)


def test_mask_with_thousands_of_locations(ms, small_slab):
    """A 1 kb block copied 40 times, and a tandem repeat of one mask's own
    k-mer 2,100 times: that mask wins at 2,100 locations (the card's kernel
    sorts such a slice with a block); still within the JAX slab's 65,536
    output lanes."""
    codes = rand_codes(37, 120_000)
    block = codes[1_000:2_000].copy()
    for c in range(40):
        codes[5_000 + c * 1_500: 6_000 + c * 1_500] = block
    codes[50_000: 50_000 + 2_100 * ms.k] = np.tile(mask_kmer_codes(ms.masks[5], ms.k), 2_100)
    got = check(ms, codes)
    assert got[1][5] >= 2_100 and got[0][5] == ms.masks[5]
    assert (got[1] > 1).sum() >= 2


def homopolymer_base(ms):
    """A base whose homopolymer k-mer falls in a mask's bucket."""
    table = bucket_table(ms.masks, ms.k, ms.distinct_prefix_len)
    for b in range(4):
        if table[int("".join("0123"[b] * ms.distinct_prefix_len), 4)] >= 0:
            return b
    raise AssertionError("no homopolymer bucket holds a mask")


def test_beyond_jax_output_lanes(ms, monkeypatch):
    """A homopolymer genome whose k-mer wins its mask everywhere: more winning locations in one JAX slab (2^17 positions here)
    than its C_TOTAL output lanes, so the JAX engine returns None (its
    build then takes the host capture); the port stays exact, held against
    native alone."""
    monkeypatch.setattr(JBD, "SLAB", 1 << 17)
    codes = np.full(140_000, homopolymer_base(ms), dtype=np.uint8)
    got = check(ms, codes, jax_too=False)
    assert got[1].sum() > JBD.C_TOTAL
    jms = JaxMaskSet(ms.masks, ms.k, ms.seed)
    assert JBD.DeviceCaptureEngine(jms).capture(codes, None) is None


def test_genome_shorter_than_k(ms):
    codes = rand_codes(1, ms.k - 1)
    assert DeviceCaptureEngine(ms, device="cpu").capture(codes, None) is None
    assert JBD.DeviceCaptureEngine(JaxMaskSet(ms.masks, ms.k, ms.seed)).capture(codes, None) is None


def test_genome_of_exactly_k_bases(ms):
    check(ms, rand_codes(2, ms.k), jax_too=False)


def test_everything_excluded(ms):
    codes = rand_codes(3, 5_000)
    got = check(ms, codes, np.ones(codes.shape[0] - ms.k + 1, dtype=bool), jax_too=False)
    assert got[1].sum() == 0 and got[2].shape == (0,)


def _masks_sharing(lcp, k=31, seed=5, m=64):
    """m random masks, two of which share exactly `lcp` leading bases, so
    the set's distinct prefix is lcp + 1."""
    rng = np.random.default_rng(seed)
    masks = rng.integers(0, 1 << 62, size=m, dtype=np.uint64) & np.uint64((1 << (2 * k)) - 1)
    masks[1] = masks[0] ^ np.uint64(1 << (2 * (k - lcp) - 1))
    return masks


def test_sparse_bucket_table(small_slab):
    """A distinct prefix past DENSE_MAX_P: the bucket table is the masks'
    sorted bucket ids, searched by bisection."""
    ms2 = MaskSet(_masks_sharing(13), 31, 0)
    p = ms2.distinct_prefix_len
    assert p == 14 > DENSE_MAX_P
    assert bucket_table(ms2.masks, 31, p).shape == (ms2.m,)
    codes = rand_codes(41, 40_000)
    for i, mk in enumerate(ms2.masks[:8]):  # plant each of the first masks' k-mer
        codes[1_000 + 100 * i: 1_031 + 100 * i] = mask_kmer_codes(mk, 31)
    got = check(ms2, codes)
    assert (got[1] > 0).sum() >= 8


def test_prefix_beyond_key_width_raises_in_both():
    masks = _masks_sharing(15)
    ms2 = MaskSet(masks, 31, 0)
    assert ms2.distinct_prefix_len == 16
    assert not DeviceCaptureEngine.supported(ms2)
    with pytest.raises(ValueError, match="key width"):
        DeviceCaptureEngine(ms2, device="cpu")
    with pytest.raises(ValueError, match="key width"):
        JBD.DeviceCaptureEngine(JaxMaskSet(masks, 31, 0))


def test_mask_sets_equal_at_index_default():
    """The engine is built from the port's MaskSet: at the index default of
    20,000 masks (seed 1) its masks equal the JAX package's."""
    a = MaskSet.generate(31, 20_000, 1)
    b = JaxMaskSet.generate(31, 20_000, 1)
    assert a.masks.dtype == b.masks.dtype and (a.masks == b.masks).all()
    assert a.distinct_prefix_len == b.distinct_prefix_len == 8


def test_cuda_without_a_card_raises(ms, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceCaptureEngine(ms)


CAPTURE_CASES = capture_cases()


@pytest.mark.parametrize("case", range(len(CAPTURE_CASES)),
                         ids=[c[0] for c in CAPTURE_CASES])
def test_capture_cases_equal_jax_and_native(case, small_slab):
    """tests/torch_parity.py::capture_cases (the card's kernel tests run the
    same genomes): the port's capture == native == the JAX engine's."""
    _, masks, k, codes, exclude = CAPTURE_CASES[case]
    check(MaskSet(masks, k), codes, exclude)
