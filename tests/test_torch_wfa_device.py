"""The gap-affine WFA (B8) on the CPU: the kernels' plain twin and the
port's DeviceWFA against ops/wfa.py::wfa_align (the native WFA) op for op
and against the JAX package's DeviceWFA (JAX on its CPU backend)."""

import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from torch_parity import mutate_pair, wfa_pairs, wfa_tensors
from torch_parity import one_intra_op_thread  # noqa: F401  (autouse fixture)

from lexicmap_tpu.parallel.wfa_device import DeviceWFA as JaxWFA
from lexicmap_tpu_torch.kernels import wfa as WK
from lexicmap_tpu_torch.ops.wfa import wfa_align
from lexicmap_tpu_torch.parallel import wfa_device as WD


@pytest.fixture(scope="module")
def pairs():
    return wfa_pairs()


def host_ops(pairs):
    return [wfa_align(q, t).ops for q, t in pairs]


def test_device_wfa_equals_host_and_jax(pairs):
    """CASES of tests/test_wfa_device.py, pure indels, identical pairs, and
    a pair of unrelated sequences that overflows its bucket and is realigned
    by the host."""
    dw = WD.DeviceWFA(device="cpu")
    got = dw.align_batch(pairs)
    want = host_ops(pairs)
    assert got == want
    assert got == JaxWFA().align_batch(pairs)
    assert dw.stats == {"pairs": len(pairs), "device_pairs": len(pairs) - 1, "host_pairs": 0,
                        "flagged_pairs": 1}
    assert dw.launches == 0  # the plain version on the CPU


def test_identical_sequences():
    rng = np.random.default_rng(7)
    q = rng.integers(0, 4, size=777).astype(np.uint8)
    assert WD.DeviceWFA(device="cpu").align_batch([(q, q.copy())]) == [[("M", 777)]]


def test_mixed_buckets_and_host_pairs():
    """Pairs in three buckets plus pairs with an empty side and one past
    the last bucket (host, without a launch)."""
    rng = np.random.default_rng(3)
    pairs = [mutate_pair(rng, 100, 0.03, 0.01), mutate_pair(rng, 900, 0.03, 0.01),
             mutate_pair(rng, 3000, 0.02, 0.004)]
    q = pairs[0][0]
    pairs += [(q, q[:0]), (q[:0], q), mutate_pair(rng, WD.BUCKETS[-1][0] + 1, 0.0, 0.0)]
    dw = WD.DeviceWFA(device="cpu")
    got = dw.align_batch(pairs)
    assert got == host_ops(pairs)
    assert got[:3] == JaxWFA().align_batch(pairs[:3])
    assert dw.stats == {"pairs": 6, "device_pairs": 3, "host_pairs": 3, "flagged_pairs": 0}


@pytest.mark.parametrize("S, W", [(1024, 128), (40, 128), (1024, 32)])
def test_wfa_batch_plain_overflow(pairs, S, W):
    """wfa_batch on the CPU (the plain version): a pair answered within the
    S scores and W diagonals equals wfa_align; a smaller S or W flags more
    pairs (nops -1), and never changes an answered one."""
    sub = pairs[15:] + pairs[:3]
    ops, cnts, nops = WK.wfa_batch(*wfa_tensors(sub), S, W, S + 8)
    got = WK.decode_ops(ops.numpy(), cnts.numpy(), nops.numpy())
    want = host_ops(sub)
    answered = [g for g in got if g is not None]
    assert all(g is None or g == w for g, w in zip(got, want))
    if (S, W) == (1024, 128):
        assert sum(g is None for g in got) == 1  # the unrelated pair
    else:
        assert 0 < len(answered) < len(sub) - 1


def test_wfa_batch_checks():
    args = wfa_tensors([mutate_pair(np.random.default_rng(1), 50, 0.02, 0.0)])
    with pytest.raises(ValueError):
        WK.wfa_batch(*args, 64, 100, 72)  # W not a multiple of 32
    with pytest.raises(ValueError):
        WK.wfa_batch(*args, 64, 512, 72)
    bad = list(args)
    bad[3] = torch.tensor([WK.L_MAX + 1], dtype=torch.int32)
    with pytest.raises(ValueError):
        WK.wfa_batch(*bad, 64, 128, 72)
    bad = list(args)
    bad[1] = torch.tensor([args[0].shape[0]], dtype=torch.int64)
    with pytest.raises(ValueError):
        WK.wfa_batch(*bad, 64, 128, 72)
    with pytest.raises(TypeError):
        WK.wfa_batch(args[0], args[1], args[2], args[3].long(), args[4], 64, 128, 72)


def test_pack_words_round_trip():
    rng = np.random.default_rng(2)
    seqs = [rng.integers(0, 4, n).astype(np.uint8) for n in (1, 31, 32, 33, 64, 100)]
    words, offs = WK.pack_words(seqs)
    u = words.view(np.uint64)
    for s, o in zip(seqs, offs):
        got = [(int(u[o + i // 32]) >> (62 - 2 * (i % 32))) & 3 for i in range(s.shape[0])]
        assert got == s.tolist()
        assert int(u[o + s.shape[0] // 32 + 1]) == 0  # the padding word


def test_memory_bound_cuts_launches(monkeypatch):
    """A bucket's pairs are cut into launches whose history fits
    HIST_BYTES; the results do not change."""
    rng = np.random.default_rng(4)
    pairs = [mutate_pair(rng, 200, 0.03, 0.01) for _ in range(5)]
    calls = []
    real = WD.DeviceWFA._align_chunk

    def spy(self, bucket, chunk):
        calls.append(len(chunk))
        return real(self, bucket, chunk)

    monkeypatch.setattr(WD.DeviceWFA, "_align_chunk", spy)
    monkeypatch.setattr(WD, "HIST_BYTES", 2 * WK.history_bytes(1, *WD.BUCKETS[0][1:]))
    assert WD.DeviceWFA(device="cpu").align_batch(pairs) == host_ops(pairs)
    assert calls == [2, 2, 1]


def test_threads_share_one_aligner():
    """align_batch from several threads at once: every result is the
    host's and the counters add up."""
    import sys

    rng = np.random.default_rng(9)
    batches = [[mutate_pair(rng, 150, 0.04, 0.01) for _ in range(3)] for _ in range(6)]
    want = [host_ops(b) for b in batches]
    dw = WD.DeviceWFA(device="cpu")
    got = [None] * len(batches)

    def run(i):
        got[i] = dw.align_batch(batches[i])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=run, args=(i,)) for i in range(len(batches))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert got == want
    assert dw.stats["pairs"] == dw.stats["device_pairs"] == 18
