"""The gap-affine WFA (B8) on the CPU: the kernels' plain twin and the
port's DeviceWFA against ops/wfa.py::wfa_align (the native WFA) op for op
and against the JAX package's DeviceWFA (JAX on its CPU backend)."""

import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from torch_parity import (
    mutate_pair,
    wfa_bucket_mix,
    wfa_edge_cases,
    wfa_pairs,
    wfa_span_pair,
    wfa_span_replay,
    wfa_tensors,
)
from torch_parity import one_intra_op_thread  # noqa: F401  (autouse fixture)
from torch_parity import rec  # noqa: F401  (fixture)

from lexicmap_tpu.parallel.wfa_device import DeviceWFA as JaxWFA
from lexicmap_tpu_torch.kernels import wfa as WK
from lexicmap_tpu_torch.ops.wfa import wfa_align
from lexicmap_tpu_torch.kernels.runtime import fetch_numpy
from lexicmap_tpu_torch.parallel import wfa_device as WD


@pytest.fixture(scope="module")
def pairs():
    return wfa_pairs()


def host_ops(pairs):
    return [wfa_align(q, t).ops for q, t in pairs]


def test_device_wfa_equals_host_and_jax(pairs, rec):
    """CASES of tests/test_wfa_device.py, pure indels, identical pairs, and
    a pair of unrelated sequences that overflows its bucket and is realigned
    by the host."""
    dw = WD.DeviceWFA(device="cpu")
    launches = WK.wfa_batch.launches
    got = dw.align_batch(pairs)
    want = host_ops(pairs)
    assert got == want
    assert got == JaxWFA().align_batch(pairs)
    t = rec.totals
    assert (t["wfa.card_pairs"], t["wfa.host_pairs"], t["wfa.flagged_pairs"]) == (
        len(pairs) - 1, 1, 1)
    assert WK.wfa_batch.launches == launches  # the plain version on the CPU


def test_identical_sequences():
    rng = np.random.default_rng(7)
    q = rng.integers(0, 4, size=777).astype(np.uint8)
    assert WD.DeviceWFA(device="cpu").align_batch([(q, q.copy())]) == [[("M", 777)]]


def test_mixed_buckets_and_host_pairs(rec):
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
    t = rec.totals
    assert (t["wfa.card_pairs"], t["wfa.host_pairs"], t["wfa.flagged_pairs"]) == (3, 3, 0)


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


def test_threads_share_one_aligner(rec):
    """align_batch from several threads at once, each thread's counters to
    one recorder (as the phase-5 pool's threads do): every result is the
    host's and the counters add up."""
    import sys

    rng = np.random.default_rng(9)
    batches = [[mutate_pair(rng, 150, 0.04, 0.01) for _ in range(3)] for _ in range(6)]
    want = [host_ops(b) for b in batches]
    dw = WD.DeviceWFA(device="cpu")
    got = [None] * len(batches)

    def run(i):
        rec.bind_thread()
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
    assert rec.totals["wfa.card_pairs"] == 18 and rec.counts["wfa.card_pairs"] == 6
    assert rec.totals["wfa.host_pairs"] == 0


def test_span_replay_equals_plain_counts(pairs):
    """The forward kernel's schedule (a warp a pair over each score's span,
    32 diagonals a pass), replayed from the plain pass's history: the
    spans' cells are the native row widths the plain pass counts, one span
    a computed row, and the kernel writes three history cells a diagonal
    of them (and three for score 0) instead of 3 x W a row."""
    S, W = 1024, 128
    work = {}
    hist, lo, done, _ = WK._forward(*wfa_tensors(pairs), S, W, 4, 6, 2, 10, 50, work=work)
    rep = wfa_span_replay(hist, lo, done)
    assert sum(r["cells"] for r in rep) == work["cells"]
    assert sum(len(r["spans"]) for r in rep) == work["rows"]
    assert sum(r["hist_cells"] for r in rep) == 3 * (work["cells"] + len(pairs))
    assert sum(r["passes"] for r in rep) < 2 * work["rows"]
    assert all(r["max_span"] <= W for r, d in zip(rep, done.tolist()) if d >= 0)
    assert rep[-1]["max_span"] == W + 1  # the unrelated pair overflows W
    for r, d in zip(rep, done.tolist()):  # even penalties: every odd score is dead
        if d > 0:
            assert r["dead"] + len(r["spans"]) == d and r["dead"] >= d // 2


@pytest.mark.parametrize("span", [32, 33, 128, 129])
def test_span_pairs_are_at_their_boundary(span):
    """The edge pairs' largest span is exactly the one they stand for."""
    args = wfa_tensors([wfa_span_pair(span)])
    hist, lo, done, _ = WK._forward(*args, 4096, 256, 4, 6, 2, 10, 50)
    assert int(done[0]) >= 0
    assert wfa_span_replay(hist, lo, done)[0]["max_span"] == span


@pytest.mark.parametrize("case", range(10))
def test_wfa_edges_plain_equals_host(case):
    """At the kernels' boundaries (span 32/33, W/W+1, end at score S-1 or
    S, exactly CAP runs or one more): a pair is answered exactly when the
    case says, and then equals wfa_align."""
    name, ps, S, W, CAP, answered = wfa_edge_cases()[case]
    ops, cnts, nops = WK.wfa_batch(*wfa_tensors(ps), S, W, CAP)
    got = WK.decode_ops(ops.numpy(), cnts.numpy(), nops.numpy())
    assert (got[0] is not None) == answered, name
    if answered:
        assert got == host_ops(ps), name


def test_outputs_fetch_in_one_copy(rec):
    """fetch_numpy: views of one buffer (the wrapper's outputs on the card)
    come back in one copy, timed as one wait on the card; separate tensors
    (the plain version's) one by one, also timed as one wait."""
    B, CAP = 3, 5
    out = torch.arange(B * (4 + 5 * CAP), dtype=torch.uint8)
    nops = out[: 4 * B].view(torch.int32)
    cnts = out[4 * B: 4 * B * (1 + CAP)].view(torch.int32).view(B, CAP)
    ops = out[4 * B * (1 + CAP):].view(torch.int8).view(B, CAP)
    for ts in ((ops, cnts, nops), (ops.clone(), cnts.clone(), nops.clone())):
        got = fetch_numpy("test fetch", *ts)
        assert all(g.dtype == t.numpy().dtype and np.array_equal(g, t.numpy())
                   for g, t in zip(got, ts))
        assert sum(g.nbytes for g in got) == out.numel()
        if ts[0].untyped_storage().data_ptr() == out.untyped_storage().data_ptr():
            assert all(g.base is got[0].base is not None for g in got)  # one host buffer
    assert rec.counts["card_wait"] == 2


def test_device_wfa_one_fetch_per_launch(monkeypatch, rec):
    """_align_chunk uploads a launch's words, offsets and lengths in one
    copy and brings ops, counts and run counts back in one: a launch's
    waits on the card are its size read and that one fetch."""
    rng = np.random.default_rng(5)
    pairs = [mutate_pair(rng, 200, 0.03, 0.01) for _ in range(5)]
    monkeypatch.setattr(WD, "HIST_BYTES", 2 * WK.history_bytes(1, *WD.BUCKETS[0][1:]))
    assert WD.DeviceWFA(device="cpu").align_batch(pairs) == host_ops(pairs)
    assert rec.counts["card_wait"] == 2 * 3  # launches of 2, 2, 1


@pytest.mark.parametrize("sub_rate", [0.005, 0.02, 0.05])
def test_history_sized_to_what_pairs_write(sub_rate, rec):
    """Size, then write: the plain twin's per-pair history cells are the
    cells the forward kernel writes (wfa_span_replay's hist_cells, 3 x
    (cells + 1)), 0 for the flagged pair, over pairs in three buckets; a
    DeviceWFA call tallies under `wfa.hist_bytes` the sum over its launches
    (one a bucket here) of those sizes, each rounded up to ALIGN cells,
    plus the row tables and final scores, and waits on the card twice a
    launch: the size read back, then the outputs."""
    pairs = wfa_bucket_mix(sub_rate)
    groups = {}
    for p in pairs:
        groups.setdefault(WD.bucket_for(len(p[0]), len(p[1])), []).append(p)
    assert list(groups) == list(WD.BUCKETS[:3])
    want_bytes = flagged = 0
    for (_, S, W), group in groups.items():
        hist, lo, done, cells = WK._forward(*wfa_tensors(group), S, W, 4, 6, 2, 10, 50)
        rep = wfa_span_replay(hist, lo, done)
        assert cells.tolist() == [r["hist_cells"] if d >= 0 else 0
                                  for r, d in zip(rep, done.tolist())]
        assert cells.tolist() == [3 * (r["cells"] + 1) if d >= 0 else 0
                                  for r, d in zip(rep, done.tolist())]
        rounded = sum(-(-c // WK.ALIGN) * WK.ALIGN for c in cells.tolist())
        assert int(WK.packed_offsets(cells)[-1]) == rounded
        want_bytes += 2 * rounded + len(group) * (8 * S + 4)
        assert WK.history_bytes_packed(rounded, len(group), S) < WK.history_bytes(len(group), S, W)
        flagged += int((done < 0).sum())
    assert flagged == 1  # the unrelated pair, sized 0

    dw = WD.DeviceWFA(device="cpu")
    assert dw.align_batch(pairs) == host_ops(pairs)
    assert rec.totals["wfa.hist_bytes"] == want_bytes
    assert rec.counts["wfa.hist_bytes"] == 1
    assert rec.totals["wfa.flagged_pairs"] == 1
    assert rec.counts["card_wait"] == 2 * len(groups)
