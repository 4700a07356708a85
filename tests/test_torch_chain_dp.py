"""pseudo_chain's plain version against the native Chainer2 of both
packages (the port's native/core.cpp and the JAX package's, each through
its own chain2_forward_native / chain2_backtrack_native) on the chain
stress windows of tests/torch_parity.py, on the CPU: its DP (`_chain_dp`:
scores and prev) against the forward pass, and its rows against the
backtrack (with align_paths' single-anchor rule).  The windows are also
held to reach every edge case of the kernel's warp DP, named from the
plain DP's scores and scan cuts.  tests/test_torch_cuda.py and
chip_smoke.py hold the kernel against the plain version on the same
windows."""

import numpy as np
import pytest
import torch

from torch_parity import CHAIN_PARAMS, chain_stress_windows, chain_tensors

import lexicmap_tpu.native as jax_native
import lexicmap_tpu_torch.native as torch_native
from lexicmap_tpu_torch.kernels import pseudo_align as PA

pytestmark = pytest.mark.skipif(
    torch_native.get_lib() is None or jax_native.get_lib() is None,
    reason="native lib unavailable")

#: (name, chain2_forward_native, chain2_backtrack_native) of each package
ORACLES = [(mod.__name__, mod.chain2_forward_native, mod.chain2_backtrack_native)
           for mod in (torch_native, jax_native)]
WINDOWS = chain_stress_windows(a_cap=PA.A_CAP)
# the A_CAP window alone (the plain DP pads every window of a launch to the
# longest one), under the search defaults only: the card's tests hold the
# kernel to the plain version on it under every parameter set
GROUPS = {"small": [w for w in WINDOWS if w[0].shape[0] < PA.A_CAP],
          "a_cap": [w for w in WINDOWS if w[0].shape[0] == PA.A_CAP]}
CASES = [("small", p) for p in range(len(CHAIN_PARAMS))] + [("a_cap", 0)]


@pytest.fixture(autouse=True)
def one_thread():
    """The plain DP is thousands of small tensor steps: run them on one
    thread, so that the thread pools of other test processes on a busy
    machine do not stall every step."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plain_dp(wins, band_base, band_count, max_gap):
    """`_chain_dp` over windows: (scores, prev, cut) int64 [W, N]."""
    qb, tb, ln, counts, _ = chain_tensors(wins)
    N = int(counts.max())
    return PA._chain_dp(*(a[:, :N].to(torch.int64) for a in (qb, tb, ln)),
                        counts.to(torch.int64), band_base, band_count, max_gap)


def dp_events(qb, tb, ln, scores, cut, band_count, max_gap):
    """The cases one window's DP meets, named from the plain DP's scores
    and scan cuts.  Anchor i's scan visits j = i - 1 down to cut[i] (or 0);
    a visit's lane is (i - 1 - j) % 32, its chunk (i - 1 - j) // 32: the
    kernel's warp visits 32 predecessors per step."""
    ev = set()
    msl = scores + ln
    for i in range(1, qb.shape[0]):
        c = int(cut[i])
        j = np.arange(i - 1, max(c, 0) - 1, -1)  # the visits, in scan order
        if c >= 0:
            ev.add(f"break_lane{(i - 1 - c) % 32}")
            j = j[:-1]  # the breaking j does not score
        lane, chunk = (i - 1 - j) % 32, (i - 1 - j) // 32
        eq, above = qb[j] == qb[i], tb[j] > tb[i]
        ev |= {"equal_qb"} if eq.any() else set()
        ev |= {"bt_gt_at"} if (above & ~eq).any() else set()
        elig = ~eq & ~above
        reach = np.nonzero(elig & (np.cumsum(elig) == band_count))[0]
        if reach.size and 0 < lane[reach[0]] < 31:
            ev.add("band_count_mid_chunk")
        g = np.abs((qb[i] - qb[j]) - (tb[i] - tb[j]))
        s = np.where(elig & (g <= max_gap), msl[j] - g, np.iinfo(np.int64).min)
        best = s.max(initial=np.iinfo(np.int64).min)
        if best == ln[i]:
            ev.add("ln_tie")
        if best >= ln[i] and np.unique(chunk[s == best]).size > 1:
            ev.add("tie_across_chunks")
    return ev


def test_stress_windows_reach_every_edge_case():
    counts = {w[0].shape[0] for w in WINDOWS}
    assert {1, 2, 32, 33, 1600, PA.A_CAP} <= counts
    ev = set()
    for bb, bc, mg, *_ in CHAIN_PARAMS:
        ms, _pv, cut = plain_dp(GROUPS["small"], bb, bc, mg)
        for w, (q, t, l) in enumerate(GROUPS["small"]):
            n = q.shape[0]
            ev |= dp_events(q, t, l, ms[w, :n].numpy(), cut[w, :n].numpy(), bc, mg)
    need = {"band_count_mid_chunk", "break_lane0", "break_lane31", "tie_across_chunks",
            "ln_tie", "bt_gt_at", "equal_qb"}
    assert need <= ev, need - ev
    assert {f"break_lane{x}" for x in range(32)} <= ev


@pytest.mark.parametrize("group,params", CASES)
def test_chain_dp_equals_native_forward(group, params):
    bb, bc, mg = CHAIN_PARAMS[params][:3]
    wins = GROUPS[group]
    ms, pv, _cut = plain_dp(wins, bb, bc, mg)
    for w, (q, t, l) in enumerate(wins):
        n = q.shape[0]
        for name, forward, _ in ORACLES:
            scores, prev = forward(q, t, l, bb, bc, mg)
            assert ms[w, :n].tolist() == scores.astype(np.int64).tolist(), name
            assert pv[w, :n].tolist() == prev.tolist(), name


def _native_rows(q, t, l, params, forward, backtrack):
    bb, bc, mg, min_score, min_align_len, heur = params
    if q.shape[0] == 1:
        s = int(l[0])
        ok = s >= min_score and s >= min_align_len
        return np.array([[1, s, s, s, q[0], q[0] + s - 1, t[0], t[0] + s - 1]] if ok else [],
                        dtype=np.int64).reshape(-1, 8)
    scores, prev = forward(q, t, l, bb, bc, mg)
    return backtrack(q, t, l, scores, prev, min_score, min_align_len, heur)[0]


@pytest.mark.parametrize("group,params", CASES)
def test_chain_plain_rows_equal_native(group, params):
    wins = GROUPS[group]
    if group == "small":  # one more copy of a window, flagged by the probe: skipped
        wins = wins + [wins[-1]]
    args = chain_tensors(wins, flagged=[len(wins) - 1] if group == "small" else [])
    rows, ccnt, cflg = PA.pseudo_chain(*args, *CHAIN_PARAMS[params])
    n_rows = 0
    for w, (q, t, l) in enumerate(wins):
        if int(args[4][w]):
            assert int(ccnt[w]) == 0 and int(cflg[w]) == 0
            continue
        want = [_native_rows(q, t, l, CHAIN_PARAMS[params], fw, bt) for _, fw, bt in ORACLES]
        assert want[0].tolist() == want[1].tolist()
        if int(cflg[w]) == PA.F_CHAIN_OVERFLOW:
            assert want[0].shape[0] > PA.C_CAP and int(ccnt[w]) == 0
            continue
        assert int(cflg[w]) == 0
        c = int(ccnt[w])
        assert rows[w, :c].tolist() == want[0].tolist()
        n_rows += c
    assert n_rows > 0
