#!/usr/bin/env python3
"""Drive lexicmap_tpu_torch's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 7] [--genomes 200] [--queries 40] [--rounds 5]
                          [--compare-source OLD/seed_locate.cu]
                          [--compare-source OLD/seed_match.cu]
                          [--compare-source OLD/chain1.cu] [--compare-source OLD/wfa.cu]
                          [--compare-source OLD/sharded.cu] [--compare-source OLD/capture.cu]
                          [--compare-source OLD/seed_compact.cu]

Phases, each of which raises on a wrong result (nothing falls back):
  1. environment: torch/CUDA versions and the card (nvidia-smi);
  2. build every hand-written kernel from the sources in the checkout, one
     nvcc per source, all started together (and --compare-source's);
  3. the seed kernels vs their plain PyTorch versions on the card, exact:
     seed_locate_batch (B1) and seed_locate (B2) on edge shapes (both of
     B1's regimes, B = 1-33, p = 1-16, edge counts, words past cnt), then
     at the shape of a 10k-genome index (20,000 rows x 10,240 entries) plus
     edge rows (poly-T, saturated rb, empty rows): seed_locate_batch (32
     queries), seed_locate (one query) and seed_match (hi and lo words, best
     LCP, also on its edge shapes: E = 5-16,384, p = 1-16, counts around a
     run, slices of several runs, words past cnt, an unaligned lo table);
     times as called and on the device (the kernel's own rows in
     torch.profiler), plain and library-call times, the sectors the earlier
     bisections touch (two for B1 and B2, three for B3) and those the kernel
     reads (tests/torch_parity.py's replays, held equal to the kernels), the
     bound from the fewer of them; with --compare-source, an earlier tree's
     seed-locate or seed-match kernel against this one in turns, at the same
     shapes (and, for seed_locate, the main path's);
  4. DeviceSeedMatcher over a synthetic 20,000-mask x 10,240-entry seed
     table vs a numpy bisection oracle; the compaction after B1 (B4,
     seed_compact, one launch for all buckets) on the batch's stacked B1
     outputs == its plain version == the oracle, timed as called, on the
     device (one kernel row a call, asserted), plain and against the
     library calls (torch.nonzero and gathers a bucket, torch.sort of one
     int64 key), its bound from the bytes the run's data needs; with
     --compare-source OLD/seed_compact.cu, the earlier tree's two-pass
     compaction (count, a wait for the offsets, write) in turns with this
     one, here, on the chunked table and on phase 6's batch, both == plain;
     match_batch's time split (k-mer split,
     device part, fetch, host tail) for this tree's path and the parent's
     (a host np.lexsort and merge after torch.nonzero a bucket), in turns;
     then a second table of 2,000 masks, one in sixteen over E_CAP =
     16,384 entries with 15-base prefix blocks across its chunk
     boundaries, so that chunk runs cross buckets: triples == the oracle,
     B4 == plain there too;
  4a. the reversed-k-mer dispatch of phase 2b (reverse_dispatch, B13) at
     the main path's shape: 32 queries of the genes mix's lengths through
     phase 1 against the gtdb.genes masks (k = 31, 20,000 masks): the
     kernel == its plain version == the host's _reversed_query_kmers,
     array for array, no query declined; times as called (with and
     without the k-mers' upload), on the device (one kernel row a call,
     asserted), plain and the host's 32 calls; its bound from the bytes the
     batch needs;
  4b. the sharded matcher on one NCCL rank with four local shards, over
     phase 4's table: seed_match_shard (B11, one launch for the four
     shards) through make_sharded_search_step on its 16-mer hi words (rows
     with pad words, all-T queries), then the entry's dry run
     (lexicmap_tpu_torch/entry.py) on the card: the kernel == its plain
     version over the four shards, on every shard alone and on the path's
     two launches, n_hits, lcp and the scores == an int64 numpy count;
     ShardedSeedMatcher (B1 per shard, then shard_compact, B12, one launch
     for the four shards): no query declined, those over its hit capacity
     through the second compaction,
     every query's triples == DeviceSeedMatcher's and the bisection
     oracle's, the compaction == its plain version; times as called, on
     the device and plain, the bound (B11: the fewer of the sectors its
     bisections touch and those the kernel reads, plus I/O), and the
     library calls (torch.searchsorted x2, torch.sort); with
     --compare-source OLD/sharded.cu, the earlier tree's compaction (a
     launch a shard, with the one-shard C signature) in turns with this
     one;
  5. phase 4 at real state size: a >= 1 GB resident genome blob (1,000
     genomes of 4 Mb) with mutated copies of 32 queries planted at 2,048
     window sites; pseudo_probe and pseudo_chain vs their plain versions
     there, pseudo_chain also on the chain stress windows of
     tests/torch_parity.py, and DevicePseudoAligner.run_batch vs the native
     oracle;
  6. end to end: a 200-genome index built with the port's `index` command,
     40 queries with 3% mutations plus a many-hit set (32 queries planted in
     16 genomes each) searched with the device engine (phases 2a and 4 on
     the card) and with the host engine: rows equal, every q_from_gNNN
     top-hits gNNN, every batch launched each kernel the expected number of
     times (B1 a bucket, B4 and B13 once), >= 90% of the windows answered on the
     card; B1 and B4 on the first batch's real queries == plain, and
     match_batch's split there, this tree's path and the parent's in turns; in turns with it,
     the device engine with `--chain device --wfa device` (chain1 once per
     batch, the WFA at least once): rows equal, >= 90% of the genomes
     chained and of the WFA spans aligned on the card, both kernels equal
     to their plain versions on the main path's first launches; then
     single-query `search` with the device matcher, and the CLI both ways;
     the same 200 genomes indexed again with `index --engine device` after
     the host build (B10 once per genome; the trees byte-identical file by
     file; genomes per minute of both), and `genome search --engine
     device` vs `--engine host` for two 1%-mutated indexed genomes against
     the device-built index (rows equal, the source genome first); then
     the mesh engine (DeviceSearchEngine over phase 4b's mesh, chain1 and
     the WFA on the card too): rows equal, four B1 launches and one
     compaction a bucket and batch, the compaction's first two launches ==
     plain, q/min in turns with the device engine; and `python -m
     lexicmap_tpu_torch.parallel.multiproc --nprocs 1 --local-devices 4
     --twins device`: its TSV == the host rows;
  7. (run before 6) chain1 (B9) and the WFA (B8) vs their plain versions
     and the native DP / WFA, exact: 4,096 anchor sets of 2-700 anchors,
     16 dense ones of 1,500 and 4 of 20,000; 4,096 pairs of 1.5 kb at 2-8%
     substitutions and 0.5-1% indels, 64 of 8 kb, 8 of 25 kb (those against
     the native WFA only), identical, pure-indel and one overflowing pair;
     times as called, on the device (B8 by kernel) and plain, bounds from
     the run's data; B9 under other block-path thresholds; with
     --compare-source, an earlier tree's chain1 and WFA kernels in turns
     with this tree's, here and at the main path's first launches of
     phase 6;
  8. (run before 6) the LexicHash capture (B10) at the index default of
     20,000 masks on genomes of 4.19, 6, 12 and 20 Mb (MAX_GENOME_SIZE;
     one with a copied block and a mask's k-mer 12,000 times in tandem,
     one of contigs with excluded intervals), one of 550 kb (the size of
     phase 6's genomes) and one shorter than k: the kernel == its plain
     version == native capture_native, exactly; times as called, on the
     device, plain, native and through the engine, and the bound from each
     genome's bytes and operations; with --compare-source OLD/capture.cu,
     the earlier tree's kernels in turns with this tree's on each genome.
  9. (run after 6, on its genomes, queries and index) utils: the first 16
     genomes built with `index --engine device -b 8` (two batches, B10) and
     with `--engine host`, the trees byte-identical (a cut: convert's
     per-posting Python loops would add minutes at 200 genomes); `utils
     export-index` of it and `utils import-index` of the export, timed, the
     exported tree's files counted and digested; the cut's queries and the
     many-hit set searched on the imported index with `search -a --engine
     device` and with `--chain device --wfa device`, rows == the host
     engine's on the cut, B1, the phase-4 pair, B9 and B8 launched; the
     same after `utils reindex-seeds`; `utils 2blast` and `utils 2sam` of
     the device TSV == of the host TSV; then TaxId-filtered `search
     --engine device -T -G` on the 200-genome index (a synthetic taxdump of
     two genera and four species) under a genus whitelist and a species
     blacklist: rows == the host engine's, non-empty, every genome allowed.
Then one `kernels` JSON line, the card's name and power limit, and the
result line {"ok": true, "device": {...}}.  Exits non-zero without a result
when there is no CUDA device or the package is not beside this script.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM non-tensor fp32 rate, used for integer compares
SECTOR = 32  # bytes the memory system moves per access


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, dev, reps: int, warmup: int = 1) -> float:
    """Mean ms per call: CUDA events around `reps` calls on the card."""
    import torch

    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, name, reps: int = 20) -> tuple[float, str]:
    """Mean device ms of the kernel launches whose name holds `name` (or,
    for a tuple of names, the sum of each name's mean: the kernels one call
    launches), over `reps` calls of fn after a warm one, from
    torch.profiler's CUDA rows.  Returns (ms, "profiler"), or (None, "not
    measured") where the profiler shows no such row or there is no CUDA
    device."""
    by = device_ms_split(fn, (name,) if isinstance(name, str) else name, reps)
    if None in by.values():
        return None, "not measured"
    return sum(by.values()), "profiler"


def _cuda_rows(fn, reps):
    """[(kernel name, device us)] of the CUDA rows of `reps` calls of fn,
    from one torch.profiler trace."""
    import torch
    from torch.autograd import DeviceType

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def device_ms_split(fn, names, reps: int = 20) -> dict:
    """{name: mean device ms of its kernel rows} over `reps` calls of fn,
    each name a substring of one kernel that fn launches (None where the
    profiler shows no row)."""
    import torch

    if not torch.cuda.is_available():
        return {nm: None for nm in names}
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without device rows: again
        rows = _cuda_rows(fn, reps)
        out = {}
        for nm in names:
            us = [t for name, t in rows if nm in name]
            out[nm] = sum(us) / len(us) / 1e3 if us else None
        if None not in out.values():
            break
    return out


def device_rows_by_call(fn, names, reps: int = 20, a_call=None) -> tuple[dict, dict]:
    """({name: device ms a call of fn of the kernel rows whose name holds
    it}, {name: those rows a call}) from one trace of `reps` calls after a
    warm one: the rows summed over reps, so a kernel launched L times a
    call counts L times.  A trace where a name's rows are not a multiple of
    reps (with `a_call`, not reps x a_call[name]) lost some: it is taken
    again, up to five times, then this raises.  A name without rows in
    every trace gives None."""
    import torch

    if not torch.cuda.is_available():
        return {nm: None for nm in names}, {nm: None for nm in names}
    fn()
    torch.cuda.synchronize()
    for _ in range(5):  # a trace now and then comes back with rows missing: again
        rows = _cuda_rows(fn, reps)
        us = {nm: [t for name, t in rows if nm in name] for nm in names}
        whole = all(len(us[nm]) == reps * a_call[nm] if a_call else len(us[nm]) % reps == 0
                    for nm in names)
        if whole and all(us.values()):
            break
    if not whole:
        raise AssertionError(f"no whole trace of {reps} calls in five: rows "
                             f"{ {nm: len(u) for nm, u in us.items()} }")
    return ({nm: sum(u) / reps / 1e3 or None for nm, u in us.items()},
            {nm: len(u) // reps for nm, u in us.items()})


def device_ms_by_call(fn, names, reps: int = 20, a_call=None) -> dict:
    """{name: device ms a call of fn of the kernel rows whose name holds
    it}, from a whole trace (device_rows_by_call); None where it shows no
    row."""
    return device_rows_by_call(fn, names, reps, a_call)[0]


def bound_recorder():
    """A fresh span recorder bound to this thread: the device stages'
    counters and card waits go to it (lexicmap_tpu_torch/utils/spans.py)."""
    from lexicmap_tpu_torch.utils.spans import SpanRecorder

    rec = SpanRecorder()
    rec.bind_thread()
    return rec


def counters(totals, stage: str) -> dict:
    """A stage's counters (`<stage>.<what>` of spans.COUNTERS) as ints."""
    from lexicmap_tpu_torch.utils.spans import COUNTERS

    return {k: int(totals[k]) for k in COUNTERS if k.startswith(stage + ".")}


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def to_i32_bits(x):
    """int64 tensor of uint32 values -> int32 tensor of the same bits."""
    import torch

    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


# --------------------------------------------------------------------------
# phase 3: seed_locate_batch (B1) and seed_locate (B2) vs their plain versions


def seed_locate_case(dev, Mb, E, B, k, seed):
    """A sorted hi-word table with edge rows (poly-T, saturated rb, empty
    rows) and queries, half drawn from table entries with mutated suffixes.
    Returns int32-bit tensors (hi [Mb,E], cnt [Mb], qh [B,Mb]) and qv bool."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    kmers = torch.randint(0, 1 << 62, (Mb, E), generator=g, device=dev).sort(dim=1).values
    hi64 = kmers >> (2 * k - 32)
    cnt = torch.full((Mb,), E, dtype=torch.int32, device=dev)
    part = torch.rand(Mb, generator=g, device=dev) < 0.1
    cnt[part] = torch.randint(0, E + 1, (int(part.sum()),), generator=g, device=dev,
                              dtype=torch.int32)
    cnt[2:6] = 0
    poly16, poly15 = 0xFFFFFFFF, 0xFFFFFFFC  # 16 T's; 15 T's then A
    hi64[0, :3] = poly16
    cnt[0] = 3
    hi64[1, :2] = poly15
    cnt[1] = 2
    lane = torch.arange(E, device=dev)
    hi64 = torch.where(lane[None, :] < cnt[:, None].long(), hi64, 0xFFFFFFFF)
    pick = (torch.rand((B, Mb), generator=g, device=dev) * cnt.clamp(min=1)[None, :]).long()
    # a drawn entry with its last base mutated: a hit for any p <= 15
    drawn = hi64.gather(1, pick.T).T ^ torch.randint(0, 4, (B, Mb), generator=g, device=dev)
    rand = torch.randint(0, 1 << 32, (B, Mb), generator=g, device=dev)
    half = (torch.arange(B, device=dev) % 2 == 0)[:, None]
    qh64 = torch.where(half & (cnt[None, :] > 0), drawn, rand)
    qh64[:, 0] = poly16
    qh64[:, 1] = poly15  # rb saturates at p = 15: padding must not count
    qv = torch.rand((B, Mb), generator=g, device=dev) < 0.9
    qv[:, :2] = True
    return to_i32_bits(hi64).contiguous(), cnt, to_i32_bits(qh64).contiguous(), qv, hi64


PARENT_SOURCES = ("seed_locate", "seed_match", "chain1", "wfa", "sharded", "capture",
                  "seed_compact")


def parent_build(paths):
    """Start nvcc on each earlier tree's csrc/seed_locate.cu, seed_match.cu,
    chain1.cu, wfa.cu, sharded.cu, capture.cu or seed_compact.cu (same
    flags; headers beside it), beside the kernel build; parent_load() waits
    for them."""
    from lexicmap_tpu_torch.kernels import build

    started = {}
    for path in paths:
        name = os.path.splitext(os.path.basename(path))[0]
        if name not in PARENT_SOURCES or name in started:
            raise ValueError(f"--compare-source takes one each of "
                             f"{', '.join(s + '.cu' for s in PARENT_SOURCES)}, got {path}")
        out = os.path.splitext(path)[0] + ".so"
        started[name] = (out, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", out, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return started


def parent_load(started):
    """{name: lib} of the earlier sources, their C entries bound
    (seed_locate only where the source has it)."""
    import ctypes

    libs = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, (out, proc) in started.items():
        log_, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the earlier {name}.cu:\n"
                               f"{log_.decode(errors='replace')}")
        lib = libs[name] = ctypes.CDLL(out)
        if name == "chain1":  # the entry before the block path (no n_block)
            lib.chain1_forward.argtypes = ([vp] * 5 + [ci, vp, ci, ctypes.c_float,
                                                       ctypes.c_float, ci] + [vp] * 5)
            lib.chain1_forward.restype = ci
            continue
        if name == "wfa":
            lib.wfa_align_batch.argtypes = [vp] * 5 + [ci] * 9 + [vp] * 7
            lib.wfa_align_batch.restype = ci
            continue
        if name == "seed_match":
            lib.seed_match.argtypes = [vp] * 9 + [ci, ci, ctypes.c_uint, ci, vp]
            lib.seed_match.restype = ci
            continue
        if name == "sharded":  # the compaction of one shard a launch (no L)
            lib.shard_compact.argtypes = [vp] * 4 + [ci] * 3 + [vp]
            lib.shard_compact.restype = ci
            continue
        if name == "seed_compact":  # the two-pass compaction's count and write
            head = [vp] * 6 + [ci, ctypes.c_longlong, ci, ci]
            lib.seed_compact_count.argtypes = head + [vp] * 3
            lib.seed_compact_write.argtypes = head + [vp, ctypes.c_longlong, vp, vp]
            lib.seed_compact_count.restype = lib.seed_compact_write.restype = ci
            continue
        if name == "capture":  # the C signatures of kernels/capture.py's
            i64 = ctypes.c_int64
            head = [vp, i64, vp, ci, ci, vp, ci, ci, vp]
            lib.capture_count_winners.argtypes = head + [vp] * 3
            lib.capture_write_winners.argtypes = head + [vp] * 9
            for fn in (lib.capture_count_winners, lib.capture_write_winners,
                       lib.capture_sort_cap):
                fn.restype = ci
            continue
        lib.seed_locate_batch.argtypes = [vp] * 6 + [ci, ci, ci, ctypes.c_uint, vp]
        lib.seed_locate_batch.restype = ci
        if hasattr(lib, "seed_locate"):
            lib.seed_locate.argtypes = [vp] * 6 + [ci, ci, ctypes.c_uint, vp]
            lib.seed_locate.restype = ci
    return libs


def parent_raw(lib, hi, cnt, qh, qv, p):
    """The earlier tree's seed-locate kernel; for one query its own
    seed_locate where the source has one, else its B = 1 launch."""
    import torch

    from lexicmap_tpu_torch.kernels.seed_locate import suffix_mask

    Mb, E = hi.shape
    stream = torch.cuda.current_stream().cuda_stream
    if qh.dim() == 1 and hasattr(lib, "seed_locate"):
        out = torch.empty((2, Mb), dtype=torch.int32, device=hi.device)
        err = lib.seed_locate(*[t.data_ptr() for t in (hi, cnt, qh, qv, out[0], out[1])],
                              Mb, E, suffix_mask(p), stream)
        if err:
            raise RuntimeError(f"the earlier kernel failed to launch ({err})")
        return out[0], out[1]
    q2, v2 = (qh, qv) if qh.dim() == 2 else (qh[None], qv[None])
    out = torch.empty((2, *q2.shape), dtype=torch.int32, device=hi.device)
    err = lib.seed_locate_batch(*[t.data_ptr() for t in (hi, cnt, q2, v2, out[0], out[1])],
                                q2.shape[0], Mb, E, suffix_mask(p), stream)
    if err:
        raise RuntimeError(f"the earlier kernel failed to launch ({err})")
    return (out[0], out[1]) if qh.dim() == 2 else (out[0][0], out[1][0])


def lib_match(lib, hi, lo, cnt, qh, ql, qv, p, k):
    """seed_match of the library built from --compare-source's seed_match.cu."""
    import torch

    from lexicmap_tpu_torch.kernels.seed_locate import suffix_mask

    Mb, E = hi.shape
    out = torch.empty((3, Mb), dtype=torch.int32, device=hi.device)
    err = lib.seed_match(*[t.data_ptr() for t in (hi, lo, cnt, qh, ql, qv, *out)], Mb, E,
                         suffix_mask(p), k, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"seed_match of {lib._name} failed to launch ({err})")
    return out[0], out[1], out[2]


def parent_chain1(lib, qb, tb, ln, off, gtab, max_gap, min_score, max_dist, **_):
    """chain1_forward as the wrapper of that earlier entry called its kernel
    (a device argsort for the order, four allocations, one launch)."""
    import torch

    dev, N, G = qb.device, qb.shape[0], off.shape[0] - 1
    order = torch.argsort(off[1:] - off[:-1], descending=True).to(torch.int32)
    ms = torch.empty(N, dtype=torch.float32, device=dev)
    prev = torch.empty(N, dtype=torch.int32, device=dev)
    dirs = torch.empty(N, dtype=torch.int8, device=dev)
    flags = torch.empty(G, dtype=torch.int32, device=dev)
    err = lib.chain1_forward(qb.data_ptr(), tb.data_ptr(), ln.data_ptr(), off.data_ptr(),
                             order.data_ptr(), G, gtab.data_ptr(), gtab.shape[0],
                             float(max_gap), float(min_score), int(max_dist), ms.data_ptr(),
                             prev.data_ptr(), dirs.data_ptr(), flags.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the earlier chain1 kernel failed to launch ({err})")
    return ms, prev, dirs, flags


def parent_wfa(lib, seq, q_off, t_off, n, m, S, W, CAP, x=4, o=6, e=2, min_wf_len=10,
               max_dist_diff=50, **_):
    """wfa_batch as the wrapper of the earlier entry (W-wide history
    scratch) called its kernels: six allocations, one call of both."""
    import torch

    dev, B = seq.device, n.shape[0]
    ops = torch.empty((B, CAP), dtype=torch.int8, device=dev)
    cnts = torch.empty((B, CAP), dtype=torch.int32, device=dev)
    nops = torch.empty(B, dtype=torch.int32, device=dev)
    hist = torch.empty((B, S, 3, W), dtype=torch.int16, device=dev)
    lo = torch.empty((B, S), dtype=torch.int32, device=dev)
    done_s = torch.empty(B, dtype=torch.int32, device=dev)
    err = lib.wfa_align_batch(
        seq.data_ptr(), q_off.data_ptr(), t_off.data_ptr(), n.data_ptr(), m.data_ptr(), B, S, W,
        CAP, x, o, e, min_wf_len, max_dist_diff, hist.data_ptr(), lo.data_ptr(),
        done_s.data_ptr(), ops.data_ptr(), cnts.data_ptr(), nops.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the earlier wfa kernels failed to launch ({err})")
    return ops, cnts, nops


def parent_capture(lib, codes, exclude, table, masks, k, p):
    """The earlier capture.cu (a thread per position, best [m] u64) as its
    wrapper called it: two entries around the one wait for the total."""
    import torch

    dev, L, m = codes.device, codes.shape[0], masks.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    head = (codes.data_ptr(), L, 0 if exclude is None else exclude.data_ptr(), k, p,
            table.data_ptr(), int(table.shape[0] == 1 << (2 * p)), m, masks.data_ptr())
    work = torch.empty(28 * m, dtype=torch.uint8, device=dev)
    best = work[: 8 * m]
    cnt = work[8 * m: 16 * m].view(torch.int64)
    off = work[16 * m: 24 * m].view(torch.int64)
    cursor = work[24 * m:]
    if lib.capture_count_winners(*head, best.data_ptr(), cnt.data_ptr(), stream):
        raise RuntimeError("the earlier capture_count_winners failed to launch")
    torch.cumsum(cnt, 0, out=off)
    total, most = (int(v) for v in torch.stack([off[-1], cnt.max()]).cpu())
    off.sub_(cnt)
    out = torch.empty(16 * m + 4 * total, dtype=torch.uint8, device=dev)
    kmers, counts = out[: 8 * m].view(torch.int64), out[8 * m: 16 * m].view(torch.int64)
    pos = out[16 * m:].view(torch.int32)
    scratch = torch.empty(total, dtype=torch.int32, device=dev) \
        if most > lib.capture_sort_cap() else None
    if lib.capture_write_winners(*head, best.data_ptr(), cnt.data_ptr(), off.data_ptr(),
                                 cursor.data_ptr(), pos.data_ptr(), kmers.data_ptr(),
                                 counts.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
                                 stream):
        raise RuntimeError("the earlier capture_write_winners failed to launch")
    return kmers, counts, pos


def same_stage_outputs(a, b) -> bool:
    """chain1's four outputs equal (float32 bits), or the WFA's runs."""
    import torch

    if a[0].dtype == torch.float32:
        return torch.equal(a[0].view(torch.int32), b[0].view(torch.int32)) and all(
            torch.equal(x, y) for x, y in zip(a[1:], b[1:]))
    from lexicmap_tpu_torch.kernels.wfa import decode_ops

    return decode_ops(*(x.cpu().numpy() for x in a)) == decode_ops(*(x.cpu().numpy() for x in b))


def int_err(got, want) -> float:
    """The largest |a - b| over pairs of integer tensors or numpy arrays
    (uint64 read as its int64 bits, so two unequal words never differ by 0);
    inf where a pair's shapes differ."""
    import numpy as np
    import torch

    err = 0
    for a, b in zip(got, want):
        if isinstance(a, np.ndarray):
            a, b = (torch.from_numpy(np.ascontiguousarray(x).view(np.int64)
                                     if x.dtype == np.uint64 else x.astype(np.int64))
                    for x in (a, b))
        if a.shape != b.shape:
            return float("inf")
        if a.numel():
            d = (a.long() - b.long()).abs()
            d.masked_fill_(d < 0, torch.iinfo(torch.int64).max)  # |INT64_MIN| wraps
            err = max(err, int(d.max()))
    return err


def split_in_turns(dev, parent_fn, new_fn, parent_names, new_names, reps, same=None,
                   a_call=(None, None)):
    """An earlier kernel's calls against this tree's in turns (parent, new,
    new, parent): ms as called (CUDA events) and device ms a call, by
    kernel name and summed, each from a whole trace (device_rows_by_call;
    `a_call`: the parent's and the new side's rows a call by name, where
    known).  Both give the same outputs (`same`, else equal integers), and
    each side's two turns the same rows a call, or it raises."""
    a, b = parent_fn(), new_fn()
    if not (same(a, b) if same else int_err(a, b) == 0):
        raise AssertionError(f"the earlier {parent_names[0]} and this tree's differ")
    out = {"parent": [], "new": [], "parent_device": [], "new_device": [],
           "parent_device_by": [], "new_device_by": [], "parent_rows": [], "new_rows": []}
    for key, fn, names, want in (
            ("parent", parent_fn, parent_names, a_call[0]), ("new", new_fn, new_names, a_call[1]),
            ("new", new_fn, new_names, a_call[1]), ("parent", parent_fn, parent_names, a_call[0])):
        out[key].append(time_ms(fn, dev, reps))
        by, rows = device_rows_by_call(fn, names, reps, want)
        out[key + "_device_by"].append(by)
        out[key + "_device"].append(None if None in by.values() else sum(by.values()))
        out[key + "_rows"].append(rows)
    for key in ("parent", "new"):
        if out[key + "_rows"][0] != out[key + "_rows"][1]:
            raise AssertionError(f"{key}: rows a call differ between turns: {out[key + '_rows']}")
    return out


def in_turns(parent_fn, new_fn, parent_name, new_name, reps=20):
    """Device ms of the earlier kernel and this one in turns (parent, new,
    new, parent); each name is a substring of the one kernel its function
    launches.  Returns {"parent": [a, b], "new": [a, b], "by": ...}."""
    order = [("parent", parent_fn, parent_name), ("new", new_fn, new_name),
             ("new", new_fn, new_name), ("parent", parent_fn, parent_name)]
    out = {"parent": [], "new": [], "by": []}
    for key, fn, name in order:
        ms, by = device_ms(fn, name, reps)
        out[key].append(ms)
        out["by"].append(by)
    return out


def bisection_probe_bytes(hi64, cnt, qh, qv, p, rb_from_lb=True) -> tuple[int, int]:
    """Replay two lower-bound bisections per valid (b, row), rb's started
    from lb's answer (the earlier thread-per-(b, m) kernel's search) or,
    with rb_from_lb=False, from the row's start (B11's), and count the
    distinct 32-byte table sectors they read and the probes made (the
    data-dependent work of this run).  Returns (sector_bytes, probes)."""
    import torch

    from lexicmap_tpu_torch.kernels.seed_locate import suffix_mask

    Mb, E = hi64.shape
    suf = suffix_mask(p)
    b_idx, m_idx = qv.nonzero(as_tuple=True)
    q = qh[b_idx, m_idx].long() & 0xFFFFFFFF
    flat = hi64.reshape(-1)
    base = m_idx * E
    n = cnt.long()[m_idx]
    sectors = []
    probes = 0

    def bisect(lo, hi, x, strict):
        nonlocal probes
        while True:
            act = lo < hi
            if not bool(act.any()):
                return lo
            mid = (lo + hi) >> 1
            pos = base + torch.where(act, mid, 0)
            sectors.append((pos[act] * 4) // SECTOR)
            probes += int(act.sum())
            v = flat[pos]
            right = (v < x) if strict else (v <= x)
            lo = torch.where(act & right, mid + 1, lo)
            hi = torch.where(act & ~right, mid, hi)

    lo = bisect(torch.zeros_like(n), n.clone(), q & (0xFFFFFFFF ^ suf), True)
    bisect(lo.clone() if rb_from_lb else torch.zeros_like(n), n.clone(), q | suf, False)
    distinct = int(torch.unique(torch.cat(sectors)).numel()) if sectors else 0
    return distinct * SECTOR, probes


def parity():
    """tests/torch_parity.py: the test tables and the seed kernels' replays."""
    path = os.path.join(HERE, "tests")
    if path not in sys.path:
        sys.path.insert(0, path)
    import torch_parity

    return torch_parity


def locate_bound(sector_bytes, design_bytes, probes, io_bytes):
    """(bound_ms, bound_by) of a seed-locate search: the fewer of the
    sectors the bisection touches and those the kernel reads (either
    computes the function), plus I/O, over HBM; or a load and a compare per
    bisection probe."""
    bytes_ms = (min(sector_bytes, design_bytes) + io_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * probes / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def phase_kernel(dev, card, Mb, E, B, p, seed, reps, parent=None):
    import torch

    from lexicmap_tpu_torch.kernels.seed_locate import (
        seed_locate_batch, seed_locate_batch_plain, suffix_mask)

    k = 31
    hi, cnt, qh, qv, hi64 = seed_locate_case(dev, Mb, E, B, k, seed)
    log(f"[kernel] seed_locate_batch: Mb={Mb} E={E} B={B}, table {hi.numel() * 4 / 1e6:.1f} MB")
    max_abs_err = 0
    for pp in sorted({p, 1, 11, 16}):
        nh, e0 = seed_locate_batch(hi, cnt, qh, qv, pp)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        pn, pe = seed_locate_batch_plain(hi, cnt, qh, qv, pp)
        if not (torch.equal(nh, pn) and torch.equal(e0, pe)):
            bad = int(((nh != pn) | (e0 != pe)).sum())
            raise AssertionError(f"seed_locate_batch != plain at p={pp}: {bad} cells differ")
        if not (nh[:, 0] == 3).all() or not (nh[:, 1] == 2).all() or (nh[:, 2:6] != 0).any():
            raise AssertionError(f"edge rows wrong at p={pp}")
        max_abs_err = max(max_abs_err, int((nh - pn).abs().max()), int((e0 - pe).abs().max()))
        hits = int((nh > 0).sum())
        log(f"[kernel] p={pp}: kernel == plain on all {nh.numel()} cells ({hits} with hits)")
    nh, e0 = seed_locate_batch(hi, cnt, qh, qv, p)

    # library yardstick: batched searchsorted over the int64-widened rows
    # (PAD_HI sorts last), clamped to cnt; the port never calls it
    suf = suffix_mask(p)
    q64 = (qh.long() & 0xFFFFFFFF).T.contiguous()  # [Mb, B]
    lb, rb = q64 & (0xFFFFFFFF ^ suf), q64 | suf
    c = cnt.long()[:, None]

    def library():
        lo = torch.searchsorted(hi64, lb).clamp(max=c)
        end = torch.searchsorted(hi64, rb, right=True).clamp(max=c)
        return torch.where(qv.T, end - lo, 0).T, torch.where(qv.T, lo, 0).T

    ln, le = library()
    if not (torch.equal(ln.int(), nh) and torch.equal(le.int(), e0)):
        raise AssertionError("library searchsorted disagrees with the kernel")

    kernel_ms = time_ms(lambda: seed_locate_batch(hi, cnt, qh, qv, p), dev, reps)
    dev_ms, dev_by = device_ms(lambda: seed_locate_batch(hi, cnt, qh, qv, p), "locate_batch",
                               reps)
    plain_ms = time_ms(lambda: seed_locate_batch_plain(hi, cnt, qh, qv, p), dev, max(1, reps // 10))
    library_ms = time_ms(library, dev, reps)
    rn, re_, design = parity().locate_batch_replay(hi, cnt, qh, qv, p)
    if not (torch.equal(rn, nh) and torch.equal(re_, e0)):
        raise AssertionError("the torch replay of the design disagrees with the kernel")
    sector_bytes, probes = bisection_probe_bytes(hi64, cnt, qh, qv, p)
    design_bytes = design.numel() * SECTOR
    io_bytes = qh.numel() * 4 + qv.numel() + cnt.numel() * 4 + 2 * nh.numel() * 4
    bound_ms, bound_by = locate_bound(sector_bytes, design_bytes, probes, io_bytes)
    res = {
        "Mb": Mb, "E": E, "B": B, "p": p, "equal": True, "max_abs_err": max_abs_err,
        "kernel_ms": kernel_ms, "device_ms": dev_ms, "device_ms_by": dev_by,
        "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "sector_bytes": sector_bytes, "design_bytes": design_bytes,
        "io_bytes": io_bytes, "table_bytes": hi.numel() * 4, "probes": probes,
    }
    log(f"[kernel] p={p}: kernel_ms={kernel_ms:.4f} (device {dev_ms} by {dev_by}) "
        f"plain_ms={plain_ms:.3f} library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} "
        f"(bisection's sectors {sector_bytes / 1e6:.1f} MB, the design's "
        f"{design_bytes / 1e6:.1f} MB, of {hi.numel() * 4 / 1e6:.1f} MB) [{card}]")
    if parent is not None:
        res["parent"] = in_turns(lambda: parent_raw(parent, hi, cnt, qh, qv, p),
                                 lambda: seed_locate_batch(hi, cnt, qh, qv, p),
                                 "locate", "locate_batch", reps)
        if not all(torch.equal(a, b) for a, b in zip(parent_raw(parent, hi, cnt, qh, qv, p),
                                                      (nh, e0))):
            raise AssertionError("the earlier kernel disagrees with this one")
        log(f"[kernel] seed_locate_batch device ms in turns, earlier tree's kernel vs this one: "
            f"{json.dumps(res['parent'])} [{card}]")
    single = phase_single(dev, card, hi, cnt, qh[:1].contiguous(), qv[:1].contiguous(), hi64,
                          p, reps, parent)
    return res, single


def phase_single(dev, card, hi, cnt, qh, qv, hi64, p, reps, parent=None):
    """seed_locate (B2, its own kernel) on the B1 table, with the first
    query of the batch (drawn entries, poly-T and saturated rows)."""
    import torch

    from lexicmap_tpu_torch.kernels.seed_locate import (
        seed_locate, seed_locate_plain, suffix_mask)

    q, v = qh[0], qv[0]
    max_abs_err = 0
    for pp in sorted({p, 1, 11, 16}):
        nh, e0 = seed_locate(hi, cnt, q, v, pp)
        sync(dev)
        pn, pe = seed_locate_plain(hi, cnt, q, v, pp)
        if not (torch.equal(nh, pn) and torch.equal(e0, pe)):
            raise AssertionError(f"seed_locate != plain at p={pp}")
        if nh[0] != 3 or nh[1] != 2 or (nh[2:6] != 0).any():
            raise AssertionError(f"seed_locate edge rows wrong at p={pp}")
        max_abs_err = max(max_abs_err, int((nh - pn).abs().max()), int((e0 - pe).abs().max()))
        log(f"[kernel] seed_locate (B=1) p={pp}: kernel == plain on all {nh.numel()} rows "
            f"({int((nh > 0).sum())} with hits)")
    nh, e0 = seed_locate(hi, cnt, q, v, p)
    suf = suffix_mask(p)
    q64 = (q.long() & 0xFFFFFFFF)[:, None]
    lb, rb = q64 & (0xFFFFFFFF ^ suf), q64 | suf
    c = cnt.long()[:, None]

    def library():
        lo = torch.searchsorted(hi64, lb).clamp(max=c)[:, 0]
        end = torch.searchsorted(hi64, rb, right=True).clamp(max=c)[:, 0]
        return torch.where(v, end - lo, 0), torch.where(v, lo, 0)

    ln_, le_ = library()
    if not (torch.equal(ln_.int(), nh) and torch.equal(le_.int(), e0)):
        raise AssertionError("library searchsorted disagrees with seed_locate")
    kernel_ms = time_ms(lambda: seed_locate(hi, cnt, q, v, p), dev, reps)
    dev_ms, dev_by = device_ms(lambda: seed_locate(hi, cnt, q, v, p), "locate_single", reps)
    plain_ms = time_ms(lambda: seed_locate_plain(hi, cnt, q, v, p), dev, max(1, reps // 10))
    library_ms = time_ms(library, dev, reps)
    rn, re_, design = parity().locate_single_replay(hi, cnt, q, v, p)
    if not (torch.equal(rn, nh) and torch.equal(re_, e0)):
        raise AssertionError("the torch replay of the single-query search disagrees with the kernel")
    sector_bytes, probes = bisection_probe_bytes(hi64, cnt, qh, qv, p)
    design_bytes = design.numel() * SECTOR
    io_bytes = q.numel() * 4 + v.numel() + cnt.numel() * 4 + 2 * nh.numel() * 4
    bound_ms, bound_by = locate_bound(sector_bytes, design_bytes, probes, io_bytes)
    res = {"Mb": hi.shape[0], "E": hi.shape[1], "B": 1, "p": p, "equal": True,
           "max_abs_err": max_abs_err, "kernel_ms": kernel_ms, "device_ms": dev_ms,
           "device_ms_by": dev_by, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "sector_bytes": sector_bytes,
           "design_bytes": design_bytes, "io_bytes": io_bytes, "probes": probes}
    log(f"[kernel] seed_locate (B=1) p={p}: kernel_ms={kernel_ms:.4f} (device {dev_ms} by "
        f"{dev_by}) plain_ms={plain_ms:.3f} library_ms={library_ms:.4f} "
        f"bound_ms={bound_ms:.5f} (bisection's sectors {sector_bytes / 1e6:.2f} MB, the "
        f"design's {design_bytes / 1e6:.2f} MB) [{card}]")
    if parent is not None:
        res["parent"] = in_turns(lambda: parent_raw(parent, hi, cnt, q, v, p),
                                 lambda: seed_locate(hi, cnt, q, v, p),
                                 "locate", "locate_single", reps)
        log(f"[kernel] seed_locate device ms in turns, earlier tree's kernel vs this one: "
            f"{json.dumps(res['parent'])} [{card}]")
    return res


def check_locate_edges(dev):
    """seed_locate_batch and seed_locate against their plain versions on
    the edge shapes: E at 128, the regime threshold +- 128 and 16,384; B in
    1, 7, 32, 33; p in 1, 11, 15, 16; the edge rows of
    torch_parity.make_edge_case (counts 0, 1, S - 1, S, S + 1, E, long
    runs, non-PAD words past cnt).  Returns the number of cases."""
    import torch

    from lexicmap_tpu_torch.kernels import seed_locate as SL

    tp = parity()
    n = 0
    for E in (128, SL.SMALL_MAX_E - 128, SL.SMALL_MAX_E + 128, 16384):
        for B in (1, 7, 32, 33):
            hi, cnt, qh, qv = tp.to_torch(*tp.make_edge_case(15, B, E, M=256, seed=B), device=dev)
            for p in (1, 11, 15, 16):
                got = SL.seed_locate_batch(hi, cnt, qh, qv, p)
                want = SL.seed_locate_batch_plain(hi, cnt, qh, qv, p)
                one = SL.seed_locate(hi, cnt, qh[0], qv[0], p)
                if not (all(torch.equal(a, b) for a, b in zip(got, want))
                        and all(torch.equal(a, b[0]) for a, b in zip(one, want))):
                    raise AssertionError(f"seed_locate kernels != plain at E={E} B={B} p={p}")
                n += 1
    log(f"[kernel] seed_locate_batch and seed_locate == plain on {n} edge shapes")
    return n


# --------------------------------------------------------------------------
# phase 3: seed_match (B3) vs its plain version


POLY_T16 = 0xFFFFFFFF << 30  # 31-mer: 16 T's then A's
POLY_T15 = 0x3FFFFFFF << 32  # 15 T's then A's
PAD62 = 1 << 62  # past every 31-mer: the int64 rows' padding


def seed_match_case(dev, Mb, E, k, seed):
    """Rows of sorted random 31-mers (row 6: runs of 8 entries sharing their
    hi word), with the poly-T, saturated-rb and empty rows of the B1 case;
    one query per row: a quarter exact entries, a quarter entries with
    mutated last bases, the rest random.  Returns the int32-bit tensors
    (hi, lo [Mb,E], cnt, qh, ql, qv) and the int64 rows and queries."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    kmers = torch.randint(0, 1 << 62, (Mb, E), generator=g, device=dev)
    kmers[6] = (kmers[6] & ~((1 << 30) - 1)).reshape(-1, 8)[:, :1].expand(-1, 8).reshape(-1) \
        | (kmers[6] & ((1 << 30) - 1))
    kmers = kmers.sort(dim=1).values
    cnt = torch.full((Mb,), E, dtype=torch.int32, device=dev)
    part = torch.rand(Mb, generator=g, device=dev) < 0.1
    cnt[part] = torch.randint(0, E + 1, (int(part.sum()),), generator=g, device=dev,
                              dtype=torch.int32)
    cnt[2:6] = 0
    kmers[0, :3] = torch.tensor(sorted([POLY_T16, POLY_T16 | 1, POLY_T16 | 0x100]), device=dev)
    kmers[1, :2] = torch.tensor([POLY_T15 | 3, POLY_T15 | 9], device=dev)
    cnt[0], cnt[1] = 3, 2
    lane = torch.arange(E, device=dev)
    kmers = torch.where(lane[None, :] < cnt[:, None].long(), kmers, PAD62)
    pick = (torch.rand(Mb, generator=g, device=dev) * cnt.clamp(min=1)).long()
    drawn = kmers.gather(1, pick[:, None])[:, 0]
    kind = torch.randint(0, 4, (Mb,), generator=g, device=dev)
    mut = torch.randint(1, 1 << 20, (Mb,), generator=g, device=dev)
    rand = torch.randint(0, 1 << 62, (Mb,), generator=g, device=dev)
    q = torch.where((kind == 0) & (cnt > 0), drawn,
                    torch.where((kind == 1) & (cnt > 0), drawn ^ mut, rand))
    q[0], q[1] = POLY_T16 | 0x123, POLY_T15 | 7
    qv = torch.rand(Mb, generator=g, device=dev) < 0.9
    qv[:2] = True
    pad = kmers == PAD62
    hi = torch.where(pad, 0xFFFFFFFF, kmers >> 30)
    lo = torch.where(pad, 0xFFFFFFFF, (kmers & ((1 << 30) - 1)) << 2)
    qh = torch.where(qv, q >> 30, 0)
    ql = torch.where(qv, (q & ((1 << 30) - 1)) << 2, 0)
    bits = [to_i32_bits(t).contiguous() for t in (hi, lo, qh, ql)]
    return bits[0], bits[1], cnt, bits[2], bits[3], qv, kmers, q


def match_replay_bytes(kmers, cnt, q, qv, p):
    """Replay seed_match's three bisections and two neighbour reads per
    valid row; count the distinct 32-byte hi and lo sectors they read.
    Returns (sector_bytes, probes)."""
    import torch

    from lexicmap_tpu_torch.kernels.seed_locate import suffix_mask

    Mb, E = kmers.shape
    rows = qv.nonzero().flatten()
    flat = kmers.reshape(-1)
    base = rows * E
    n = cnt.long()[rows]
    qr = q[rows]
    qh = qr >> 30
    suf = suffix_mask(p)
    hi_pos, lo_pos = [], []
    probes = 0

    def bisect(lo, hi, val, x, strict, both):
        nonlocal probes
        while True:
            act = lo < hi
            if not bool(act.any()):
                return lo
            mid = (lo + hi) >> 1
            pos = base + torch.where(act, mid, 0)
            hi_pos.append(pos[act])
            if both:
                lo_pos.append(pos[act])
            probes += int(act.sum())
            v = val(flat[pos])
            right = (v < x) if strict else (v <= x)
            lo = torch.where(act & right, mid + 1, lo)
            hi = torch.where(act & ~right, mid, hi)

    hw = lambda v: v >> 30  # noqa: E731  (the hi word of an int64 31-mer)
    first = bisect(torch.zeros_like(n), n.clone(), hw, qh & (0xFFFFFFFF ^ suf), True, False)
    end = bisect(first.clone(), n.clone(), hw, qh | suf, False, False)
    ins = bisect(first.clone(), end.clone(), lambda v: v, qr, True, True)
    for nb, ok in ((ins - 1, ins > first), (ins, ins < end)):
        hi_pos.append((base + nb)[ok])
        lo_pos.append((base + nb)[ok])
    sectors = sum(int(torch.unique(torch.cat(ps) // (SECTOR // 4)).numel()) if ps else 0
                  for ps in (hi_pos, lo_pos))
    return sectors * SECTOR, probes


def check_match_edges(dev):
    """seed_match against its plain version and the replay of its search
    on the edge shapes of torch_parity.make_match_edge_case: E in 5, 100,
    128, 16,384; p in 1, 11, 15, 16; distinct and duplicate hi words (counts
    around a run, slices of several runs, queries below and above every
    entry, random words past cnt); then E = 128 with the lo table 4 bytes
    off the 16-byte grid.  Returns the number of cases."""
    import torch

    from lexicmap_tpu_torch.kernels import seed_match as SM

    tp = parity()

    def check(args, p, what):
        got = SM.seed_match(*args, p)
        want = SM.seed_match_plain(*args, p)
        rep = tp.seed_match_replay(*args, p)[:3]
        if not all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(got, want, rep)):
            raise AssertionError(f"seed_match != plain or replay at {what} p={p}")

    n = 0
    for E in (5, 100, 128, 16384):
        for dup in (False, True):
            for p in (1, 11, 15, 16):
                case = tp.make_match_edge_case(p, E, dup=dup, seed=E + p)
                check(tp.seed_match_torch(*case, device=dev), p, f"E={E} dup={dup}")
                n += 1
    args = list(tp.seed_match_torch(*tp.make_match_edge_case(11, 128, seed=9), device=dev))
    buf = torch.empty(args[1].numel() + 1, dtype=torch.int32, device=dev)
    args[1] = buf[1:].view(args[0].shape).copy_(args[1])
    for p in (1, 11):
        check(args, p, "E=128, lo 4 bytes off the grid,")
        n += 1
    log(f"[kernel] seed_match == plain and the replay on {n} edge shapes")
    return n


def phase_seed_match(dev, card, Mb, E, p, seed, reps, parent=None):
    import torch

    from lexicmap_tpu_torch.kernels.seed_locate import suffix_mask
    from lexicmap_tpu_torch.kernels.seed_match import bit_length, seed_match, seed_match_plain

    k = 31
    tp = parity()
    hi, lo, cnt, qh, ql, qv, kmers, q = seed_match_case(dev, Mb, E, k, seed)
    log(f"[kernel] seed_match: Mb={Mb} E={E}, hi + lo {2 * hi.numel() * 4 / 1e6:.1f} MB")
    max_abs_err = 0
    for pp in sorted({p, 11, 16}):
        got = seed_match(hi, lo, cnt, qh, ql, qv, pp, k)
        sync(dev)
        want = seed_match_plain(hi, lo, cnt, qh, ql, qv, pp, k)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            bad = int(sum(((a != b).sum() for a, b in zip(got, want))))
            raise AssertionError(f"seed_match != plain at p={pp}: {bad} cells differ")
        if got[0][0] != 3 or got[0][1] != 2 or (got[0][2:6] != 0).any():
            raise AssertionError(f"seed_match edge rows wrong at p={pp}")
        replay = tp.seed_match_replay(hi, lo, cnt, qh, ql, qv, pp, k)
        if not all(torch.equal(a, b) for a, b in zip(got, replay[:3])):
            raise AssertionError(f"the torch replay of the design disagrees with seed_match at "
                                 f"p={pp}")
        if pp == p:
            hi_sec, lo_sec = replay[3:]
        max_abs_err = max([max_abs_err] + [int((a - b).abs().max()) for a, b in zip(got, want)])
        log(f"[kernel] seed_match p={pp}: kernel == plain == replay on all {Mb} rows "
            f"({int((got[0] > 0).sum())} with hits, {int((got[2] == k).sum())} with LCP k)")
    got = seed_match(hi, lo, cnt, qh, ql, qv, p, k)

    # library yardstick: one searchsorted of (lb, rb + 1, q) over the int64
    # 31-mer rows, then the LCP at the two in-range neighbours of q
    suf = suffix_mask(p)
    qhi = q >> 30
    keys = torch.stack([(qhi & (0xFFFFFFFF ^ suf)) << 30,
                        (((qhi | suf) << 30) | ((1 << 30) - 1)) + 1, q], 1)
    c = cnt.long()[:, None]

    def lcp_at(i, ok):
        x = kmers.gather(1, i.clamp(0, E - 1)[:, None])[:, 0] ^ q
        return torch.where(ok, torch.clamp((62 - bit_length(x)) // 2, max=k), 0)

    def library():
        idx = torch.minimum(torch.searchsorted(kmers, keys), c)
        e0, end = idx[:, 0], idx[:, 1]
        ins = torch.minimum(torch.maximum(idx[:, 2], e0), end)
        best = torch.maximum(lcp_at(ins - 1, ins > e0), lcp_at(ins, ins < end))
        return (torch.where(qv, end - e0, 0), torch.where(qv, e0, 0),
                torch.where(qv, best, 0))

    lib = library()
    if not all(torch.equal(a.int(), b) for a, b in zip(lib, got)):
        raise AssertionError("library searchsorted yardstick disagrees with seed_match")
    call = lambda: seed_match(hi, lo, cnt, qh, ql, qv, p, k)  # noqa: E731
    kernel_ms = time_ms(call, dev, reps)
    dev_ms, dev_by = device_ms(call, "match_single", reps)
    plain_ms = time_ms(lambda: seed_match_plain(hi, lo, cnt, qh, ql, qv, p, k), dev,
                       max(1, reps // 10))
    library_ms = time_ms(library, dev, reps)
    sector_bytes, probes = match_replay_bytes(kmers, cnt, q, qv, p)
    design_bytes = (hi_sec.numel() + lo_sec.numel()) * SECTOR
    io_bytes = 2 * Mb * 4 + Mb + Mb * 4 + 3 * Mb * 4
    bound_ms, bound_by = locate_bound(sector_bytes, design_bytes, probes, io_bytes)
    res = {"Mb": Mb, "E": E, "B": 1, "p": p, "equal": True, "max_abs_err": max_abs_err,
           "kernel_ms": kernel_ms, "device_ms": dev_ms, "device_ms_by": dev_by,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "sector_bytes": sector_bytes, "design_bytes": design_bytes,
           "design_lo_bytes": lo_sec.numel() * SECTOR, "io_bytes": io_bytes, "probes": probes}
    log(f"[kernel] seed_match p={p}: kernel_ms={kernel_ms:.4f} (device {dev_ms} by {dev_by}) "
        f"plain_ms={plain_ms:.3f} library_ms={library_ms:.4f} bound_ms={bound_ms:.5f} "
        f"(three bisections' sectors {sector_bytes / 1e6:.2f} MB, the design's "
        f"{design_bytes / 1e6:.2f} MB of which lo {lo_sec.numel() * SECTOR / 1e6:.2f} MB, of "
        f"{2 * hi.numel() * 4 / 1e6:.1f} MB) [{card}]")
    if parent is not None:
        if not all(torch.equal(a, b) for a, b in zip(
                lib_match(parent, hi, lo, cnt, qh, ql, qv, p, k), got)):
            raise AssertionError("the earlier seed_match disagrees with this one")
        res["parent"] = in_turns(lambda: lib_match(parent, hi, lo, cnt, qh, ql, qv, p, k),
                                 call, "match", "match_single", reps)
        log(f"[kernel] seed_match device ms in turns, earlier tree's kernel vs this one: "
            f"{json.dumps(res['parent'])} [{card}]")
    return res


# --------------------------------------------------------------------------
# phase 4: the matcher at real state size


class _Chunk:
    def __init__(self, kmers, mask_offsets):
        self.kmers = kmers
        self.mask_offsets = mask_offsets
        self.mask_begin = 0
        self.mask_end = mask_offsets.shape[0] - 1


class _MaskSet:
    def __init__(self, m):
        self.m = m


class _StandIn:
    """What DeviceSeedMatcher reads of an IndexSearcher: chunks, k, mask_set.m."""

    def __init__(self, kmers, mask_offsets, k):
        self.chunks = [_Chunk(kmers, mask_offsets)]
        self.k = k
        self.mask_set = _MaskSet(mask_offsets.shape[0] - 1)


def segment_bisect(vals, lo, hi, x, side):
    import numpy as np

    lo, hi = lo.copy(), hi.copy()
    while True:
        act = lo < hi
        if not act.any():
            return lo
        mid = (lo + hi) >> 1
        v = vals[np.where(act, mid, 0)]
        right = v < x if side == "left" else v <= x
        lo = np.where(act & right, mid + 1, lo)
        hi = np.where(act & ~right, mid, hi)


def phase_matcher(dev, card, M, E, B, p, seed, reps, parent=None):
    import numpy as np
    import torch

    from lexicmap_tpu_torch.kernels.seed_compact import seed_compact
    from lexicmap_tpu_torch.kernels.seed_locate import seed_locate_batch
    from lexicmap_tpu_torch.parallel.device_search import DeviceSeedMatcher

    k = 31
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    table = torch.randint(0, 1 << 62, (M, E), generator=g, device=dev).sort(dim=1).values
    kmers = table.cpu().numpy().astype(np.uint64).reshape(-1)
    del table
    off = np.arange(M + 1, dtype=np.int64) * E
    t0 = time.perf_counter()
    matcher = DeviceSeedMatcher(_StandIn(kmers, off, k), device=dev)
    init_s = time.perf_counter() - t0
    log(f"[matcher] {matcher.describe()}; init {init_s:.1f} s")
    if matcher.host_rows:
        raise AssertionError("the smoke table must be wholly device-resident")

    rng = np.random.default_rng(seed + 2)
    q = rng.integers(0, 1 << 62, size=(B, M), dtype=np.uint64)
    drawn = kmers[off[:-1][None, :] + rng.integers(0, E, size=(B, M))]
    mut = rng.integers(0, 1 << (2 * (k - p)), size=(B, M), dtype=np.uint64)
    q[: B // 2] = (drawn ^ mut)[: B // 2]  # same >=p-base prefix, mutated suffix
    q[rng.random((B, M)) < 0.1] = 0  # masks that captured nothing

    launches0 = (seed_locate_batch.launches, seed_compact.launches)
    got = matcher.match_batch(q, p)
    ms = time_ms(lambda: matcher.match_batch(q, p), dev, reps, warmup=0)
    # the device part alone: upload, B1, the compaction with its one wait
    # for the offsets; not the fetch of the triples
    qh, sel = matcher.query_words(q)
    dev_ms = time_ms(lambda: matcher.device_hits(qh, sel, p), dev, reps, warmup=0)
    launches = seed_locate_batch.launches - launches0[0]
    compactions = seed_compact.launches - launches0[1]

    want = oracle_triples(kmers, off, q, k, p)
    check_triples(got, want, "matcher")
    n_trip = sum(w[0].shape[0] for w in want)
    log(f"[matcher] {B} queries x {M} masks: triples == numpy bisection oracle "
        f"({n_trip} triples); {ms:.3f} ms/batch, of which {dev_ms:.3f} ms upload + "
        f"B1 + compaction (its wait for the offsets); {launches} B1 and {compactions} B4 "
        f"launches for {1 + 2 * reps} batches, hbm_bytes={matcher.hbm_bytes} [{card}]")
    if dev.type == "cuda" and (launches != (1 + 2 * reps) * len(matcher.buckets)
                               or compactions != 1 + 2 * reps):
        raise AssertionError(f"expected one B1 launch per bucket and one compaction per "
                             f"batch, saw {launches} and {compactions}")
    comp = compaction_in_batch(dev, card, matcher, qh, sel, p, want, reps * 4, parent=parent)
    split = tail_split(dev, card, matcher, q, p, reps * 2, "10k shape")
    res = {"hbm_bytes": matcher.hbm_bytes, "ms_per_batch": ms, "device_ms": dev_ms,
           "triples": n_trip, "launches": launches, "compactions": compactions,
           "init_s": init_s, "compaction": comp, "tail_split": split}
    return res, {"kmers": kmers, "off": off, "q": q, "k": k, "matcher": matcher}


def oracle_triples(kmers, off, q, k, p):
    """Each query's (mask, e0, n_hits) by a numpy bisection of each mask's
    sorted entries kmers[off[m]:off[m+1]], in mask order."""
    import numpy as np

    suf = np.uint64((1 << (2 * (k - p))) - 1)
    bsel, msel = np.nonzero(q != 0)
    x = q[bsel, msel]
    lo = segment_bisect(kmers, off[msel], off[msel + 1], x & ~suf, "left")
    hi = segment_bisect(kmers, off[msel], off[msel + 1], x | suf, "right")
    out = []
    for b in range(q.shape[0]):
        s = (bsel == b) & (hi > lo)
        out.append((msel[s], lo[s] - off[msel[s]], (hi - lo)[s]))
    return out


def check_triples(got, want, what):
    import numpy as np

    for b, (g, w) in enumerate(zip(got, want)):
        if g is None or any(not np.array_equal(a, x) for a, x in zip(g, w)):
            raise AssertionError(f"{what}: triples of query {b} differ from the bisection oracle")
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} queries, the oracle {len(want)}")


def nonzero_rows(nh, e0, bk):
    """int64 [4, n] (query, mask, e0 + base, n_hits) of one bucket's hit
    (query, row) pairs, by torch.nonzero and gathers: the port's compaction
    before B4 had a kernel."""
    import torch

    b_idx, r_idx = torch.nonzero(nh > 0, as_tuple=True)
    return torch.stack([b_idx, bk.gids[r_idx], e0[b_idx, r_idx].to(torch.int64) + bk.base[r_idx],
                        nh[b_idx, r_idx].to(torch.int64)])


def library_compaction(matcher, stacked, B):
    """The library calls for B4's function: nonzero_rows a bucket, then
    torch.sort of one int64 (query, mask, e0) key and the gathers.  Gives
    the unmerged hit rows, in the order of seed_compact's triples."""
    import torch

    starts = matcher.order.starts.tolist()
    t = torch.cat([nonzero_rows(*stacked[2 * B * s0: 2 * B * s1].view(2, B, s1 - s0), bk)
                   for bk, s0, s1 in zip(matcher.buckets, starts[:-1], starts[1:])], dim=1)
    key = (t[0] * matcher.m + t[1]) * (matcher.total_entries + 1) + t[2]
    return t[:, torch.sort(key).indices]


def parent_compact(lib, stacked, B, order, span=128):
    """The earlier tree's two-pass B4 (--compare-source OLD/seed_compact.cu)
    as its wrapper ran it: a memset and the count pass, a wait for the
    offsets, then the write pass into [3, T]."""
    import torch

    R, nb = order.perm.shape[0], order.starts.shape[0] - 1
    dev = stacked.device
    units = B * -(-R // span)
    scratch = torch.empty(units + 1, dtype=torch.int32, device=dev)
    woff = torch.empty(units + B + 1, dtype=torch.int64, device=dev)
    ptrs = [t.data_ptr() for t in (stacked, order.perm, order.cont, order.gid, order.base,
                                   order.starts)]
    stream = torch.cuda.current_stream().cuda_stream
    if lib.seed_compact_count(*ptrs, nb, R, B, span, scratch.data_ptr(), woff.data_ptr(),
                              stream):
        raise RuntimeError("the earlier seed_compact's count pass failed to launch")
    offsets = woff[units:].cpu()
    T = int(offsets[B])
    out = torch.empty((3, T), dtype=torch.int64, device=dev)
    if lib.seed_compact_write(*ptrs, nb, R, B, span, woff.data_ptr(), T, out.data_ptr(),
                              stream):
        raise RuntimeError("the earlier seed_compact's write pass failed to launch")
    return offsets, out


COMPACT_KERNEL = "compact_lookback"  # the one kernel of seed_compact.cu
PARENT_COMPACT_KERNELS = ("compact_count", "compact_write")  # the earlier tree's two
# each of them once a call
COMPACT_ROWS_A_CALL = ({k: 1 for k in PARENT_COMPACT_KERNELS}, {COMPACT_KERNEL: 1})


def kernel_rows_per_call(fn, reps=10) -> list:
    """The names of the kernel rows (not memsets, not copies) that one call
    of fn makes, from a trace of `reps` calls; raises unless every call
    makes the same rows."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(5):  # a trace now and then comes back with rows missing: again
        rows = [name for name, _ in _cuda_rows(fn, reps)
                if not name.startswith(("Memcpy", "Memset"))]
        if rows and len(rows) % reps == 0:
            break
    if not rows or len(rows) % reps:
        raise AssertionError(f"{len(rows)} kernel rows over {reps} calls: {sorted(set(rows))}")
    return rows[: len(rows) // reps]


def check_one_compact_row(call, what):
    """One call of seed_compact makes exactly one kernel row, its kernel's
    (None in a rehearsal on the CPU)."""
    import torch

    if not torch.cuda.is_available():
        return None
    rows = kernel_rows_per_call(call)
    if len(rows) != 1 or COMPACT_KERNEL not in rows[0]:
        raise AssertionError(f"seed_compact ({what}): a call made the kernel rows {rows}, "
                             f"expected one {COMPACT_KERNEL}")
    return rows


def compact_bytes(stacked, B, order, T):
    """The bytes B4's function must move on these inputs: every n_hits read
    (through the row order, all of them), the 32-byte sectors holding the
    e0 of a hit and the gid and base of a row with a hit in any query, the
    triples and offsets written.  Returns (bytes, the row order's own perm,
    src and cont bytes)."""
    import numpy as np

    st = stacked.cpu().numpy()
    starts = order.starts.tolist()
    R = starts[-1]
    ordered_at = np.argsort(order.perm.cpu().numpy())  # global row -> ordered row
    e0_sectors, rows_hit = [], np.zeros(R, dtype=bool)
    for s0, s1 in zip(starts[:-1], starts[1:]):
        mb = s1 - s0
        b, r = np.nonzero(st[2 * B * s0: 2 * B * s0 + B * mb].reshape(B, mb) > 0)
        e0_sectors.append((2 * B * s0 + B * mb + b * mb + r) * 4 // SECTOR)
        rows_hit[ordered_at[s0 + r]] = True
    e0_sectors = np.unique(np.concatenate(e0_sectors)) if e0_sectors else np.zeros(0)
    row_sectors = np.unique(np.nonzero(rows_hit)[0] * 8 // SECTOR)
    nbytes = (B * R * 4 + (e0_sectors.shape[0] + 2 * row_sectors.shape[0]) * SECTOR
              + T * 24 + (B + 1) * 8)
    return nbytes, R * 13


def compaction_in_batch(dev, card, matcher, qh, sel, p, want, reps, label="10k shape",
                        parent=None):
    """B4 (seed_compact) on B1's outputs of the matcher's batch, all its
    buckets in one stacked buffer: the kernel == its plain version == the
    bisection oracle's triples, exactly.  Its time as called (the memset,
    the one launch, the wait for the offsets) and on the device (the
    kernel's profiler row: one a call, asserted), the plain version's, the
    library call's (library_compaction; on the device, every kernel row of
    a call), the bound from the bytes this run's data needs
    (compact_bytes); with `parent` (the earlier tree's library), its
    two-pass compaction in turns with this one."""
    import numpy as np

    from lexicmap_tpu_torch.kernels.seed_compact import seed_compact, seed_compact_plain
    from lexicmap_tpu_torch.kernels.seed_locate import seed_locate_batch

    B = qh.shape[0]
    saved = (seed_locate_batch.launches, seed_compact.launches)
    stacked = matcher.locate_all(qh, sel, p)
    order = matcher.order

    def call():
        return seed_compact(stacked, B, order)

    off, trip = call()
    poff, ptrip = seed_compact_plain(stacked, B, order)
    got = [tuple(a) for a in np.split(trip.cpu().numpy(), off.numpy()[1:-1], axis=1)]
    err = int_err((off, trip), (poff, ptrip))
    if err:
        raise AssertionError(f"B4 at the {label}: kernel != plain (max abs err {err})")
    check_triples(got, want, f"B4 at the {label}")
    ms = time_ms(call, dev, reps)
    rows = check_one_compact_row(call, label)
    by = device_ms_split(call, (COMPACT_KERNEL,), reps)
    lib = library_compaction(matcher, stacked, B)
    if lib.shape[1] < trip.shape[1] or not np.array_equal(
            np.unique(lib[1].cpu().numpy()), np.unique(trip[0].cpu().numpy())):
        raise AssertionError(f"B4 at the {label}: the library call's rows disagree")
    nbytes, design = compact_bytes(stacked, B, order, trip.shape[1])
    res = {"B": B, "R": int(order.perm.shape[0]), "buckets": len(matcher.buckets),
           "triples": int(trip.shape[1]), "hit_rows": int(lib.shape[1]),
           "equal": True, "max_abs_err": err, "ms": ms,
           "device_ms": None if None in by.values() else sum(by.values()),
           "device_ms_by": by,
           "plain_ms": time_ms(lambda: seed_compact_plain(stacked, B, order), dev, 3),
           "library_ms": time_ms(lambda: library_compaction(matcher, stacked, B), dev, reps),
           "library_device_ms": device_ms_by_call(
               lambda: library_compaction(matcher, stacked, B), ("",), reps)[""],
           "bytes": nbytes, "design_bytes": design,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "kernel_rows_per_call": rows}
    if parent is not None:
        res["parent"] = split_in_turns(dev, lambda: parent_compact(parent, stacked, B, order),
                                       call, PARENT_COMPACT_KERNELS, (COMPACT_KERNEL,), reps,
                                       a_call=COMPACT_ROWS_A_CALL)
    seed_locate_batch.launches, seed_compact.launches = saved  # measuring does not count
    log(f"[matcher] B4 at the {label}: kernel == plain == oracle; {json.dumps(res)} [{card}]")
    return res


def tail_split(dev, card, matcher, q, p, reps, label):
    """match_batch's time split into the k-mer split (query_words), the
    device part (upload, B1 and the compaction, up to its result on the
    card), the fetch of the triples and the host tail, for this tree's path
    and the parent's (B1 a bucket, torch.nonzero and gathers a bucket, one
    fetch, then the host's np.lexsort and per-query merge, sort_merge),
    run in turns (parent, this, this, parent); both == match_batch's
    triples.  Host clock, the card synchronised after each part."""
    import numpy as np
    import torch

    from lexicmap_tpu_torch.kernels.seed_compact import seed_compact
    from lexicmap_tpu_torch.kernels.seed_locate import seed_locate_batch
    from lexicmap_tpu_torch.parallel.device_search import sort_merge

    B = q.shape[0]
    want = matcher.match_batch(q, p)
    saved = (seed_locate_batch.launches, seed_compact.launches)

    def parent():
        t = [time.perf_counter()]
        qh, sel = matcher.query_words(q)
        t.append(time.perf_counter())
        qh_d = torch.from_numpy(qh.view(np.int32)).to(dev)
        sel_d = torch.from_numpy(sel).to(dev)
        out = torch.cat([nonzero_rows(*seed_locate_batch(
            bk.hi, bk.cnt, qh_d.index_select(1, bk.gids), sel_d.index_select(1, bk.gids), p),
            bk) for bk in matcher.buckets], dim=1)
        sync(dev)
        t.append(time.perf_counter())
        qb, hm, e0, nh = out.cpu().numpy()
        t.append(time.perf_counter())
        res = sort_merge(B, qb, hm, e0, nh)
        t.append(time.perf_counter())
        return res, np.diff(t) * 1e3

    def this():
        t = [time.perf_counter()]
        qh, sel = matcher.query_words(q)
        t.append(time.perf_counter())
        offsets, triples = matcher.device_hits(qh, sel, p)
        sync(dev)
        t.append(time.perf_counter())
        hm, e0, nh = triples.cpu().numpy()
        t.append(time.perf_counter())
        off = offsets.numpy()
        res = [(hm[s:e], e0[s:e], nh[s:e]) for s, e in zip(off[:-1], off[1:])]
        t.append(time.perf_counter())
        return res, np.diff(t) * 1e3

    times = {"parent": [], "this": []}
    for name in ("parent", "this") + ("this", "parent", "parent", "this") * max(1, reps // 2):
        got, ms = (parent if name == "parent" else this)()
        times[name].append(ms)
        if any(not np.array_equal(a, w) for g, x in zip(got, want) for a, w in zip(g, x)):
            raise AssertionError(f"tail split ({label}): the {name} path's triples differ")
    seed_locate_batch.launches, seed_compact.launches = saved
    parts = ("split", "device", "fetch", "tail")
    res = {"label": label, "B": B, "triples": sum(w[0].shape[0] for w in want), "runs": {
        name: {part: float(np.mean(np.array(ts)[1:, i])) for i, part in enumerate(parts)}
        for name, ts in times.items()}}  # the first run of each is warm-up
    for name in times:
        res["runs"][name]["total"] = sum(res["runs"][name].values())
    log(f"[matcher] match_batch split, {label} (ms, mean of {len(times['this']) - 1} in "
        f"turns): {json.dumps(res)} [{card}]")
    return res


def phase_matcher_chunked(dev, card, seed, reps, M=2000, B=32, p=15, counts=(2000, 14_001),
                          big_max=60_001, parent=None):
    """The matcher over masks of 2,000-14,000 entries and, for one in
    sixteen, 16,385-60,000 (over E_CAP = 16,384, so column-chunked, the
    last chunk mostly in a smaller bucket), with a block of entries sharing
    one 15-base prefix across each chunk boundary of those masks, and 8
    queries carrying those prefixes: hits whose chunk runs cross buckets.
    match_batch == the bisection oracle, and B4 there as at the 10k shape.
    (A rehearsal on the CPU shrinks M, `counts`, `big_max` and DS.E_CAP.)"""
    import numpy as np

    from lexicmap_tpu_torch.kernels.seed_compact import seed_compact
    from lexicmap_tpu_torch.kernels.seed_locate import seed_locate_batch
    from lexicmap_tpu_torch.parallel import device_search as DS

    k = 31
    rng = np.random.default_rng(seed + 17)
    cap = DS.E_CAP
    counts = rng.integers(*counts, M)
    big = rng.random(M) < 1 / 16
    counts[big] = rng.integers(cap + 1, big_max, int(big.sum()))
    off = np.zeros(M + 1, dtype=np.int64)
    np.cumsum(counts, out=off[1:])
    kmers = rng.integers(1, 1 << 62, size=int(off[-1]), dtype=np.uint64)
    planted = []  # (mask, the 15-base prefix's k-mer)
    for m in range(M):
        row = np.sort(kmers[off[m]: off[m + 1]])
        for edge in range(cap, int(counts[m]), cap):
            a = edge - int(rng.integers(cap // 300 + 1, cap // 8))
            b = edge + int(rng.integers(cap // 300 + 1, cap // 8))
            b = min(b, int(counts[m]))
            top = row[a] >> np.uint64(32)
            row[a:b] = (top << np.uint64(32)) | rng.integers(0, 1 << 32, size=b - a,
                                                              dtype=np.uint64)
            planted.append((m, top << np.uint64(32)))
            row.sort()
        kmers[off[m]: off[m + 1]] = row
    matcher = DS.DeviceSeedMatcher(_StandIn(kmers, off, k), device=dev)
    if matcher.host_rows or len(matcher.buckets) < 2:
        raise AssertionError(f"chunked table: {matcher.describe()}")
    q = kmers[off[:-1][None, :] + rng.integers(0, 1 << 40, size=(B, M)) % counts[None, :]]
    q ^= rng.integers(0, 1 << (2 * (k - p)), size=(B, M), dtype=np.uint64)
    q[B // 2:] = rng.integers(1, 1 << 62, size=(B - B // 2, M), dtype=np.uint64)
    for i, (m, pre) in enumerate(planted):
        q[i % 8, m] = pre | np.uint64(i)
    q[rng.random((B, M)) < 0.1] = 0
    saved = (seed_locate_batch.launches, seed_compact.launches)
    got = matcher.match_batch(q, p)
    want = oracle_triples(kmers, off, q, k, p)
    check_triples(got, want, "chunked matcher")
    # triples made of chunk rows of more than one bucket
    o = matcher.order
    bucket = np.searchsorted(o.starts.cpu().numpy(), o.perm.cpu().numpy(), "right") - 1
    gid, base = o.gid.cpu().numpy(), o.base.cpu().numpy()
    row_of = {(int(g), int(b)): i for i, (g, b) in enumerate(zip(gid, base))}
    across = rows = 0
    for hm, e0, nh in got:
        for g, s, n in zip(hm.tolist(), e0.tolist(), nh.tolist()):
            first, last = s // cap * cap, (s + n - 1) // cap * cap
            if first != last:
                rows += 1
                bks = {bucket[row_of[(g, c)]] for c in range(first, last + 1, cap)}
                across += len(bks) > 1
    if not across:
        raise AssertionError("chunked table: no chunk run crossed buckets")
    seed_locate_batch.launches, seed_compact.launches = saved
    qh, sel = matcher.query_words(q)
    comp = compaction_in_batch(dev, card, matcher, qh, sel, p, want, reps * 4,
                               "chunked table", parent)
    res = {"masks": M, "chunked_masks": int(big.sum()), "rows": int(o.perm.shape[0]),
           "buckets": [b.E for b in matcher.buckets], "triples": comp["triples"],
           "runs_over_chunks": rows, "runs_across_buckets": across, "compaction": comp}
    log(f"[matcher] chunked table ({matcher.describe()}): triples == numpy bisection oracle, "
        f"{rows} triples over several chunk rows, {across} across buckets [{card}]")
    return res


# --------------------------------------------------------------------------
# phase 4b: the sharded matcher's kernels at the 10k shape, one NCCL rank
# holding four tp shards


REVERSE_KERNEL = "reverse_dispatch_kernel"  # the one kernel of reverse_dispatch.cu


def reverse_batch(seed, B=32, k=31, m=20_000):
    """The main path's batch for the reversed dispatch: the gtdb.genes
    masks (k = 31, 20,000 masks, seed 1) and B queries of the genes mix's
    lengths (log-normal, median 1 kb, sigma 0.6, 300-5,000 bp) of i.i.d.
    bases, each through phase 1 (capture, low-complexity filter) of a
    searcher that holds only the masks.  Returns (searcher, masked k-mers
    uint64 [B, m], lengths)."""
    import numpy as np

    from lexicmap_tpu_torch.masks import MaskSet
    from lexicmap_tpu_torch.utils.kmers import seq_to_codes

    s = parity().masks_searcher("lexicmap_tpu_torch", MaskSet.generate(k, m, 1).masks, k)
    rng = np.random.default_rng(seed)
    lens = np.clip(np.exp(rng.normal(np.log(1000), 0.6, B)), 300, 5000).astype(np.int64)
    seqs = [bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), int(n))) for n in lens]
    return s, np.stack([s._mask_query(seq_to_codes(q))[0] for q in seqs]), lens


def phase_reverse(dev, card, seed, reps, B=32, m=20_000):
    """The reversed-k-mer dispatch (reverse_dispatch.cu) at the main path's
    shape (reverse_batch): the kernel == its plain version == the host's
    IndexSearcher._reversed_query_kmers for every query, array for array
    (values, dtypes, order), no query declined.  Times: as called (launch,
    the waits for the offsets and the records; with the k-mers' upload
    too), on the device (one kernel row a call, asserted), the plain
    version's and the host's (the 32 serial calls it replaces); the bound
    from the bytes the batch needs: the k-mers and the tree read once, the
    records and offsets written once."""
    import numpy as np
    import torch

    from lexicmap_tpu_torch.kernels import reverse_dispatch as RD

    s, kmers, lens = reverse_batch(seed, B, m=m)
    host_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        want = [s._reversed_query_kmers(kmers[b]) for b in range(B)]
        host_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    mt = RD.mask_tree(s.mask_set.masks, s.k, dev)
    tree_s = time.perf_counter() - t0
    t = torch.from_numpy(kmers.view(np.int64)).to(dev)
    saved = RD.reverse_dispatch.launches
    got = RD.reverse_dispatch(t, mt)()
    sync(dev)
    plain = RD.reverse_dispatch_plain(t, mt)
    cols = ("offsets", "declined", "new_mask", "rev_kmer", "orig_mask")
    bad = [c for c in cols if not (getattr(got, c).dtype == getattr(plain, c).dtype
                                   and np.array_equal(getattr(got, c), getattr(plain, c)))]
    if bad:
        raise AssertionError(f"reverse_dispatch: kernel != plain in {bad}")
    if got.declined.any():
        raise AssertionError(f"reverse_dispatch declined queries {np.flatnonzero(got.declined)}")
    for b in range(B):
        if not all(g.dtype == w.dtype and np.array_equal(g, w)
                   for g, w in zip(got.query(b), want[b])):
            raise AssertionError(f"reverse_dispatch: query {b} != the host's arrays")

    def call():
        return RD.reverse_dispatch(t, mt)()

    ms = time_ms(call, dev, reps)
    upload_ms = time_ms(lambda: RD.reverse_dispatch(
        torch.from_numpy(kmers.view(np.int64)).to(dev), mt)(), dev, reps)
    by, rows = device_rows_by_call(call, (REVERSE_KERNEL,), reps, a_call={REVERSE_KERNEL: 1})
    T = int(got.offsets[-1])
    largest = max(int(np.unique(got.query(b)[0], return_counts=True)[1].max())
                  for b in range(B) if got.offsets[b + 1] > got.offsets[b])
    nbytes = kmers.nbytes + mt.tree.numel() * 8 + T * 16 + (2 * B + 1) * 8
    res = {"B": B, "m": m, "k": s.k, "query_bp": [int(lens.min()), int(np.median(lens)),
                                                  int(lens.max())],
           "captures": int((kmers != 0).sum()), "records": T, "largest_bucket": largest,
           "equal": True, "max_abs_err": 0, "ms": ms, "ms_with_upload": upload_ms,
           "device_ms": by[REVERSE_KERNEL], "device_ms_by": by, "kernel_rows_per_call": rows,
           "plain_ms": time_ms(lambda: RD.reverse_dispatch_plain(t, mt), dev, 3),
           "host_ms": min(host_s) * 1e3, "tree_s": tree_s, "bytes": nbytes,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    RD.reverse_dispatch.launches = saved  # measuring does not count
    log(f"[reverse] kernel == plain == the host's arrays; {json.dumps(res)} [{card}]")
    return res


def reverse_row(rres, eres):
    """The kernels line's row of the reversed dispatch (B13): the numbers at
    the main path's shape, launches from phase 6 (one a batch)."""
    return {"name": "reverse_dispatch", "route": "cuda",
            "source": "lexicmap_tpu_torch/csrc/reverse_dispatch.cu",
            "replaces": "none: the host's IndexSearcher._reversed_query_kmers, a query at a "
                        "time (lexicmap_tpu/index/search.py)",
            "launches": eres["launches"]["reverse_dispatch"], "equal": rres["equal"],
            "max_abs_err": rres["max_abs_err"], "ms": rres["ms"],
            "ms_with_upload": rres["ms_with_upload"], "device_ms": rres["device_ms"],
            "device_ms_by": rres["device_ms_by"], "plain_ms": rres["plain_ms"],
            "host_ms": rres["host_ms"], "bound_ms": rres["bound_ms"], "bound_by": "bytes",
            "bytes": rres["bytes"], "library_ms": None,
            "library": "none: no PyTorch call computes a nearest mask by XOR",
            "kernel_rows_per_call": rres["kernel_rows_per_call"],
            "shape": {k: rres[k] for k in ("B", "m", "k", "query_bp", "captures", "records",
                                           "largest_bucket")}}


def host_shard_count(hi, qh, k, p):
    """B11's definition in int64 numpy: (n_hits, lcp) [B, M] and the
    per-query sums, by bisection over each whole padded row."""
    import numpy as np

    M, E = hi.shape
    suf = (1 << (2 * (k - p))) - 1
    flat = hi.reshape(-1).astype(np.int64)
    q = qh.astype(np.int64)
    B = q.shape[0]
    starts = np.broadcast_to(np.arange(M, dtype=np.int64) * E, (B, M)).reshape(-1)
    qf = q.reshape(-1)
    e0 = segment_bisect(flat, starts, starts + E, qf & (0xFFFFFFFF ^ suf), "left") - starts
    e1 = segment_bisect(flat, starts, starts + E, qf | suf, "right") - starts
    nh = np.where(qf != 0, e1 - e0, 0)
    x = flat[starts + np.minimum(e0, E - 1)] ^ qf
    bitlen = np.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = (x >> s) != 0
        bitlen += np.where(big, s, 0)
        x = np.where(big, x >> s, x)
    bitlen += x != 0
    lcp = np.where(nh > 0, ((32 - bitlen) >> 1) + k - 16, 0)
    nh, lcp = nh.reshape(B, M), lcp.reshape(B, M)
    return nh, lcp, (nh * lcp).sum(1)


def phase_sharded(dev, card, state, seed, reps, parent=None):
    """B11 through make_sharded_search_step and B12 through
    ShardedSeedMatcher on a one-rank NCCL mesh with four local shards, over
    phase 4's table; the entry's dry run on the card; with `parent` (the
    earlier tree's sharded.cu), its compaction (a launch a shard) in turns
    with this one's launch over the four.  Returns (B11's result, B12's
    result, the mesh)."""
    import numpy as np
    import torch

    from lexicmap_tpu_torch import entry as TE
    from lexicmap_tpu_torch.kernels import seed_match_shard as MS
    from lexicmap_tpu_torch.kernels import shard_compact as SC
    from lexicmap_tpu_torch.kernels.seed_locate import PAD_HI, seed_locate_batch, split_kmers_hi_lo
    from lexicmap_tpu_torch.parallel import sharded as TS

    kmers, off, q, k = state["kmers"], state["off"], state["q"], state["k"]
    M, B, p = off.shape[0] - 1, q.shape[0], 15
    E = kmers.shape[0] // M
    mesh = TS.make_mesh(local_shards=4, device=dev)
    L = mesh.local_shards
    log(f"[sharded] {mesh!r}, backend {torch.distributed.get_backend()}")

    # B11's table: phase 4's 31-mers as 16-mer hi words, row 0 a quarter pad
    # words, row 1 all-T prefixes before its pad words; all-T queries there
    rng = np.random.default_rng(seed + 20)
    hi = split_kmers_hi_lo(kmers, k)[0].reshape(M, E)
    hi[0, 3 * E // 4:] = PAD_HI
    hi[1, E // 2:] = np.uint32(0xFFFFFF00) + rng.integers(0, 0xF0, E - E // 2, dtype=np.uint32)
    hi[1, E - 64:] = PAD_HI
    hi[1] = np.sort(hi[1])
    qh = np.zeros((B, M), dtype=np.uint32)
    qh[q != 0] = split_kmers_hi_lo(q[q != 0], k)[0]
    qh[0, 0], qh[1, 1] = 0xFFFFFFFF, 0xFFFFFFFD
    s_seeds, s_queries = TS.shard_arrays(mesh, hi, qh)
    step = TS.make_sharded_search_step(mesh, k=16, min_prefix=p)

    # the path: the step at this shape, then the entry's dry run on the card
    recorded, real = [], TS.seed_match_shard

    def recording(*a):
        out = real(*a)
        if len(recorded) < 2:  # the main path's inputs and outputs, kept
            recorded.append((a, tuple(x.clone() for x in out)))
        return out

    TS.seed_match_shard = recording
    reset_launches()  # the sharded step's run starts here
    try:
        scores = step(s_seeds, s_queries)
        sync(dev)
        TE.dryrun_multichip(L, dev)
    finally:
        TS.seed_match_shard = real
    launches = launch_counts()  # ... and ends here
    if dev.type == "cuda" and launches["seed_match_shard"] != 2:
        raise AssertionError(f"the step and the dry run launched seed_match_shard "
                             f"{launches['seed_match_shard']} times, expected 2 (one each)")
    main_err, main_shape = 0, []
    for a, got in recorded:
        want = MS.seed_match_shard_plain(*a)
        err = int_err(got, want)
        if err or not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"main path: seed_match_shard != plain (max abs err {err})")
        main_err = max(main_err, err)
        main_shape.append({"L": int(a[0].shape[0]), "B": int(a[1].shape[1]),
                           "M": int(a[0].shape[1]), "E": int(a[0].shape[2]), "k": a[2],
                           "p": a[3]})
    log(f"[sharded] main path, first {len(recorded)} seed_match_shard launches: kernel == "
        f"plain on {json.dumps(main_shape)}")

    # the rank's launch over its L shards and each shard's own launch
    # against the plain twin, and the whole against an int64 numpy count of
    # the definition
    saved = launch_counts()
    out = MS.seed_match_shard(s_seeds, s_queries, 16, p)
    err = int_err(out, MS.seed_match_shard_plain(s_seeds, s_queries, 16, p))
    for l in range(L):
        got = MS.seed_match_shard(s_seeds[l], s_queries[l], 16, p)
        want = MS.seed_match_shard_plain(s_seeds[l], s_queries[l], 16, p)
        err = max(err, int_err(got, want), int_err(got[:2], (out[0][l], out[1][l])))
    if err:
        raise AssertionError(f"seed_match_shard != plain over the {L} shards (max abs err {err})")
    hn, hl, hs = host_shard_count(hi, qh, 16, p)
    nh = out[0].permute(1, 0, 2).reshape(B, M).cpu().numpy()
    lcp = out[1].permute(1, 0, 2).reshape(B, M).cpu().numpy()
    sc = scores.cpu().numpy()
    if not (np.array_equal(nh, hn) and np.array_equal(lcp, hl) and
            np.array_equal(sc.astype(np.int64), hs) and
            np.array_equal(out[2].cpu().numpy(), sc) and hs.max() < 1 << 24):
        raise AssertionError("seed_match_shard / the step disagree with the int64 host count")
    if nh[0, 0] < E // 4 or nh[1, 1] < 64:
        raise AssertionError("the all-T queries must count the pad words")
    log(f"[sharded] seed_match_shard: kernel == plain in one launch over {L} shards of "
        f"{M // L} x {E} and on each shard alone; n_hits, lcp and the step's scores == int64 "
        f"host count ({int((nh > 0).sum())} cells with hits; largest score "
        f"{float(sc.max())}, under 2^24)")

    def b11():
        return MS.seed_match_shard(s_seeds, s_queries, 16, p)

    ms = time_ms(b11, dev, reps)
    by = device_ms_split(b11, ("match_shard",), reps)
    dev_ms = by["match_shard"]
    step_ms = time_ms(lambda: step(s_seeds, s_queries), dev, reps)
    plain_ms = time_ms(lambda: MS.seed_match_shard_plain(s_seeds, s_queries, 16, p), dev, 2)
    hi64 = s_seeds.reshape(M, E).long() & 0xFFFFFFFF
    qs = s_queries.permute(1, 0, 2).reshape(B, M)
    q64 = qs.T.contiguous().long() & 0xFFFFFFFF
    suf = (1 << (2 * (16 - p))) - 1
    lb, rb = q64 & (0xFFFFFFFF ^ suf), q64 | suf

    def library():
        return torch.searchsorted(hi64, lb), torch.searchsorted(hi64, rb, right=True)

    if not torch.equal((library()[1] - library()[0]).T.cpu().where(qs.cpu() != 0, 0),
                       torch.from_numpy(nh).long()):
        raise AssertionError("library searchsorted disagrees with the kernel")
    library_ms = time_ms(library, dev, reps)
    sector_bytes, probes = bisection_probe_bytes(
        hi64, torch.full((M,), E, dtype=torch.int32, device=dev), qs, qs != 0, p,
        rb_from_lb=False)
    del hi64, q64, lb, rb
    rn, _, design = parity().shard_match_replay(s_seeds.reshape(M, E), qs, p)
    if not np.array_equal(rn.cpu().numpy(), nh):
        raise AssertionError("the torch replay of match_shard's search disagrees with the kernel")
    design_bytes = design.numel() * SECTOR
    io_bytes = B * M * 4 + 2 * B * M * 4 + B * 4
    bound_ms, bound_by = locate_bound(sector_bytes, design_bytes, probes, io_bytes)
    b11res = {"M": M, "E": E, "B": B, "k": 16, "p": p, "L": L, "equal": True,
              "max_abs_err": max(err, main_err), "main_path_err": main_err,
              "main_path_shape": main_shape, "launches": launches["seed_match_shard"],
              "ms": ms, "device_ms": dev_ms, "device_ms_by": by, "step_ms": step_ms,
              "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "sector_bytes": sector_bytes, "design_bytes": design_bytes,
              "io_bytes": io_bytes, "probes": probes, "table_bytes": M * E * 4,
              "largest_score": float(sc.max())}
    log(f"[sharded] seed_match_shard, one launch for {L} shards: ms={ms:.4f} (device {dev_ms}) "
        f"step as called {step_ms:.4f} plain_ms={plain_ms:.2f} library_ms={library_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by}; bisections' sectors {sector_bytes / 1e6:.1f} MB, "
        f"the design's {design_bytes / 1e6:.1f} MB) [{card}]")
    del s_seeds, s_queries, out

    # B12: ShardedSeedMatcher over the 31-mer table, a quarter of the
    # queries drawn from one row in eight at random (under H), half from 90%
    # of the rows (over H: through the second compaction), a quarter random
    q2 = q.copy()
    rows8 = rng.random(M) < 1 / 8
    drawn = kmers[off[:-1][None, :] + rng.integers(0, E, size=(B // 4, M))]
    drawn ^= rng.integers(0, 1 << (2 * (k - p)), size=(B // 4, M), dtype=np.uint64)
    sub = np.where(rows8[None, :], drawn, rng.integers(0, 1 << 62, size=(B // 4, M),
                                                        dtype=np.uint64))
    sub[rng.random(sub.shape) < 0.1] = 0
    q2[B // 2: B // 2 + B // 4] = sub
    t0 = time.perf_counter()
    sm = TS.ShardedSeedMatcher(_StandIn(kmers, off, k), mesh)
    init_s = time.perf_counter() - t0
    log(f"[sharded] {sm.describe()}; init {init_s:.1f} s")
    if sm.host_tables or len(sm.buckets) != 1:
        raise AssertionError("the smoke table must be one bucket, wholly on the card")
    bk = sm.buckets[0]
    H = sm.capacity(bk)
    rec = bound_recorder()
    got = sm.match_batch(q2, p)
    second = counters(rec.totals, "match")
    want = state["matcher"].match_batch(q2, p)
    suf64 = np.uint64((1 << (2 * (k - p))) - 1)
    bsel, msel = np.nonzero(q2 != 0)
    x = q2[bsel, msel]
    lo = segment_bisect(kmers, off[msel], off[msel + 1], x & ~suf64, "left")
    up = segment_bisect(kmers, off[msel], off[msel + 1], x | suf64, "right")
    over = most = 0
    for b in range(B):
        s = (bsel == b) & (up > lo)
        oracle = (msel[s], lo[s] - off[msel[s]], (up - lo)[s])
        fullest = int(np.bincount(oracle[0] % sm.tp, minlength=sm.tp).max())
        over += fullest > H
        most = max(most, fullest)
        if got[b] is None or any(not (np.array_equal(g, o) and np.array_equal(g, w))
                                 for g, o, w in zip(got[b], oracle, want[b])):
            raise AssertionError(f"query {b}: sharded triples != DeviceSeedMatcher's / oracle")
    declined = sum(g is None for g in got)
    if (declined or over < B // 2 or second["match.second_pass_queries"] != over
            or second["match.second_passes"] != 1):
        raise AssertionError(f"expected none declined and >= {B // 2} queries through the "
                             f"second compaction: {declined} declined, {over} over H = {H}, "
                             f"the matcher's counters {second}")
    log(f"[sharded] match_batch: all {B} queries == DeviceSeedMatcher's and the host "
        f"bisection's, none declined; {over} over H = {H} (up to {most} hits a shard) through "
        f"the second compaction, as the matcher reports ({json.dumps(second)})")

    # the compaction of the four shards' locate outputs, stacked as the
    # matcher stacks them, in one launch against its plain twin
    sel = q2 != 0
    qh_full = np.zeros((B, M), dtype=np.uint32)
    qh_full[sel] = split_kmers_hi_lo(q2[sel], k)[0]
    qh4 = np.zeros((L, B, bk.mb_pad), dtype=np.uint32)
    qv4 = np.zeros((L, B, bk.mb_pad), dtype=bool)
    for l, sh in enumerate(mesh.local):
        ids = bk.ids_per_shard[sh]
        qh4[l, :, : ids.shape[0]], qv4[l, :, : ids.shape[0]] = qh_full[:, ids], sel[:, ids]
    qh4 = torch.from_numpy(qh4.view(np.int32)).to(dev)
    qv4 = torch.from_numpy(qv4).to(dev)
    loc = torch.empty((2, L, B, bk.mb_pad), dtype=torch.int32, device=dev)
    for l in range(L):
        seed_locate_batch(bk.hi[l], bk.cnt[l], qh4[l], qv4[l], p, out=loc[:, l])
    a = (loc[0], loc[1], bk.gids, H)
    cgot = SC.shard_compact(*a)
    cwant = SC.shard_compact_all_plain(*a)
    cerr = int_err(cgot, cwant)
    if cerr or not all(torch.equal(x, y) for x, y in zip(cgot, cwant)):
        raise AssertionError(f"shard_compact != plain at the 10k shape (max abs err {cerr})")
    keys = torch.where(loc[0] > 0, bk.gids.long()[:, None, :] & 0xFFFFFFFF, 0xFFFFFFFF)
    c_ms = time_ms(lambda: SC.shard_compact(*a), dev, reps)
    c_dev, c_by = device_ms(lambda: SC.shard_compact(*a), "compact_rows", reps)
    c_plain = time_ms(lambda: SC.shard_compact_all_plain(*a), dev, reps)
    c_lib = time_ms(lambda: torch.sort(keys, dim=-1, stable=True), dev, reps)
    c_bytes = 2 * loc[0].numel() * 4 + bk.gids.numel() * 4 + L * B * (3 * H + 1) * 4
    c_bytes_ms = c_bytes / HBM_BYTES_PER_S * 1e3
    c_ops_ms = 2 * loc[0].numel() / FP32_OPS_PER_S * 1e3
    c_parent = None
    if parent is not None:
        def earlier():  # its _compact_all: a launch a shard into the slab's rows
            out = torch.empty((L, B, 3 * H + 1), dtype=torch.int32, device=dev)
            for l in range(L):
                if parent.shard_compact(loc[0, l].data_ptr(), loc[1, l].data_ptr(),
                                        bk.gids[l].data_ptr(), out[l].data_ptr(), B, bk.mb_pad,
                                        H, torch.cuda.current_stream().cuda_stream):
                    raise RuntimeError("the earlier shard_compact failed to launch")
            return (out,)

        def new():
            out = torch.empty((L, B, 3 * H + 1), dtype=torch.int32, device=dev)
            SC.shard_compact(*a, out=out)
            return (out,)

        c_parent = split_in_turns(dev, earlier, new, ("compact_rows",), ("compact_rows",), reps)
    batch_ms = time_ms(lambda: sm.match_batch(q2, p), dev, 3, warmup=0)
    # the same batch with its over-H half random: the first pass alone
    q3 = q2.copy()
    q3[: B // 2] = rng.integers(0, 1 << 62, size=(B // 2, M), dtype=np.uint64)
    passes = rec.totals["match.second_passes"]
    batch_first_ms = time_ms(lambda: sm.match_batch(q3, p), dev, 3, warmup=0)
    if rec.totals["match.second_passes"] != passes:
        raise AssertionError("the batch without over-H queries took a second compaction")
    for fn in kernel_fns():  # the comparisons' launches do not count
        fn.launches = saved[fn.__name__]
    b12res = {"B": B, "L": L, "mb_pad": bk.mb_pad, "E": bk.E, "H": H, "tile": bk.tile,
              "equal": True, "max_abs_err": cerr, "hits": int((loc[0] > 0).sum()),
              "over_h": int((cgot[3] > H).sum()), "launches_per_bucket": 1,
              "declined_queries": declined, "second_pass_queries": over,
              "most_hits_a_shard": most, "ms": c_ms, "device_ms": c_dev,
              "device_ms_by": c_by, "plain_ms": c_plain, "library_ms": c_lib,
              "bound_ms": max(c_bytes_ms, c_ops_ms),
              "bound_by": "bytes" if c_bytes_ms >= c_ops_ms else "operations",
              "bytes": c_bytes, "matcher_ms_per_batch": batch_ms,
              "matcher_ms_first_pass_only": batch_first_ms, "init_s": init_s,
              "hbm_bytes": sm.hbm_bytes, "parent": c_parent}
    log(f"[sharded] shard_compact, one launch for {L} shards at B={B}, rows={bk.mb_pad}, "
        f"H={H}: kernel == plain; "
        f"{json.dumps({k_: v for k_, v in b12res.items() if 'ms' in k_})}; earlier "
        f"compaction (a launch a shard) in turns {json.dumps(c_parent)} [{card}]")
    del sm, state["matcher"]
    return b11res, b12res, mesh


# --------------------------------------------------------------------------
# phase 5: phase-4 kernels at real state size


class _Store:
    """What DeviceGenomeBlob reads of a genome-store batch."""

    def __init__(self, seq2bit, byte_offsets):
        self.seq2bit = seq2bit
        self.byte_offsets = byte_offsets


def _unpack(b):
    import numpy as np

    return np.stack([(b >> 6) & 3, (b >> 4) & 3, (b >> 2) & 3, b & 3], 1).reshape(-1)


def _pack(c):
    c = c.reshape(-1, 4)
    return (c[:, 0] << 6) | (c[:, 1] << 4) | (c[:, 2] << 2) | c[:, 3]


def genome_codes(store, g, t0, t1):
    """Codes [t0, t1] of genome g of a store (MSB-first 2-bit bytes)."""
    b = int(store.byte_offsets[g])
    raw = store.seq2bit[b + t0 // 4: b + t1 // 4 + 1]
    return _unpack(raw)[t0 % 4: t0 % 4 + t1 - t0 + 1]


def phase4_case(n_stores, per_store, genome_len, n_queries, n_sites, seed):
    """Random 2-bit genomes in `n_stores` store batches; `n_queries` random
    query segments of 1.5-2 kb; a 3%-mutated copy of a query planted at
    each of `n_sites` sites (every other round of sites reverse-
    complemented), each site inside a 2-4 kb window.  Returns (stores,
    queries [codes], windows [(qidx, store, genome, t0, t1, rc)])."""
    import numpy as np

    rng = np.random.default_rng(seed)
    nbytes = genome_len // 4
    stores = [_Store(np.frombuffer(rng.bytes(per_store * nbytes), np.uint8).copy(),
                     np.arange(per_store + 1, dtype=np.int64) * nbytes)
              for _ in range(n_stores)]
    queries = [rng.integers(0, 4, int(L)).astype(np.uint8)
               for L in rng.integers(1500, 2001, n_queries)]
    n_gen = n_stores * per_store
    slot = 8192
    if (n_sites + n_gen - 1) // n_gen * slot > genome_len:
        raise ValueError("too many sites for the genomes")
    windows = []
    for site in range(n_sites):
        qi = site % n_queries
        rc = (site // n_queries) % 2 == 1
        gg, s = site % n_gen, site // n_gen
        st, g = stores[gg // per_store], gg % per_store
        q = queries[qi].copy()
        pos = rng.integers(0, q.shape[0], int(0.03 * q.shape[0]))
        q[pos] = rng.integers(0, 4, pos.shape[0])
        if rc:
            q = (3 - q)[::-1]
        fl, fr = (int(x) for x in rng.integers(200, 1000, 2))
        t0 = s * slot + 1024 - fl + int(rng.integers(0, 64))
        at = t0 + fl
        b = int(st.byte_offsets[g])
        lo, hi = b + at // 4, b + (at + q.shape[0] + 3) // 4
        codes = _unpack(st.seq2bit[lo:hi])
        codes[at % 4: at % 4 + q.shape[0]] = q
        st.seq2bit[lo:hi] = _pack(codes)
        windows.append((qi, gg // per_store, g, t0, at + q.shape[0] - 1 + fr, rc))
    return stores, queries, windows


def native_rows(cpr, tcodes, begin, end, copt):
    """The host's exact chain rows of one window (compare_prepare +
    chain2_backtrack, with align_paths' single-anchor rule), or None."""
    import numpy as np

    from lexicmap_tpu_torch.native import chain2_backtrack_native, compare_prepare_native

    aq, at, al, _arc, scores, prev = compare_prepare_native(
        cpr.qk, cpr.qv, tcodes, cpr.opt.min_prefix, cpr.k, begin, end,
        copt.band_base, copt.band_count, copt.max_gap, qtab=cpr.qtab, bbits=cpr.qtab_bits)
    n = aq.shape[0]
    if n == 0:
        return None
    if n == 1:
        s = int(al[0])
        if s >= copt.min_score and s >= copt.min_align_len:
            return np.array([[1, s, s, s, aq[0], aq[0] + s - 1, at[0], at[0] + s - 1]],
                            dtype=np.int64)
        return None
    rows, _p, _t = chain2_backtrack_native(aq, at, al, scores, prev, float(copt.min_score),
                                           copt.min_align_len,
                                           float(copt.heuristic_kmer_pident_threshold))
    return rows if rows.shape[0] else None


def chain_scan_pairs(fn):
    """Run `fn` and return the number of predecessor visits the native
    Chainer2 DP made meanwhile (core.cpp's scan counters)."""
    import ctypes

    import numpy as np

    from lexicmap_tpu_torch.native import get_lib

    lib = get_lib()
    lib.get_chain2_scan_stats.argtypes = [ctypes.c_void_p]
    out = np.zeros(3, dtype=np.int64)
    lib.get_chain2_scan_stats(out.ctypes.data)  # reset
    fn()
    lib.get_chain2_scan_stats(out.ctypes.data)
    return int(out[0])


def same_prefix(a, b, counts, width):
    """a[w, :counts[w]] == b[w, :counts[w]] for every window w."""
    import torch

    lane = torch.arange(width, device=a.device)
    m = lane[None, :] < counts[:, None].long()
    if a.dim() == 3:
        m = m[:, :, None].expand_as(a)
    return bool(torch.equal(torch.where(m, a, 0), torch.where(m, b, 0)))


def prefix_err(a, b, counts, width):
    """max |a - b| over a[w, :counts[w]] for every window w (0 if empty)."""
    import torch

    lane = torch.arange(width, device=a.device)
    m = lane[None, :] < counts[:, None].long()
    if a.dim() == 3:
        m = m[:, :, None].expand_as(a)
    d = torch.where(m, (a.long() - b.long()).abs(), 0)
    return int(d.max()) if d.numel() else 0


def compare_pseudo(dev, blob, win, tables, chain_args):
    """pseudo_probe and pseudo_chain against their plain versions on one
    batch's inputs (the chain on the probe kernel's anchors).  Returns the
    kernels' outputs, each kernel's largest |kernel - plain| over counts,
    flags and every window's compared prefix, and the plain versions' ms.
    These launches are taken off the kernels' counters."""
    import torch

    from lexicmap_tpu_torch.kernels import pseudo_align as PA

    n0 = (PA.pseudo_probe.launches, PA.pseudo_chain.launches)
    probe = PA.pseudo_probe(blob, win, *tables)
    sync(dev)
    t0 = time.perf_counter()
    probe_p = PA.pseudo_probe_plain(blob, win, *tables)
    probe_plain_ms = (time.perf_counter() - t0) * 1e3
    chain = PA.pseudo_chain(*probe, *chain_args)
    sync(dev)
    t0 = time.perf_counter()
    chain_p = PA.pseudo_chain_plain(*probe, *chain_args)
    chain_plain_ms = (time.perf_counter() - t0) * 1e3
    PA.pseudo_probe.launches, PA.pseudo_chain.launches = n0

    def vec(a, b):
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    pn = torch.maximum(probe[3], probe_p[3])
    perr = max([vec(probe[3], probe_p[3]), vec(probe[4], probe_p[4])]
               + [prefix_err(a, b, pn, PA.A_CAP) for a, b in zip(probe[:3], probe_p[:3])])
    cerr = max(vec(chain[1], chain_p[1]), vec(chain[2], chain_p[2]),
               prefix_err(chain[0], chain_p[0], torch.maximum(chain[1], chain_p[1]), PA.C_CAP))
    return probe, chain, perr, cerr, probe_plain_ms, chain_plain_ms


def chain_chunk_steps(qb, tb, ln, counts, band_base, band_count, max_gap):
    """Per window, the serial steps of pseudo_chain's warp DP on these
    anchors: for each anchor i, the 32-predecessor chunks its scan reads,
    from j = i - 1 down to the first break of the band rules (the plain
    DP's cut) or j = 0.  int64 [W]."""
    import torch

    from lexicmap_tpu_torch.kernels.pseudo_align import _chain_dp

    n = counts.to(torch.int64)
    N = int(n.max()) if n.numel() else 0
    q, t, l = (a[:, :N].to(torch.int64) for a in (qb, tb, ln))
    cut = _chain_dp(q, t, l, n, band_base, band_count, max_gap)[2]
    i = torch.arange(N, device=q.device)[None, :]
    visits = i - cut.clamp(min=0)  # j = i - 1 down to the cut, or to 0
    return torch.where(i < n[:, None], (visits + 31) // 32, 0).sum(1)


def chain_stress(dev):
    """pseudo_chain against its plain version on the chain stress windows of
    tests/torch_parity.py (band_count reached mid-chunk, breaks on every
    lane, ties across a chunk boundary and with the DP's start, bt > at
    skips, 1 to A_CAP anchors, a probe-flagged window) under each of its
    parameter sets; the plain version runs on a CPU copy.  Returns the
    largest |kernel - plain| and the rows compared.  These launches are
    taken off the kernel's counter."""
    import torch

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_parity import CHAIN_PARAMS, chain_stress_windows, chain_tensors

    from lexicmap_tpu_torch.kernels import pseudo_align as PA

    wins = chain_stress_windows(a_cap=PA.A_CAP)
    args = chain_tensors(wins + [wins[2]], dev, flagged=[len(wins)])
    host = [a.cpu() for a in args]
    n0, err, n_rows = PA.pseudo_chain.launches, 0, 0
    for params in CHAIN_PARAMS:
        got = [t.cpu() for t in PA.pseudo_chain(*args, *params)]
        want = PA.pseudo_chain_plain(*host, *params)
        err = max(err, int((got[1] - want[1]).abs().max()), int((got[2] - want[2]).abs().max()),
                  prefix_err(got[0], want[0], torch.maximum(got[1], want[1]), PA.C_CAP))
        n_rows += int(want[1].sum())
    PA.pseudo_chain.launches = n0
    return err, len(args[3]), n_rows


def phase_pseudo(dev, card, n_stores, per_store, genome_len, n_sites, n_sample, seed, reps):
    import numpy as np
    import torch

    from lexicmap_tpu_torch.index.search import SearchOptions
    from lexicmap_tpu_torch.kernels import pseudo_align as PA
    from lexicmap_tpu_torch.ops.seqcompare import SeqComparator
    from lexicmap_tpu_torch.ops.seqcompare import min_prefix_for
    from lexicmap_tpu_torch.parallel.pseudo_device import (
        DevicePseudoAligner, query_tables)
    from lexicmap_tpu_torch.parallel.resident import DeviceGenomeBlob

    t0 = time.perf_counter()
    stores, qcodes, wins = phase4_case(n_stores, per_store, genome_len, 32, n_sites, seed)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    blob = DeviceGenomeBlob(stores, device=dev)
    sync(dev)
    blob_s = time.perf_counter() - t0
    log(f"[phase4] {n_stores * per_store} genomes x {genome_len / 1e6:.1f} Mb: resident blob "
        f"{blob.hbm_bytes / 1e9:.3f} GB built in {blob_s:.1f} s ({n_stores} store batches; "
        f"data made in {gen_s:.1f} s); {n_sites} window sites")
    opts = SearchOptions().seqcompare_options()
    copt = opts.chaining
    cprs = []
    for q in qcodes:
        cpr = SeqComparator(opts)
        cpr.index(q)
        cprs.append(cpr)
    queries = [(c.qk, c.qv) for c in cprs]
    windows, geoms, win = [], [], np.zeros((len(wins), 8), dtype=np.int64)
    for i, (qi, st, g, a, b, rc) in enumerate(wins):
        codes = genome_codes(stores[st], g, a, b)
        codes = np.ascontiguousarray((3 - codes)[::-1] if rc else codes, dtype=np.uint8)
        wb, ph, L = blob.geometry(st, g, a, b, rc, PA.WORDS_OUT)
        windows.append((qi, codes, 0, qcodes[qi].shape[0] - 1))
        geoms.append((wb, ph, rc))
        win[i] = (wb, ph, L, int(rc), qi, 0, qcodes[qi].shape[0] - 1,
                  min_prefix_for(L, opts.min_prefix))
    tables, _ok = query_tables(queries, dev)
    qoff = tables[2].tolist()
    win_d = torch.from_numpy(win).to(dev)
    chain_args = (copt.band_base, copt.band_count, int(copt.max_gap), float(copt.min_score),
                  copt.min_align_len, float(copt.heuristic_kmer_pident_threshold))

    # kernels vs plain on a sample of windows (both strands)
    sample = torch.from_numpy(np.sort(np.random.default_rng(seed).choice(
        len(wins), n_sample, replace=False))).to(dev)
    ws = win_d[sample].contiguous()
    probe, chain, probe_err, chain_err, probe_plain_ms, chain_plain_ms = compare_pseudo(
        dev, blob.words, ws, tables, chain_args)
    if probe_err or chain_err:
        raise AssertionError(f"pseudo_probe / pseudo_chain != plain on the sample windows "
                             f"(max abs err {probe_err} / {chain_err})")
    log(f"[phase4] pseudo_probe and pseudo_chain == plain on {n_sample} sample windows "
        f"({int((probe[3] > 0).sum())} with anchors, {int(chain[1].sum())} chain rows, "
        f"{int((probe[4] != 0).sum() + (chain[2] != 0).sum())} flagged)")

    stress_err, stress_windows, stress_rows = chain_stress(dev)
    if stress_err:
        raise AssertionError(f"pseudo_chain != plain on the chain stress set (max abs err "
                             f"{stress_err})")
    log(f"[phase4] pseudo_chain == plain on the chain stress set ({stress_windows} windows under "
        f"each parameter set of tests/torch_parity.py, {stress_rows} chain rows)")

    # kernel times: the sample (the plain versions' shape) and all windows,
    # the probe called as run_batch calls it (its window table checked on
    # the host copy, so the wrapper does not read it back)
    PA.check_windows(win, len(queries))
    probe_ms = time_ms(lambda: PA.pseudo_probe(blob.words, ws, *tables, checked=True), dev,
                       reps)
    chain_ms = time_ms(lambda: PA.pseudo_chain(*probe, *chain_args), dev, reps)
    full = PA.pseudo_probe(blob.words, win_d, *tables, checked=True)
    full_probe_ms = time_ms(lambda: PA.pseudo_probe(blob.words, win_d, *tables, checked=True),
                            dev, reps)
    full_chain_ms = time_ms(lambda: PA.pseudo_chain(*full, *chain_args), dev, reps)
    # the batch's query tables ready on the card: host staging, the copy
    # and the bucket table (CUDA events around whole calls)
    tables_ms = time_ms(lambda: query_tables(queries, dev), dev, reps)

    # bounds from this run's data
    ns = sample.tolist()
    anchors = int(probe[3].sum())
    rows_out = int(chain[1].sum())
    positions = sum(max(int(win[i, 2]) - PA.K + 1, 0) for i in ns)
    code_bytes = sum((int(win[i, 2]) + 3) // 4 for i in ns)
    qsel = sorted({int(win[i, 4]) for i in ns})
    qtab_bytes = len(qsel) * tables[3].shape[1] * 4
    table_bytes = sum(int(qoff[i + 1] - qoff[i]) * 12 for i in qsel)
    pb_bytes = code_bytes + ws.numel() * 8 + table_bytes + qtab_bytes + anchors * 12 + 8 * n_sample
    counts = probe[3].tolist()
    pb_ops = 4 * positions + sum(c * max(1, int(np.log2(max(c, 1)))) for c in counts)
    pb = (pb_bytes / HBM_BYTES_PER_S * 1e3, pb_ops / FP32_OPS_PER_S * 1e3)
    scan = chain_scan_pairs(lambda: [native_rows(cprs[wins[i][0]], windows[i][1], 0,
                                                 qcodes[wins[i][0]].shape[0] - 1, copt)
                                     for i in ns])
    ch_bytes = anchors * 12 + rows_out * 64 + 12 * n_sample
    ch_ops = 10 * scan + 4 * anchors
    ch = (ch_bytes / HBM_BYTES_PER_S * 1e3, ch_ops / FP32_OPS_PER_S * 1e3)
    log(f"[phase4] {n_sample} windows ({positions} positions, {anchors} anchors, {scan} DP "
        f"predecessor visits): pseudo_probe {probe_ms:.4f} ms (plain {probe_plain_ms:.1f} ms, "
        f"bound {max(pb):.5f} ms by {'bytes' if pb[0] >= pb[1] else 'operations'}), "
        f"pseudo_chain {chain_ms:.4f} ms (plain {chain_plain_ms:.1f} ms, bound {max(ch):.5f} "
        f"ms by {'bytes' if ch[0] >= ch[1] else 'operations'}) [{card}]")
    log(f"[phase4] all {len(wins)} windows in one launch: pseudo_probe {full_probe_ms:.4f} ms, "
        f"pseudo_chain {full_chain_ms:.4f} ms; the {len(queries)} queries' tables built on the "
        f"card in {tables_ms:.4f} ms [{card}]")
    steps = chain_chunk_steps(*full[:4], copt.band_base, copt.band_count, int(copt.max_gap))
    serial = {"max": int(steps.max()), "mean": float(steps.float().mean()),
              "anchors_of_longest": int(full[3][int(steps.argmax())])}
    log(f"[phase4] pseudo_chain's serial warp steps per window (32-predecessor chunks), all "
        f"{len(wins)} windows: {json.dumps(serial)}")

    # run_batch on every window vs the native oracle
    aligner = DevicePseudoAligner(copt.band_base, copt.band_count, int(copt.max_gap),
                                  copt.min_score, copt.min_align_len, device=dev)
    aligner.blob = blob
    rec = bound_recorder()
    t0 = time.perf_counter()
    res = aligner.run_batch(queries, windows, geoms)
    run_s = time.perf_counter() - t0
    n_rows = 0
    for (qi, codes, b, e), (kind, rows) in zip(windows, res):
        if kind == "host":
            continue
        want = native_rows(cprs[qi], codes, b, e, copt)
        got = rows if kind == "rows" else None
        if (want is None) != (got is None) or (got is not None and not np.array_equal(got, want)):
            raise AssertionError("run_batch rows differ from the native oracle")
        n_rows += 0 if got is None else got.shape[0]
    kinds = [r[0] for r in res]
    host_share = kinds.count("host") / len(kinds)
    log(f"[phase4] run_batch over {len(kinds)} windows in {run_s * 1e3:.1f} ms: rows == native "
        f"oracle on every unflagged window ({kinds.count('rows')} rows windows, "
        f"{kinds.count('none')} none, {kinds.count('host')} host: host share "
        f"{host_share:.4f}); counters {json.dumps(counters(rec.totals, "pseudo"))} [{card}]")
    if host_share > 0.1:
        raise AssertionError("more than 10% of the phase-4 windows went to the host")

    # the path of a store too large for the card: the same windows packed
    # and uploaded per launch (no blob) must give the same results
    up = DevicePseudoAligner(copt.band_base, copt.band_count, int(copt.max_gap),
                             copt.min_score, copt.min_align_len, device=dev)
    t0 = time.perf_counter()
    res_up = up.run_batch(queries, windows)
    up_s = time.perf_counter() - t0
    if [r[0] for r in res_up] != kinds or not all(
            a[1] is None or np.array_equal(a[1], b[1]) for a, b in zip(res, res_up)):
        raise AssertionError("run_batch with uploaded windows differs from the resident blob's")
    log(f"[phase4] run_batch with the windows uploaded instead (no resident blob): the same "
        f"results in {up_s * 1e3:.1f} ms [{card}]")
    res_probe = {"windows": n_sample, "ms": probe_ms, "plain_ms": probe_plain_ms,
                 "bound_ms": max(pb), "bound_by": "bytes" if pb[0] >= pb[1] else "operations",
                 "full_windows": len(wins), "full_ms": full_probe_ms, "anchors": anchors,
                 "positions": positions, "max_abs_err": probe_err}
    res_chain = {"windows": n_sample, "ms": chain_ms, "plain_ms": chain_plain_ms,
                 "bound_ms": max(ch), "bound_by": "bytes" if ch[0] >= ch[1] else "operations",
                 "full_windows": len(wins), "full_ms": full_chain_ms, "dp_visits": scan,
                 "rows": rows_out, "max_abs_err": max(chain_err, stress_err),
                 "serial_steps": serial}
    info = {"host_share": host_share, "blob_bytes": blob.hbm_bytes, "run_batch_s": run_s,
            "run_batch_upload_s": up_s, "tables_ms": tables_ms}
    del blob, full, probe, chain
    return res_probe, res_chain, info


# --------------------------------------------------------------------------
# phase 7: the chain1 forward DP (B9) and the WFA (B8) vs their plain
# versions and the native oracles

CHAIN1_OPS_PER_VISIT = 20  # int and float operations of one predecessor visit
WFA_OPS_PER_CELL = 20  # reads, maxima, validity and reduction share of a cell
WFA_OPS_PER_COMPARE = 10  # one 32-base compare of the extension
# wfa.cu's kernels (the sizing pass and its offsets, the write pass, the
# traceback), and an earlier tree's two (no sizing pass)
WFA_KERNELS = ("wfa_size", "wfa_offsets", "wfa_forward", "wfa_traceback")
PARENT_WFA_KERNELS = ("wfa_forward", "wfa_traceback")


def chain1_case(seed, n_sets=4096, n_dense=16, n_big=4, big=20_000):
    """Anchor sets (qb, tb, ln int32, sorted by qb) drawn like
    tests/test_device_search.py:214-225: n_sets with n from 2 to 700 along
    a jittered diagonal of 2,500 bp, plus 16 dense sets of 1,500 anchors in
    900 bp and 4 sets of 20,000 anchors (past the JAX package's largest
    bucket of 8,192)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def one(n, span, jitter):
        qb = np.sort(rng.integers(0, span, n)).astype(np.int32)
        tb = (qb + rng.integers(-jitter, jitter, n)).astype(np.int32)
        return qb, tb, rng.integers(15, 32, n).astype(np.int32)

    sets = [one(int(n), 2500, 40) for n in rng.integers(2, 701, n_sets)]
    sets += [one(1500, 900, 30) for _ in range(n_dense)]
    sets += [one(big, 10 * big, 60) for _ in range(n_big)]
    return sets


def chain1_visits(sets, max_dist):
    """The predecessors the native scan reads (down to and including the
    first one past max_dist) over sorted anchor sets."""
    import numpy as np

    total = 0
    for qb, _, _ in sets:
        lo = np.searchsorted(qb, qb.astype(np.int64) - max_dist, side="left")
        i = np.arange(qb.shape[0])
        total += int((i - lo).sum() + (lo > 0).sum())
    return total


def wfa_case(seed, n_main=4096, n8=64, n25=8):
    """Gene-query HSP windows: 4,096 pairs of 1.5 kb at 2-8% substitutions
    and 0.5-1% indels; 64 pairs of 8 kb and 8 of 25 kb at the same rates;
    identical pairs, pure-indel pairs and one pair of unrelated sequences
    that must overflow (the host's)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def mutate(n):
        q = rng.integers(0, 4, n).astype(np.uint8)
        sub, ind = rng.uniform(0.02, 0.08), rng.uniform(0.005, 0.01)
        r = rng.random(n)
        t0 = np.where((r >= ind) & (r < ind + sub), (q + rng.integers(1, 4, n)) % 4, q)
        pieces, at = [], 0
        for i in np.nonzero(r < ind)[0]:
            if i < at:
                continue
            pieces.append(t0[at:i])
            k = int(rng.integers(1, 9))
            if rng.random() < 0.5:  # k bases inserted before base i
                pieces.append(rng.integers(0, 4, k))
                at = i
            else:  # k bases deleted from base i
                at = i + k
        pieces.append(t0[at:])
        return q, np.concatenate(pieces).astype(np.uint8)

    main = [mutate(1500) for _ in range(n_main)]
    long8 = [mutate(8000) for _ in range(n8)]
    long25 = [mutate(25_000) for _ in range(n25)]
    q = rng.integers(0, 4, 1500).astype(np.uint8)
    edges = [(q, q.copy()), (q[:700], q[:700].copy()), (q, np.concatenate([q[:600], q[640:]])),
             (q, np.concatenate([q[:900], rng.integers(0, 4, 30).astype(np.uint8), q[900:]])),
             (q, q[25:].copy()), (q, rng.integers(0, 4, 1500).astype(np.uint8))]
    return main, long8, long25, edges


def phase_chain_wfa(dev, card, seed, reps, chain_sizes=(), wfa_sizes=(), parents=None):
    """B9 and B8 on the card against their plain versions (there) and the
    native DP / WFA, exact; times as called, on the device (profiler; B8
    by kernel), plain, and their bounds from this run's data; B9 under
    other block thresholds; with `parents` (an earlier tree's chain1 and
    wfa libraries), those kernels in turns with this tree's.  chain_sizes
    and wfa_sizes cut the cases (chain1_case's and wfa_case's size
    arguments) for a rehearsal on the CPU."""
    import numpy as np
    import torch

    from lexicmap_tpu_torch.kernels import chain1 as C1
    from lexicmap_tpu_torch.kernels import wfa as WK
    from lexicmap_tpu_torch.native import chain1_forward_native
    from lexicmap_tpu_torch.ops.wfa import wfa_align
    from lexicmap_tpu_torch.parallel.chain_device import DeviceChainer, gap_score_table
    from lexicmap_tpu_torch.parallel.wfa_device import BUCKETS, DeviceWFA

    saved = (C1.chain1_forward.launches, WK.wfa_batch.launches)
    mg, msc, md = 50.0, 40.0, 1000  # tests/test_device_search.py's chainer
    t0 = time.perf_counter()
    sets = chain1_case(seed, *chain_sizes)
    cols, off = C1.pack_sets(sets)
    cols = torch.from_numpy(cols).to(dev)
    off_d = torch.from_numpy(off).to(dev)
    gtab = torch.from_numpy(gap_score_table(mg)).to(dev)
    args = (*cols, off_d, gtab, mg, msc, md)
    got = C1.chain1_forward(*args)
    sync(dev)
    t1 = time.perf_counter()
    want = C1.chain1_forward_plain(*args)
    sync(dev)
    plain_ms = (time.perf_counter() - t1) * 1e3
    err = float((got[0] - want[0]).abs().max())
    if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            and all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))):
        raise AssertionError(f"chain1 kernel != plain (max abs err {err})")
    ms, prev, dirs, flags = (t.cpu().numpy() for t in got)
    for g, st in enumerate(sets):
        a, b = off[g], off[g + 1]
        w = chain1_forward_native(*st, mg, msc, md)
        if flags[g] or not (np.array_equal(ms[a:b].view(np.uint32),
                                           w[0].astype(np.float32).view(np.uint32))
                            and np.array_equal(prev[a:b], w[1]) and np.array_equal(dirs[a:b], w[2])):
            raise AssertionError(f"chain1 kernel != native DP on set {g} (n={b - a})")
    n_anchors = int(off[-1])
    visits = chain1_visits(sets, md)
    c_ms = time_ms(lambda: C1.chain1_forward(*args), dev, reps)
    c_dev, c_by = device_ms(lambda: C1.chain1_forward(*args), "chain1_kernel", reps)
    # the block path's threshold: the same sets with other n_block
    by_block_min = {}
    for bm in (256, 1024, 4096, 1 << 30):
        order, n_block = C1.schedule(off, bm)
        plan = (torch.from_numpy(order).to(dev), n_block)
        if dev.type == "cuda":
            if not same_stage_outputs(C1.chain1_forward(*args, plan=plan), got):
                raise AssertionError(f"chain1 with BLOCK_MIN {bm} differs")
            by_block_min[str(bm)] = {"block_genomes": n_block, "device_ms": device_ms(
                lambda: C1.chain1_forward(*args, plan=plan), "chain1_kernel", reps)[0]}
    c_bytes = n_anchors * (12 + 9) + gtab.numel() * 4 + off.nbytes + 8 * len(sets)
    cb = (c_bytes / HBM_BYTES_PER_S * 1e3, visits * CHAIN1_OPS_PER_VISIT / FP32_OPS_PER_S * 1e3)
    dc = DeviceChainer(mg, msc, md, device=dev)
    rec = bound_recorder()
    launches = C1.chain1_forward.launches
    t1 = time.perf_counter()
    res = dc.chain_batch(sets)
    batch_s = time.perf_counter() - t1
    dc_launches = C1.chain1_forward.launches - launches
    dc_counts = counters(rec.totals, "chain")
    if any(k != "ok" for k, _ in res):
        raise AssertionError(f"DeviceChainer sent genomes to the host: {dc_counts}")
    chain_res = {"sets": len(sets), "anchors": n_anchors, "visits": visits, "ms": c_ms,
                 "device_ms": c_dev, "device_ms_by": c_by, "plain_ms": plain_ms,
                 "bound_ms": max(cb), "bound_by": "bytes" if cb[0] >= cb[1] else "operations",
                 "max_abs_err": err, "chain_batch_s": batch_s, "launches_per_batch": dc_launches,
                 "device_share": 1 - dc_counts["chain.flagged_genomes"]
                 / dc_counts["chain.genomes"],
                 "steps_longest": int((off[1:] - off[:-1]).max()) - 1,
                 "block_min": C1.BLOCK_MIN, "by_block_min": by_block_min}
    if c_dev is not None:
        chain_res["us_per_step"] = c_dev * 1e3 / chain_res["steps_longest"]
    if parents and "chain1" in parents:
        names = ("chain1_kernel",)
        chain_res["parent"] = split_in_turns(
            dev, lambda: parent_chain1(parents["chain1"], *args),
            lambda: C1.chain1_forward(*args), names, names, reps, same=same_stage_outputs)
        log(f"[phase7] chain1, the earlier kernel and this one in turns: "
            f"{json.dumps(chain_res['parent'])} [{card}]")
    log(f"[phase7] chain1 == plain == native DP (float32 bits, indices) on {len(sets)} sets, "
        f"{n_anchors} anchors ({visits} predecessor visits; sets of 2-700 anchors, dense ones of "
        f"1,500, the largest {int((off[1:] - off[:-1]).max())}): kernel {c_ms:.4f} ms as called, device {c_dev} ms, plain "
        f"{plain_ms:.1f} ms, bound {max(cb):.5f} ms by {chain_res['bound_by']}; "
        f"DeviceChainer.chain_batch {batch_s * 1e3:.1f} ms in {dc_launches} launch, {dc_counts} "
        f"(made and checked in {t1 - t0:.1f} s); device ms by BLOCK_MIN "
        f"{json.dumps(by_block_min)} [{card}]")
    del got, want, cols

    # B8
    t0 = time.perf_counter()
    main, long8, long25, edges = wfa_case(seed + 1, *wfa_sizes)
    made_s = time.perf_counter() - t0  # the pairs' generation alone
    L, S, W = BUCKETS[1]
    wargs = [torch.from_numpy(a).to(dev) for a in WK.pack_pairs(main)]
    got = WK.wfa_batch(*wargs, S, W, S + 8)
    sync(dev)
    work = {}
    t1 = time.perf_counter()
    want = WK.wfa_plain(*wargs, S, W, S + 8, work=work)
    sync(dev)
    w_plain_ms = (time.perf_counter() - t1) * 1e3
    got_ops = WK.decode_ops(*(t.cpu().numpy() for t in got))
    if got_ops != WK.decode_ops(*(t.cpu().numpy() for t in want)):
        raise AssertionError("wfa kernel != plain on the 1.5 kb pairs")
    answered = sum(o is not None for o in got_ops)
    for (q, t), o in zip(main, got_ops):
        if o is not None and o != wfa_align(q, t).ops:
            raise AssertionError("wfa kernel != wfa_align on a 1.5 kb pair")
    for name, pairs, plain in (("8 kb", long8, True), ("25 kb", long25, False),
                               ("edge", edges, True)):
        if not pairs:
            continue
        b = next(bk for bk in BUCKETS if max(max(p[0].shape[0], p[1].shape[0]) for p in pairs)
                 <= bk[0])
        a = [torch.from_numpy(x).to(dev) for x in WK.pack_pairs(pairs)]
        k = WK.decode_ops(*(x.cpu().numpy() for x in WK.wfa_batch(*a, b[1], b[2], b[1] + 8)))
        if plain and k != WK.decode_ops(*(x.cpu().numpy()
                                          for x in WK.wfa_plain(*a, b[1], b[2], b[1] + 8))):
            raise AssertionError(f"wfa kernel != plain on the {name} pairs")
        for (q, t), o in zip(pairs, k):
            if o is not None and o != wfa_align(q, t).ops:
                raise AssertionError(f"wfa kernel != wfa_align on a {name} pair")
        if name == "edge" and (k[-1] is not None or any(o is None for o in k[:-1])):
            raise AssertionError("the edge pairs: only the unrelated pair may overflow")
        log(f"[phase7] wfa == {'plain == ' if plain else ''}wfa_align on the {name} pairs: "
            f"{sum(o is not None for o in k)} of {len(pairs)} answered on the card "
            f"(bucket L={b[0]}, S={b[1]}, W={b[2]})")
    w_ms = time_ms(lambda: WK.wfa_batch(*wargs, S, W, S + 8), dev, reps)
    w_by = device_ms_split(lambda: WK.wfa_batch(*wargs, S, W, S + 8), WFA_KERNELS, reps)
    arena = {}
    WK.wfa_batch(*wargs, S, W, S + 8, scratch=arena)
    w_dev = None if None in w_by.values() else sum(w_by.values())
    nops = got[2].cpu().numpy()
    compares = work["extended"] + work["ext_bases"] // 32
    # the function's own bytes: packed sequences and each pair's offsets and
    # lengths in, its op runs (5 bytes) and run count out
    w_bytes = wargs[0].numel() * 8 + 24 * len(main) + int(nops.clip(0).sum()) * 5 + 4 * len(main)
    wb = (w_bytes / HBM_BYTES_PER_S * 1e3,
          (work["cells"] * WFA_OPS_PER_CELL + compares * WFA_OPS_PER_COMPARE)
          / FP32_OPS_PER_S * 1e3)
    # what this design moves besides: each live score's int16 history over
    # its span (the native row widths, 6 bytes a cell) and its 8-byte row
    # entry, written once, and the cells and row entries the traceback's
    # path reads back; a design with W-wide rows writes W cells and a
    # 4-byte start a row
    tb_bytes = work["tb_cells"] * 2 + work["tb_rows"] * 8
    hist_bytes = w_bytes + work["cells"] * 6 + work["rows"] * 8 + tb_bytes
    hist_bytes_wide = (w_bytes + work["rows"] * (W * 6 + 4) + work["tb_cells"] * 2
                      + work["tb_rows"] * 4)
    dw = DeviceWFA(device=dev)
    rec = bound_recorder()
    launches = WK.wfa_batch.launches
    t1 = time.perf_counter()
    res = dw.align_batch(main)
    batch_s = time.perf_counter() - t1
    dw_launches = WK.wfa_batch.launches - launches
    dw_counts = counters(rec.totals, "wfa")
    if res != [wfa_align(q, t).ops for q, t in main]:
        raise AssertionError("DeviceWFA.align_batch != wfa_align on the 1.5 kb pairs")
    wfa_res = {"pairs": len(main), "bucket": [L, S, W], "answered": answered,
               "cells": work["cells"], "ext_bases": work["ext_bases"], "ms": w_ms,
               "device_ms": w_dev, "device_ms_by": w_by, "plain_ms": w_plain_ms,
               "bound_ms": max(wb), "bound_by": "bytes" if wb[0] >= wb[1] else "operations",
               "bytes": w_bytes, "history_bytes": hist_bytes,
               "history_bound_ms": hist_bytes / HBM_BYTES_PER_S * 1e3,
               "history_bytes_wide_rows": hist_bytes_wide,
               "scratch_bytes": arena["hist_bytes"],
               "scratch_bytes_full_window": WK.history_bytes(len(main), S, W),
               "max_abs_err": 0, "align_batch_s": batch_s, "launches_per_batch": dw_launches,
               "device_share": dw_counts["wfa.card_pairs"] / len(main)}
    log(f"[phase7] wfa == plain == wfa_align on {len(main)} pairs of 1.5 kb ({answered} answered "
        f"on the card, {work['cells']} wavefront cells, {work['ext_bases']} bases extended): "
        f"kernel {w_ms:.4f} ms as called (one launch of all), device {w_dev} ms, plain "
        f"{w_plain_ms:.1f} ms, bound {max(wb):.5f} ms by {wfa_res['bound_by']} (with this "
        f"design's history traffic {wfa_res['history_bound_ms']:.5f} ms); history scratch "
        f"{wfa_res['scratch_bytes']} B (room at the full window: "
        f"{wfa_res['scratch_bytes_full_window']} B); "
        f"DeviceWFA.align_batch {batch_s * 1e3:.1f} ms in {dw_launches} launches, "
        f"{dw_counts} (made in {made_s:.1f} s); device ms by kernel {json.dumps(w_by)} [{card}]")
    if parents and "wfa" in parents:
        wfa_res["parent"] = split_in_turns(
            dev, lambda: parent_wfa(parents["wfa"], *wargs, S, W, S + 8),
            lambda: WK.wfa_batch(*wargs, S, W, S + 8), PARENT_WFA_KERNELS, WFA_KERNELS, reps,
            same=same_stage_outputs)
        log(f"[phase7] wfa, the earlier kernels and these in turns: "
            f"{json.dumps(wfa_res['parent'])} [{card}]")
    # comparison launches do not count
    C1.chain1_forward.launches, WK.wfa_batch.launches = saved
    return chain_res, wfa_res


# --------------------------------------------------------------------------
# phase 6: end to end


# --------------------------------------------------------------------------
# phase 8: the LexicHash capture (B10) vs its plain version and native

CAPTURE_OPS_PER_STRAND = 9  # rolling k-mer update, bucket lookup, xor, min, winner test
CAPTURE_KERNELS = ("capture_init", "capture_min", "capture_keys", "capture_count",
                   "capture_scatter", "capture_finish")
# the thread-per-position capture.cu's: memsets for its init, no keys
PARENT_CAPTURE_KERNELS = ("capture_min", "capture_count", "capture_scatter", "capture_finish")


def capture_genomes(seed, sizes, masks, k, interval=1000, copies=(50, 12_000)):
    """The phase's genomes, as (what, codes, exclude): random genomes of
    `sizes` bases; the second has a 5 kb block copied copies[0] times and a
    mask's k-mer as a tandem repeat copies[1] times (that mask wins at
    every copy: past the kernel's SORT_CAP, so its slice is merged), the
    third is contigs of L/120-L/12 bases (100 kb-1 Mb at 12 Mb) joined by
    `interval` A's whose k-mers are excluded, as the index build excludes
    them; then one genome shorter than k."""
    import numpy as np

    from lexicmap_tpu_torch.ops.masking import skip_mask_from_regions

    rng = np.random.default_rng(seed)
    out = []
    for i, L in enumerate(sizes):
        codes = rng.integers(0, 4, size=L, dtype=np.uint8)
        exclude, what = None, "random"
        if i == 1:
            block = codes[:5_000].copy()
            for c in range(copies[0]):
                codes[10_000 + c * 7_000: 15_000 + c * 7_000] = block
            unit = np.array([(int(masks[123]) >> (2 * (k - 1 - t))) & 3 for t in range(k)],
                            dtype=np.uint8)
            at = 10_000 + copies[0] * 7_000
            codes[at: at + copies[1] * k] = np.tile(unit, copies[1])
            what = f"a 5 kb block x {copies[0]}, mask 123's k-mer x {copies[1]} in tandem"
        elif i == 2:
            regions, n = [], int(rng.integers(L // 120, L // 12))
            while n + interval < L:
                regions.append((n, n + interval - 1))
                codes[n: n + interval] = 0
                n += interval + int(rng.integers(L // 120, L // 12))
            exclude = skip_mask_from_regions(L, k, regions)
            what = f"{len(regions) + 1} contigs, {len(regions)} excluded intervals"
        out.append((what, codes, exclude))
    out.append(("shorter than k", out[0][1][: k - 1].copy(), None))
    return out


def phase_capture(dev, card, seed, reps,
                  sizes=(4 << 20, 6_000_000, 12_000_000, 20_000_000, 550_000), m=20_000,
                  copies=(50, 12_000), parent=None):
    """B10 at the index default (20,000 masks, p = 8) on genomes up to
    MAX_GENOME_SIZE and one of the end-to-end build's size: the kernel ==
    its plain version (on the card) == native capture_native, exactly;
    times as called, on the device (its kernels' profiler rows), plain,
    native, through DeviceCaptureEngine as the build calls it (upload and
    fetch included), and the bound from each genome's bytes and operations;
    with `parent` (an earlier tree's capture.cu), its kernels in turns with
    this tree's on every genome.  sizes, m and copies cut it for a
    rehearsal on the CPU."""
    import numpy as np
    import torch

    from lexicmap_tpu_torch.kernels import capture as CK
    from lexicmap_tpu_torch.masks import MaskSet
    from lexicmap_tpu_torch.native import capture_native_call
    from lexicmap_tpu_torch.parallel.build_device import DeviceCaptureEngine
    from lexicmap_tpu_torch.utils.kmers import kmers_fwd_rc

    saved = CK.capture.launches
    t0 = time.perf_counter()
    ms = MaskSet.generate(31, m, 1)
    eng = DeviceCaptureEngine(ms, device=dev)
    k, p = eng.k, eng.p
    cases = capture_genomes(seed, sizes, ms.masks, k, copies=copies)
    log(f"[capture] {m} masks (p = {p}, table of {eng.table.numel()} entries), "
        f"{len(cases)} genomes made in {time.perf_counter() - t0:.1f} s")
    rows = []
    for what, codes, exclude in cases:
        L = codes.shape[0]
        if L < k:
            if eng.capture(codes, exclude) is not None:
                raise AssertionError("a genome shorter than k must give None")
            continue
        c = torch.from_numpy(codes).to(dev)
        e = None if exclude is None else torch.from_numpy(exclude).to(dev)
        args = (c, e, eng.table, eng.masks, k, p)
        got = CK.capture(*args)
        sync(dev)
        t1 = time.perf_counter()
        want = CK.capture_plain(*args)
        sync(dev)
        plain_ms = (time.perf_counter() - t1) * 1e3
        err = int_err(got, want)
        if err or not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"capture kernel != plain on the {L}-base genome ({what}, "
                                 f"max abs err {err})")
        t1 = time.perf_counter()
        fwd, rc = kmers_fwd_rc(codes, k)
        nat = capture_native_call(fwd, rc, exclude, ms.masks, k, p, False)
        native_ms = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        eng_out = eng.capture(codes, exclude)
        engine_ms = (time.perf_counter() - t1) * 1e3
        for a, b, name in zip(eng_out, nat, ("kmers", "counts", "pos_flat")):
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"capture != native {name} on the {L}-base genome ({what})")
        err = max(err, int_err(eng_out, nat))
        counts = eng_out[1]
        total = int(counts.sum())
        nk = L - k + 1
        valid = nk - (int(exclude.sum()) if exclude is not None else 0)
        n_bytes = (L + (nk if exclude is not None else 0) + eng.table.numel() * 4 + 8 * m
                   + 16 * m + 4 * total)
        b = (n_bytes / HBM_BYTES_PER_S * 1e3,
             2 * valid * CAPTURE_OPS_PER_STRAND / FP32_OPS_PER_S * 1e3)
        by = device_ms_split(lambda: CK.capture(*args), CAPTURE_KERNELS, reps)
        r = {"bases": L, "what": what, "masks": m, "p": p, "winners": total,
             "max_count": int(counts.max()),
             "captured_masks": int((counts > 0).sum()),
             "ms": time_ms(lambda: CK.capture(*args), dev, reps),
             "device_ms": None if None in by.values() else sum(by.values()), "device_ms_by": by,
             "plain_ms": plain_ms, "native_ms": native_ms, "engine_ms": engine_ms,
             "bound_ms": max(b), "bound_by": "bytes" if b[0] >= b[1] else "operations",
             "bytes": n_bytes, "operations": 2 * valid * CAPTURE_OPS_PER_STRAND,
             "max_abs_err": err}
        if parent is not None:
            r["parent"] = split_in_turns(dev, lambda: parent_capture(parent, *args),
                                         lambda: CK.capture(*args), PARENT_CAPTURE_KERNELS,
                                         CAPTURE_KERNELS, reps)
        rows.append(r)
        log(f"[capture] {json.dumps(r)}: kernel == plain == native [{card}]")
        del got, want, c, e
    CK.capture.launches = saved  # comparisons do not count
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rows


def write_genomes(root, n_genomes, n_queries, seed, n_many=32, many_in=16):
    """The 200-genome set of scripts/scale_smoke_gen.py (400-700 kb random
    genomes), with `n_queries` 1.5 kb queries carrying 3% point mutations,
    and a many-hit set: `n_many` random 1.5 kb queries, each planted with 3%
    point mutations in `many_in` of the genomes before they are written."""
    import numpy as np

    os.makedirs(os.path.join(root, "genomes"))
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    every = max(1, n_genomes // n_queries)
    lens = rng.integers(400_000, 700_000, n_genomes)
    many = [acgt[rng.integers(0, 4, 1500)] for _ in range(n_many)]
    sites: dict[int, list] = {}
    for qi in range(n_many):
        for gi in rng.choice(n_genomes, many_in, replace=False):
            sites.setdefault(int(gi), []).append(qi)
    qrecs = []
    for gi in range(n_genomes):
        L = int(lens[gi])
        seq = acgt[rng.integers(0, 4, L)]
        for j, qi in enumerate(sites.get(gi, [])):  # one 4 kb slot per planted copy
            frag = many[qi].copy()
            frag[rng.integers(0, 1500, 45)] = acgt[rng.integers(0, 4, 45)]
            at = 10_000 + j * 4_000 + int(rng.integers(0, 500))
            seq[at: at + 1500] = frag
        seq = seq.tobytes()
        with open(os.path.join(root, "genomes", f"g{gi:03d}.fasta"), "wb") as fh:
            fh.write(b">chr1\n")
            for i in range(0, L, 70):
                fh.write(seq[i : i + 70] + b"\n")
        if gi % every == 0 and len(qrecs) < n_queries:
            s = int(rng.integers(0, L - 1500))
            frag = bytearray(seq[s : s + 1500])
            for pos in rng.integers(0, 1500, 45):
                frag[pos] = acgt[rng.integers(0, 4)]
            qrecs.append((f"q_from_g{gi:03d}", bytes(frag)))
    qpath = os.path.join(root, "queries.fasta")
    with open(qpath, "wb") as fh:
        for qid, s in qrecs:
            fh.write(f">{qid}\n".encode() + s + b"\n")
    return qrecs, qpath, [(f"many{qi:02d}", many[qi].tobytes()) for qi in range(n_many)]


def kernel_fns():
    from lexicmap_tpu_torch.kernels import (
        capture, chain1, pseudo_align, reverse_dispatch, seed_compact, seed_locate, seed_match,
        seed_match_shard, shard_compact, wfa)

    return (seed_locate.seed_locate_batch, seed_locate.seed_locate, seed_match.seed_match,
            pseudo_align.pseudo_probe, pseudo_align.pseudo_chain, chain1.chain1_forward,
            wfa.wfa_batch, capture.capture, seed_match_shard.seed_match_shard,
            shard_compact.shard_compact, seed_compact.seed_compact,
            reverse_dispatch.reverse_dispatch)


def reset_launches():
    for fn in kernel_fns():
        fn.launches = 0


def launch_counts():
    return {fn.__name__: fn.launches for fn in kernel_fns()}


def tree_bytes(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def device_build(dev, card, tmp, host_db, n_genomes, host_build_s, n_check=2):
    """The same index again with `index --engine device`, after the host
    build: the trees byte-identical file by file, B10 launched once per
    genome and its first `n_check` launches equal to its plain version on
    the same device tensors; genomes per minute of both, and the device
    build's seconds in seeding (seed_genome) and in the capture
    (DeviceCaptureEngine.capture: upload, kernels, fetch)."""
    import torch

    from lexicmap_tpu_torch import cli
    from lexicmap_tpu_torch.index import build as B
    from lexicmap_tpu_torch.kernels import capture as CK
    from lexicmap_tpu_torch.parallel import build_device as BD
    from lexicmap_tpu_torch.parallel.build_device import DeviceCaptureEngine

    db = os.path.join(tmp, "idx_device.lmt")
    spent = {"seed_genome": 0.0, "capture": 0.0}
    real_seed, real_capture = B.seed_genome, DeviceCaptureEngine.capture
    real_kernel, recorded = BD.capture, []

    def recording_kernel(*a):
        out = real_kernel(*a)
        if len(recorded) < n_check:  # the main path's inputs and outputs, kept
            recorded.append((a, tuple(x.clone() for x in out)))
        return out

    def timed(name, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] += time.perf_counter() - t0
        return call

    B.seed_genome = timed("seed_genome", real_seed)
    DeviceCaptureEngine.capture = timed("capture", real_capture)
    BD.capture = recording_kernel
    CK.capture.launches = 0  # the device build's run starts here
    try:
        t0 = time.perf_counter()
        rc = cli.main(["index", "--quiet", "-I", os.path.join(tmp, "genomes"), "-O", db, "-b",
                       "25", "--engine", "device", "--device", str(dev)])
        dev_build_s = time.perf_counter() - t0
    finally:
        B.seed_genome, DeviceCaptureEngine.capture = real_seed, real_capture
        BD.capture = real_kernel
    launches = CK.capture.launches  # ... and ends here
    if rc != 0:
        raise AssertionError(f"index --engine device failed with {rc}")
    if len(recorded) != n_check:
        raise AssertionError(f"recorded {len(recorded)} capture launches, expected {n_check}")
    main_err, main_shapes = 0, []
    for a, got in recorded:  # the kernel vs its plain version on the main path's inputs
        want = CK.capture_plain(*a)
        err = int_err(got, want)
        if err or not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"main path: capture kernel != plain on a {a[0].shape[0]}-base "
                                 f"genome (max abs err {err})")
        main_err = max(main_err, err)
        main_shapes.append({"bases": int(a[0].shape[0]), "masks": int(a[3].shape[0]),
                            "p": a[5], "winners": int(got[2].shape[0])})
    del recorded
    log(f"[e2e] main path, first {n_check} capture launches: kernel == plain on "
        f"{json.dumps(main_shapes)}")
    host_tree, dev_tree = tree_bytes(host_db), tree_bytes(db)
    if sorted(host_tree) != sorted(dev_tree):
        raise AssertionError("the device-built index has other files than the host-built one")
    bad = [name for name in host_tree if host_tree[name] != dev_tree[name]]
    if bad:
        raise AssertionError(f"device-built index differs from the host-built one in {bad[:5]}")
    if dev.type == "cuda" and launches != n_genomes:
        raise AssertionError(f"the device build launched capture {launches} times, expected "
                             f"{n_genomes} (one per genome)")
    res = {"db": db, "capture_launches": launches, "files": len(host_tree),
           "host_s": host_build_s, "device_s": dev_build_s,
           "host_genomes_per_min": n_genomes / host_build_s * 60,
           "device_genomes_per_min": n_genomes / dev_build_s * 60,
           "device_seed_genome_s": spent["seed_genome"], "device_capture_s": spent["capture"],
           "capture_share": spent["capture"] / dev_build_s,
           "main_path_err": main_err, "main_path_shape": main_shapes}
    log(f"[e2e] index --engine device: the same {len(host_tree)} files byte for byte; "
        f"{json.dumps({k: v for k, v in res.items() if k != 'db'})} [{card}]")
    return res


def genome_search(dev, card, tmp, db, genome_files, seed, n_check=4):
    """`genome search --engine device` and `--engine host` through the CLI
    for two query genomes, 1% mutated copies of two indexed genomes: the
    same rows, each query's source genome ranked first, and the screening's
    first `n_check` seed_locate_batch launches equal to the kernel's plain
    version on the same device tensors."""
    import numpy as np
    import torch

    from lexicmap_tpu_torch import cli
    from lexicmap_tpu_torch.kernels import seed_locate as SL
    from lexicmap_tpu_torch.parallel import device_search as DS

    real_kernel, recorded = DS.seed_locate_batch, []

    def recording_kernel(*a, **kw):
        out = real_kernel(*a, **kw)
        if len(recorded) < n_check:  # the main path's inputs and outputs, kept
            recorded.append((a, tuple(x.clone() for x in out)))
        return out

    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    queries = []
    for path in genome_files:
        with open(path, "rb") as fh:
            seq = np.frombuffer(b"".join(fh.read().split(b"\n")[1:]), dtype=np.uint8).copy()
        at = rng.choice(seq.shape[0], seq.shape[0] // 100, replace=False)
        seq[at] = acgt[(np.searchsorted(acgt, seq[at]) + rng.integers(1, 4, at.shape[0])) % 4]
        q = os.path.join(tmp, "q_" + os.path.basename(path))
        with open(q, "wb") as fh:
            fh.write(b">c0\n" + seq.tobytes() + b"\n")
        queries.append(q)
    out, secs = {}, {}
    for engine in ("device", "host"):
        o = os.path.join(tmp, f"genome_{engine}.tsv")
        SL.seed_locate_batch.launches = 0
        DS.seed_locate_batch = recording_kernel
        t0 = time.perf_counter()
        try:
            rc = cli.main(["--quiet", "genome", "search", "-d", db, *queries, "-o", o,
                           "--engine", engine, "--device", str(dev)])
        finally:
            DS.seed_locate_batch = real_kernel
        secs[engine] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"genome search --engine {engine} failed with {rc}")
        if engine == "device":
            launched = SL.seed_locate_batch.launches
        with open(o) as fh:
            out[engine] = fh.read().splitlines()
    if out["device"] != out["host"]:
        raise AssertionError("genome search --engine device rows differ from --engine host's")
    for q, path in zip(queries, genome_files):
        want = os.path.splitext(os.path.basename(path))[0]
        rows = [r.split("\t") for r in out["device"][1:]
                if r.startswith(os.path.splitext(os.path.basename(q))[0] + "\t")]
        if not rows or rows[0][1] != want:
            raise AssertionError(f"{os.path.basename(q)} does not rank {want} first: {rows[:2]}")
    if dev.type == "cuda" and not launched:
        raise AssertionError("genome search --engine device launched no seed_locate_batch")
    if not recorded:
        raise AssertionError("genome search --engine device screened no window on the matcher")
    main_err, main_shapes = 0, []
    for a, got in recorded:  # the kernel vs its plain version on the main path's inputs
        want = SL.seed_locate_batch_plain(*a)
        err = int_err(got, want)
        if err or not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"genome search: seed_locate_batch != plain on Mb={a[0].shape[0]}"
                                 f", B={a[2].shape[0]} (max abs err {err})")
        main_err = max(main_err, err)
        main_shapes.append({"Mb": int(a[0].shape[0]), "E": int(a[0].shape[1]),
                            "B": int(a[2].shape[0]), "p": a[4]})
    del recorded
    res = {"queries": len(queries), "rows": len(out["device"]) - 1, "seconds": secs,
           "seed_locate_batch_launches": launched, "main_path_err": main_err,
           "main_path_shape": main_shapes}
    log(f"[e2e] genome search --engine device: rows == --engine host's, each query's source "
        f"genome first; {json.dumps(res)} [{card}]")
    return res


def phase_end_to_end(dev, card, n_genomes, n_queries, seed, tmp, rounds, parent=None,
                     parents=None, mesh=None):
    import numpy as np
    import torch

    from lexicmap_tpu_torch import cli
    from lexicmap_tpu_torch.index.search import IndexSearcher, SearchOptions
    from lexicmap_tpu_torch.parallel.pseudo_device import W_CHUNK
    from lexicmap_tpu_torch.utils.kmers import seq_to_codes

    t0 = time.perf_counter()
    many_in = min(16, n_genomes)
    qrecs, qpath, many = write_genomes(tmp, n_genomes, n_queries, seed, many_in=many_in)
    log(f"[e2e] generated {n_genomes} genomes, {len(qrecs)} queries and {len(many)} many-hit "
        f"queries in {time.perf_counter() - t0:.1f} s")
    db = os.path.join(tmp, "idx.lmt")
    t0 = time.perf_counter()
    rc = cli.main(["index", "--quiet", "-I", os.path.join(tmp, "genomes"), "-O", db, "-b", "25"])
    if rc != 0:
        raise AssertionError(f"index build failed with {rc}")
    host_build_s = time.perf_counter() - t0
    log(f"[e2e] index built with the port's `index` in {host_build_s:.1f} s")
    build = device_build(dev, card, tmp, db, n_genomes, host_build_s)

    seqs = [s for _, s in qrecs]
    ids = [qid for qid, _ in qrecs]

    def rows(results, names, qs):
        return [list(cli.format_hit_rows(qid, len(s), r)) for qid, s, r in zip(names, qs, results)]

    host = IndexSearcher(db, SearchOptions(engine="host"))
    t0 = time.perf_counter()
    dev_idx = IndexSearcher(db, SearchOptions(engine="device", device=str(dev)))
    # the device engine with phase 3's chain1 DP and phase 5's WFA on the
    # card too (--chain device --wfa device)
    stage_idx = IndexSearcher(db, SearchOptions(engine="device", device=str(dev),
                                                chain_engine="device", wfa_engine="device"))
    host_rows = rows(host.search_many(seqs), ids, seqs)  # warm: mmap pages, native library
    dev_idx.search_many(seqs)  # warm: kernel libraries, resident blob
    stage_idx.search_many(seqs)
    init_s = time.perf_counter() - t0
    eng = dev_idx._device_engine
    seng = stage_idx._device_engine
    if eng.blob is None:
        raise AssertionError("the 200-genome store must be resident on the card")
    log(f"[e2e] {dev_idx.device_matcher.describe()}; resident genome blob "
        f"{eng.blob.hbm_bytes / 1e6:.1f} MB; init + warm pass {init_s:.1f} s")
    for times in (eng.times, seng.times):  # the timed passes only, counters included
        for key in times:
            times[key] = 0.0

    def windows(times):  # phase 4's windows, on the card and on the host
        return int(times["pseudo.card_windows"] + times["pseudo.host_windows"])

    def timed(idx, qs):
        t0 = time.perf_counter()
        res = idx.search_many(qs)
        if dev.type == "cuda":
            sync(dev)
        return res, time.perf_counter() - t0

    # the inputs of the main path's first phase-4 launch and of the many-hit
    # batch's, kept to hold the kernels against their plain versions there
    from lexicmap_tpu_torch.parallel import chain_device as CD
    from lexicmap_tpu_torch.parallel import pseudo_device as PD
    from lexicmap_tpu_torch.parallel import wfa_device as WD

    recorded, keep, real_probe = [], ["main path, first batch"], PD.pseudo_probe
    first_stage = {}  # the first chain1 and WFA launches of the main path
    real_chain1, real_wfa = CD.chain1_forward, WD.wfa_batch

    def recording_probe(*a, **kw):
        if len(recorded) < len(keep):
            recorded.append((keep[len(recorded)], a))
        return real_probe(*a, **kw)

    def recording(name, fn):
        def call(*a, **kw):
            first_stage.setdefault(name, (a, kw))
            return fn(*a, **kw)
        return call

    PD.pseudo_probe = recording_probe
    CD.chain1_forward = recording("chain1", real_chain1)
    WD.wfa_batch = recording("wfa", real_wfa)
    try:
        # `rounds` rounds of (host, device, device with the two stages,
        # the same, device, host) passes, so drift of the host clock hits
        # the engines alike; the host engine launches no kernel, so the
        # counts cover exactly the device engines' passes
        host_s, dev_s, stage_s = [], [], []
        reset_launches()  # the main path's run starts here
        for _ in range(rounds):
            host_s.append(timed(host, seqs)[1])
            dev_results, s1 = timed(dev_idx, seqs)
            stage_results, t1 = timed(stage_idx, seqs)
            _, t2 = timed(stage_idx, seqs)
            _, s2 = timed(dev_idx, seqs)
            dev_s += [s1, s2]
            stage_s += [t1, t2]
            host_s.append(timed(host, seqs)[1])
        launches = launch_counts()  # ... and ends here
        times = dict(eng.times)
        stats, n_windows = counters(times, "pseudo"), windows(times)
        stage_times = dict(seng.times)
        cstats, wstats = counters(stage_times, "chain"), counters(stage_times, "wfa")

        # the many-hit set: each query planted in 16 genomes, hundreds of
        # windows in one batch
        keep.append("many-hit batch")
        mids, mseqs = [m[0] for m in many], [m[1] for m in many]
        mhost, mh_s = timed(host, mseqs)
        w0, l0 = windows(eng.times), launch_counts()
        mdev, md_s = timed(dev_idx, mseqs)
        ml = launch_counts()
        mstage, ms_s = timed(stage_idx, mseqs)
        mls = launch_counts()
    finally:
        PD.pseudo_probe = real_probe
        CD.chain1_forward, WD.wfa_batch = real_chain1, real_wfa
    mwin = windows(eng.times) - w0
    dev_rows = rows(dev_results, ids, seqs)

    # the many-hit set again, in turns: host engine, device engine, and the
    # device engine with its phase 5 run per genome instead of in the one
    # threaded native call (LEXICMAP_TPU_NO_BATCH)
    many_s = {"host": [mh_s], "device": [md_s], "device_stages": [ms_s], "device_per_genome": []}
    for name in ("device_per_genome", "device_per_genome", "device_stages", "device", "host"):
        if name == "device_per_genome":
            os.environ["LEXICMAP_TPU_NO_BATCH"] = "1"
        try:
            got, s = timed({"host": host, "device_stages": stage_idx}.get(name, dev_idx), mseqs)
        finally:
            os.environ.pop("LEXICMAP_TPU_NO_BATCH", None)
        if rows(got, mids, mseqs) != rows(mhost, mids, mseqs):
            raise AssertionError(f"many-hit set: {name} rows differ from the host rows")
        many_s[name].append(s)

    # pseudo_probe and pseudo_chain against their plain versions on the
    # batches the main path gave them
    p = eng.pseudo
    chain_args = (p.band_base, p.band_count, p.max_gap, p.min_score, p.min_align_len,
                  PD.HEURISTIC_PIDENT)
    main_err = {"pseudo_probe": 0, "pseudo_chain": 0, "chain1": 0.0, "wfa": 0.0}
    if len(recorded) != len(keep):
        raise AssertionError(f"recorded {len(recorded)} phase-4 launches, expected {len(keep)}")
    for label, (blob_w, win, *tables) in recorded:
        probe, chain, perr, cerr, _, _ = compare_pseudo(dev, blob_w, win, tables, chain_args)
        if perr or cerr:
            raise AssertionError(f"{label}: pseudo_probe / pseudo_chain != plain "
                                 f"(max abs err {perr} / {cerr})")
        main_err["pseudo_probe"] = max(main_err["pseudo_probe"], perr)
        main_err["pseudo_chain"] = max(main_err["pseudo_chain"], cerr)
        log(f"[e2e] {label}: pseudo_probe and pseudo_chain == plain on its {win.shape[0]} "
            f"windows ({int((probe[3] > 0).sum())} with anchors, {int(chain[1].sum())} "
            f"chain rows)")
    del recorded
    # chain1 and the WFA against their plain versions on the main path's
    # first launches of each, and their times there
    main_shape = {}
    for name, (a, kw) in sorted(first_stage.items()):
        from lexicmap_tpu_torch.kernels import chain1 as C1
        from lexicmap_tpu_torch.kernels import wfa as WK

        saved = launch_counts()
        fn = real_chain1 if name == "chain1" else real_wfa
        names = ("chain1_kernel",) if name == "chain1" else WFA_KERNELS
        by = device_ms_split(lambda: fn(*a, **kw), names)
        main_shape[name] = {
            "ms": time_ms(lambda: fn(*a, **kw), dev, 20),
            "device_ms": None if None in by.values() else sum(by.values()), "device_ms_by": by}
        if parents and name in parents:
            pfn = parent_chain1 if name == "chain1" else parent_wfa
            main_shape[name]["parent"] = split_in_turns(
                dev, lambda: pfn(parents[name], *a, **kw), lambda: fn(*a, **kw),
                names if name == "chain1" else PARENT_WFA_KERNELS, names, 20,
                same=same_stage_outputs)
        if name == "chain1":
            got = real_chain1(*a, **kw)
            want = C1.chain1_forward_plain(*a[:8])
            err = float((got[0] - want[0]).abs().max()) if got[0].numel() else 0.0
            ok = torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)) and all(
                torch.equal(x, y) for x, y in zip(got[1:], want[1:]))
            what = f"{a[3].shape[0] - 1} genomes, {a[0].shape[0]} anchors"
            main_shape[name].update(genomes=a[3].shape[0] - 1, anchors=a[0].shape[0])
        else:
            got = real_wfa(*a, **kw)
            want = WK.wfa_plain(*a)
            ok = WK.decode_ops(*(x.cpu().numpy() for x in got)) == WK.decode_ops(
                *(x.cpu().numpy() for x in want))
            err = 0.0 if ok else float("inf")
            what = f"{a[3].shape[0]} pairs (S={a[5]}, W={a[6]})"
            main_shape[name].update(pairs=a[3].shape[0], S=a[5], W=a[6])
        C1.chain1_forward.launches, WK.wfa_batch.launches = (
            saved["chain1_forward"], saved["wfa_batch"])  # comparisons do not count
        if not ok:
            raise AssertionError(f"main path: {name} kernel != plain (max abs err {err})")
        main_err[name] = err
        log(f"[e2e] main path, first {name} launch: kernel == plain on its {what}; "
            f"{json.dumps(main_shape[name])} [{card}]")
    if set(first_stage) != {"chain1", "wfa"}:
        raise AssertionError(f"the stages engine did not launch both kernels: {first_stage.keys()}")

    stage_rows = rows(stage_results, ids, seqs)
    if stage_rows != host_rows:
        bad = [ids[i] for i in range(len(ids)) if stage_rows[i] != host_rows[i]]
        raise AssertionError(f"--chain device --wfa device rows differ from host rows for {bad}")
    if rows(mstage, mids, mseqs) != rows(mhost, mids, mseqs):
        raise AssertionError("many-hit set: --chain device --wfa device rows differ from host")
    per_pass = -(-len(seqs) // 32)
    stage_batches = len(stage_s) * per_pass
    wfa_pairs = wstats["wfa.card_pairs"] + wstats["wfa.host_pairs"]
    chain_share = 1 - cstats["chain.flagged_genomes"] / max(cstats["chain.genomes"], 1)
    wfa_share = wstats["wfa.card_pairs"] / max(wfa_pairs, 1)
    if dev.type == "cuda":
        if launches["chain1_forward"] != stage_batches:
            raise AssertionError(f"chain1 launched {launches['chain1_forward']} times, expected "
                                 f"{stage_batches} (one per batch)")
        if launches["wfa_batch"] < stage_batches:
            raise AssertionError(f"wfa launched {launches['wfa_batch']} times over "
                                 f"{stage_batches} batches with spans")
        if mls["chain1_forward"] - ml["chain1_forward"] != 1 or mls["wfa_batch"] == ml["wfa_batch"]:
            raise AssertionError("many-hit set: expected one chain1 launch and a WFA launch")
    if chain_share < 0.9 or wfa_share < 0.9 or not cstats["chain.genomes"] or not wfa_pairs:
        raise AssertionError(f"on the card: {chain_share:.1%} of the genomes, {wfa_share:.1%} "
                             f"of the WFA spans ({cstats}, {wstats})")
    stage_qpm = [len(seqs) / t * 60 for t in stage_s]
    log(f"[e2e] --chain device --wfa device: rows == host rows, also on the many-hit set; "
        f"chain1 {launches['chain1_forward']} launches and wfa {launches['wfa_batch']} in "
        f"{stage_batches} batches; genomes chained on the card {chain_share:.4f} {cstats}, "
        f"spans aligned there {wfa_share:.4f} {wstats}")
    log(f"[e2e] q/min per pass, in turns: device {[round(len(seqs) / t * 60, 1) for t in dev_s]}, "
        f"device with the two stages {[round(q, 1) for q in stage_qpm]} [{card}]")
    log(f"[e2e] engine times over {len(dev_s)} passes each (s): device {json.dumps(times)}; "
        f"device with the two stages {json.dumps(stage_times)}")

    if dev_rows != host_rows:
        bad = [ids[i] for i in range(len(ids)) if dev_rows[i] != host_rows[i]]
        raise AssertionError(f"device rows differ from host rows for {bad}")
    n_buckets = len(dev_idx.device_matcher.buckets)
    # batches of 32 queries: the device engine's, and both device engines'
    # (phases 2a and 4 launch in each)
    dev_batches = len(dev_s) * -(-len(seqs) // 32)
    batches = dev_batches + stage_batches
    per_batch = n_windows / dev_batches
    if dev.type == "cuda":
        if launches["seed_locate_batch"] != batches * n_buckets:
            raise AssertionError(f"the main path launched seed_locate_batch "
                                 f"{launches['seed_locate_batch']} times, expected "
                                 f"{batches * n_buckets} (one per bucket per batch)")
        if launches["seed_compact"] != batches:
            raise AssertionError(f"the main path launched seed_compact "
                                 f"{launches['seed_compact']} times, expected {batches} (one "
                                 f"per batch)")
        if launches["reverse_dispatch"] != batches:
            raise AssertionError(f"the main path launched reverse_dispatch "
                                 f"{launches['reverse_dispatch']} times, expected {batches} "
                                 f"(one per batch)")
        # each batch has windows, fewer than W_CHUNK: one launch of each
        if per_batch >= W_CHUNK or not (launches["pseudo_probe"] == launches["pseudo_chain"]
                                        == batches):
            raise AssertionError(f"phase-4 launches {launches}, expected {batches} each")
    device_share = stats["pseudo.card_windows"] / max(n_windows, 1)
    if device_share < 0.9:
        raise AssertionError(f"only {device_share:.1%} of the windows were answered on the card")
    for qid, r in zip(ids, dev_results):
        want = qid.split("_")[-1]
        if not r or r[0].genome_id.decode() != want:
            raise AssertionError(f"{qid} does not top-hit {want}")
    n = len(seqs)
    dev_qpm = [n / t * 60 for t in dev_s]
    host_qpm = [n / t * 60 for t in host_s]
    log(f"[e2e] device rows == host rows ({sum(map(len, dev_rows))} rows), all {n} "
        f"queries top-hit their genome; launches {json.dumps(launches)} in "
        f"{len(dev_s) + len(stage_s)} passes of the two device engines ({batches} batches)")
    wait_ms_batch = times["card_wait"] * 1e3 / dev_batches
    log(f"[e2e] phase 4 on the card: {stats['pseudo.card_windows']} of {n_windows} windows "
        f"answered there ({device_share:.4f}), {per_batch:.1f} windows per batch; counters "
        f"{json.dumps(stats)}; the host's waits on the card per batch {wait_ms_batch:.3f} ms")
    log(f"[e2e] q/min per pass: device {dev_qpm}, host {host_qpm} [{card}]")
    log(f"[e2e] q/min median (min-max) over {len(dev_s)} passes of {n} queries each: "
        f"device {np.median(dev_qpm):.1f} ({min(dev_qpm):.1f}-{max(dev_qpm):.1f}), "
        f"host {np.median(host_qpm):.1f} ({min(host_qpm):.1f}-{max(host_qpm):.1f})")
    log(f"[e2e] device engine times over {len(dev_s)} passes (s): {json.dumps(times)}")

    if rows(mdev, mids, mseqs) != rows(mhost, mids, mseqs):
        raise AssertionError("many-hit set: device rows differ from host rows")
    if dev.type == "cuda" and ml["pseudo_probe"] - l0["pseudo_probe"] != 1:
        raise AssertionError("many-hit set: expected one pseudo_probe launch for its batch")
    mrows = sum(len(r) for r in rows(mdev, mids, mseqs))
    log(f"[e2e] many-hit set ({len(mseqs)} queries x {many_in} planted genomes): device rows == host "
        f"rows ({mrows} rows, {mwin} windows in one batch); seconds per pass, in the order "
        f"run: {json.dumps(many_s)} [{card}]")
    if mrows < len(mseqs) * many_in:
        raise AssertionError("many-hit set: fewer rows than planted copies")

    # an engine whose genome store is over its device budget: the same
    # kernels read each batch's windows packed and uploaded
    from lexicmap_tpu_torch.parallel.engine import DeviceSearchEngine

    up = DeviceSearchEngine(dev_idx, hbm_budget=0)
    saved, dev_idx._device_engine = dev_idx._device_engine, up
    card0, win0 = up.times["pseudo.card_windows"], windows(up.times)  # dev_idx's recorder
    try:
        up_rows, up_s = timed(dev_idx, seqs)
    finally:
        dev_idx._device_engine = saved
    up_windows = windows(up.times) - win0
    up_share = (up.times["pseudo.card_windows"] - card0) / max(up_windows, 1)
    if up.blob is not None or rows(up_rows, ids, seqs) != host_rows or up_share < 0.9:
        raise AssertionError(f"store over budget: rows differ or {up_share:.1%} on the card")
    log(f"[e2e] store over the device budget (windows uploaded per batch): rows == host rows, "
        f"{up_share:.4f} of {up_windows} windows on the card, one pass "
        f"{up_s:.3f} s [{card}]")

    # genome search against the device-built index
    gres = genome_search(dev, card, tmp, build["db"],
                         [os.path.join(tmp, "genomes", f"g{gi:03d}.fasta")
                          for gi in (0, n_genomes // 2)], seed + 11)

    # the kernel vs its plain version at the shapes the main path gives it
    batch = np.stack([dev_idx._mask_query(seq_to_codes(s.upper()))[0] for s in seqs[:32]])
    shapes, compact_shapes = check_main_path_shapes(dev, card, dev_idx, batch, parent,
                                                    (parents or {}).get("seed_compact"))
    # match_batch's split on this batch of real queries (a realistic density)
    split = tail_split(dev, card, dev_idx.device_matcher, batch, dev_idx.opt.min_prefix, 20,
                       "200-genome batch")

    # single-query search with the device matcher: seed_locate (B2) per bucket
    reset_launches()  # the single-query path's run starts here
    one = [dev_idx.search(seq_to_codes(s.upper())) for s in seqs[:8]]
    single = launch_counts()  # ... and ends here
    single_launches, single_compactions = single["seed_locate"], single["seed_compact"]
    if rows(one, ids[:8], seqs[:8]) != host_rows[:8]:
        raise AssertionError("single-query search rows differ from the host rows")
    if dev.type == "cuda" and (single_launches != 8 * n_buckets or single_compactions != 8):
        raise AssertionError(f"single-query search launched seed_locate {single_launches} "
                             f"times and seed_compact {single_compactions}, expected "
                             f"{8 * n_buckets} and 8")
    log(f"[e2e] single-query search x 8: rows == host rows; seed_locate launches "
        f"{single_launches} (8 queries x {n_buckets} buckets), seed_compact "
        f"{single_compactions}")

    # the CLI, as a user runs it: same TSV as the host engine's rows
    out = os.path.join(tmp, "dev.tsv")
    reset_launches()
    rc = cli.main(["search", "--quiet", "-d", db, qpath, "-o", out, "--engine", "device",
                   "--device", str(dev)])
    if rc != 0:
        raise AssertionError(f"cli search failed with {rc}")
    with open(out) as fh:
        tsv = fh.read().splitlines()[1:]
    if tsv != [r for rr in host_rows for r in rr]:
        raise AssertionError("cli search --engine device TSV differs from the host rows")
    cli_launches = launch_counts()
    if dev.type == "cuda" and not (cli_launches["seed_locate_batch"]
                                   and cli_launches["seed_compact"]
                                   and cli_launches["pseudo_probe"]):
        raise AssertionError(f"cli search launched {cli_launches}")
    log(f"[e2e] cli search --engine device: TSV == host rows ({len(tsv)} rows); "
        f"launches {json.dumps(cli_launches)}")
    reset_launches()
    rc = cli.main(["--quiet", "search", "-d", db, qpath, "-o", out, "--engine", "device",
                   "--device", str(dev), "--chain", "device", "--wfa", "device"])
    with open(out) as fh:
        tsv = fh.read().splitlines()[1:]
    if rc != 0 or tsv != [r for rr in host_rows for r in rr]:
        raise AssertionError("cli search --chain device --wfa device TSV differs from the host rows")
    cli_launches = launch_counts()
    if dev.type == "cuda" and not (cli_launches["chain1_forward"] and cli_launches["wfa_batch"]):
        raise AssertionError(f"cli search --chain device --wfa device launched {cli_launches}")
    log(f"[e2e] cli search --engine device --chain device --wfa device: TSV == host rows; "
        f"launches {json.dumps(cli_launches)}")
    sharded = sharded_end_to_end(dev, card, mesh, db, qpath, seqs, ids, host_rows, dev_idx, tmp,
                                 rows)
    return {"sharded": sharded, "launches": launches, "single_launches": single_launches,
            "single_compactions": single_compactions, "tail_split": split, "dev_qpm": dev_qpm,
            "host_qpm": host_qpm, "times": times, "card_wait_ms_per_batch": wait_ms_batch,
            "rows": sum(map(len, dev_rows)),
            "shapes": shapes, "compact_shapes": compact_shapes,
            "hbm_bytes": dev_idx.device_matcher.hbm_bytes,
            "main_path_err": main_err,
            "device_share": device_share, "windows_per_batch": per_batch,
            "many_hit": {"rows": mrows, "windows": mwin, "seconds": many_s},
            "stage_qpm": stage_qpm, "stage_times": stage_times, "chain_share": chain_share,
            "wfa_share": wfa_share, "chainer_stats": cstats, "wfa_stats": wstats,
            "stage_main_shapes": main_shape, "build": build, "genome_search": gres,
            "inputs": (db, qrecs, many)}


def sharded_end_to_end(dev, card, mesh, db, qpath, seqs, ids, host_rows, dev_idx, tmp, rows,
                       rounds=2, n_check=2):
    """The mesh engine (DeviceSearchEngine with a one-rank mesh of four
    shards; chain1 and the WFA on the card too) on the 200-genome index:
    rows equal to the host engine's, four launches of B1 and one of the
    compaction a bucket and batch (and one more for each bucket that the
    matcher compacts again), the first `n_check` launches
    of each equal to its plain version on the same tensors; q/min in turns
    with the device engine; then the multi-process search's launcher with
    one worker of four shards: its TSV equal to the host rows."""
    import torch

    from lexicmap_tpu_torch.cli import TSV_HEADER
    from lexicmap_tpu_torch.index.search import IndexSearcher, SearchOptions
    from lexicmap_tpu_torch.kernels import seed_locate as SL
    from lexicmap_tpu_torch.kernels import shard_compact as SC
    from lexicmap_tpu_torch.parallel import sharded as TS
    from lexicmap_tpu_torch.parallel.engine import DeviceSearchEngine

    def run(eng, qs):
        out = []
        for o in range(0, len(qs), 32):
            out += eng.finish_batch(eng.prepare_batch(qs[o: o + 32]))
        sync(dev)
        return out

    midx = IndexSearcher(db, SearchOptions(device=str(dev), chain_engine="device",
                                           wfa_engine="device"))
    recorded, real = {}, {}

    def recording(name):
        kept, fn = recorded.setdefault(name, []), getattr(TS, name)
        real[name] = fn

        def call(*a, **kw):
            out = fn(*a, **kw)
            if len(kept) < n_check:  # the main path's inputs and outputs, kept
                kept.append((a, tuple(x.clone() for x in out)))
            return out
        return call

    for name in ("seed_locate_batch", "shard_compact"):
        setattr(TS, name, recording(name))
    reset_launches()  # the mesh engine's run starts here
    try:
        t0 = time.perf_counter()
        meng = DeviceSearchEngine(midx, mesh=mesh)
        init_s = time.perf_counter() - t0
        got = run(meng, seqs)
    finally:
        for name, fn in real.items():
            setattr(TS, name, fn)
    launches = launch_counts()  # ... and ends here
    if rows(got, ids, seqs) != host_rows:
        raise AssertionError("mesh engine rows differ from the host rows")
    batches = -(-len(seqs) // 32)
    per = len(meng.matcher.buckets) * batches  # compactions, one a bucket for the L shards
    second = counters(meng.times, "match")  # a query over H: its bucket compacted again
    again = second["match.second_passes"]
    if dev.type == "cuda" and not (launches["seed_locate_batch"] == mesh.local_shards * per
                                   and launches["shard_compact"] == per + again
                                   and launches["chain1_forward"] == batches):
        raise AssertionError(f"mesh engine launches {launches}, expected "
                             f"{mesh.local_shards * per} of B1 and {per} + {again} of the "
                             f"compaction ({second}), {batches} of chain1")
    for name, kept in recorded.items():
        if len(kept) != n_check:
            raise AssertionError(f"recorded {len(kept)} {name} launches, expected {n_check}")
    main_err, main_shape = 0, []
    for a, out in recorded.pop("shard_compact"):
        want = SC.shard_compact_all_plain(*a)
        err = int_err(out, want)
        if err or not all(torch.equal(x, y) for x, y in zip(out, want)):
            raise AssertionError(f"main path: shard_compact != plain (max abs err {err})")
        main_shape.append({"L": int(a[0].shape[0]), "B": int(a[0].shape[1]),
                           "rows": int(a[0].shape[2]), "H": a[3], "hits": int((a[0] > 0).sum()),
                           "most": int(out[3].max())})
    locate_err, locate_shape = 0, []
    for a, out in recorded.pop("seed_locate_batch"):  # B1 on the shard rows
        want = SL.seed_locate_batch_plain(*a)
        err = int_err(out, want)
        if err or not all(torch.equal(x, y) for x, y in zip(out, want)):
            raise AssertionError(f"main path: mesh engine's seed_locate_batch != plain on "
                                 f"Mb={a[0].shape[0]}, B={a[2].shape[0]} (max abs err {err})")
        locate_err = max(locate_err, err)
        locate_shape.append({"Mb": int(a[0].shape[0]), "E": int(a[0].shape[1]),
                             "B": int(a[2].shape[0]), "p": a[4], "path": "mesh engine"})
    log(f"[e2e] mesh engine ({meng.matcher.describe()}; init {init_s:.1f} s): rows == host "
        f"rows; launches {json.dumps(launches)}; matcher {json.dumps(second)}; first {n_check} shard_compact launches == "
        f"plain on {json.dumps(main_shape)}; first {n_check} seed_locate_batch launches == "
        f"plain on {json.dumps(locate_shape)}")

    # q/min in turns with the device engine (no claim)
    saved = launch_counts()
    dev_s, mesh_s = [], []
    for _ in range(rounds):
        for name in ("device", "mesh", "mesh", "device"):
            t0 = time.perf_counter()
            if name == "device":
                dev_idx.search_many(seqs)
                sync(dev)
            else:
                run(meng, seqs)
            (dev_s if name == "device" else mesh_s).append(time.perf_counter() - t0)
    for fn in kernel_fns():
        fn.launches = saved[fn.__name__]
    n = len(seqs)
    res = {"launches": launches, "main_path_err": main_err, "main_path_shape": main_shape,
           "locate_main_path_err": locate_err, "locate_main_path_shape": locate_shape,
           "init_s": init_s, "matcher_stats": second,
           "mesh_qpm": [n / t * 60 for t in mesh_s], "device_qpm": [n / t * 60 for t in dev_s],
           "mesh_times": dict(meng.times), "hbm_bytes": meng.matcher.hbm_bytes}
    log(f"[e2e] q/min in turns: mesh engine {[round(x, 1) for x in res['mesh_qpm']]}, device "
        f"engine {[round(x, 1) for x in res['device_qpm']]} [{card}]")
    del meng, midx

    # the launcher, one worker holding four shards, phases 3-5 on its card
    out = os.path.join(tmp, "mp.tsv")
    work = os.path.join(tmp, "mp")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "lexicmap_tpu_torch.parallel.multiproc", "--db", db,
                        "-q", qpath, "-o", out, "--nprocs", "1", "--local-devices", "4",
                        "--twins", "device", "--device", dev.type, "--workdir", work,
                        "--timeout", "500"],
                       cwd=HERE, capture_output=True, text=True, timeout=600)
    mp_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"multiproc failed with {r.returncode}: {r.stderr[-3000:]}")
    with open(out) as fh:
        tsv = fh.read().splitlines()
    if tsv != [TSV_HEADER] + [x for rr in host_rows for x in rr]:
        raise AssertionError("multiproc TSV differs from the host rows")
    with open(os.path.join(work, "summary.json")) as fh:
        res["multiproc"] = {**json.load(fh), "launcher_s": mp_s}
    log(f"[e2e] multiproc --nprocs 1 --local-devices 4 --twins device --device {dev.type}: "
        f"TSV == host rows ({len(tsv) - 1} rows); {json.dumps(res['multiproc'])} [{card}]")
    return res


def check_main_path_shapes(dev, card, idx, kmers, parent=None, compact_parent=None):
    """Each bucket of the e2e matcher, with the real queries' hi words:
    seed_locate_batch on the batch and seed_locate on its first query
    against their plain versions, their times as called and on the device
    (the kernels' profiler rows), the design's sectors, and the earlier
    tree's kernel in turns; then seed_compact on the batch's stacked
    outputs (and the first query's) against its plain version, one kernel
    row a call, and the earlier tree's compaction in turns on the batch."""
    import numpy as np
    import torch

    from lexicmap_tpu_torch.kernels.seed_compact import seed_compact, seed_compact_plain
    from lexicmap_tpu_torch.kernels.seed_locate import (
        seed_locate, seed_locate_batch, seed_locate_batch_plain, split_kmers_hi_lo)

    tp = parity()
    m = idx.device_matcher
    p = idx.opt.min_prefix
    sel = kmers != 0
    qh = np.zeros(kmers.shape, dtype=np.uint32)
    qh[sel] = split_kmers_hi_lo(kmers[sel], m.k)[0]
    qh_d = torch.from_numpy(qh.view(np.int32)).to(dev)
    sel_d = torch.from_numpy(sel).to(dev)
    out = []
    saved = (seed_locate_batch.launches, seed_locate.launches)
    for bk in m.buckets:
        a = (bk.hi, bk.cnt, qh_d.index_select(1, bk.gids).contiguous(),
             sel_d.index_select(1, bk.gids).contiguous(), p)
        one = (bk.hi, bk.cnt, a[2][0].contiguous(), a[3][0].contiguous(), p)
        nh, e0 = seed_locate_batch(*a)
        pn, pe = seed_locate_batch_plain(*a)
        sn, se = seed_locate(*one)
        err = max(int_err((nh, e0), (pn, pe)), int_err((sn, se), (pn[0], pe[0])))
        if err or not (torch.equal(nh, pn) and torch.equal(e0, pe) and torch.equal(sn, pn[0])
                       and torch.equal(se, pe[0])):
            raise AssertionError(f"kernel != plain on the main-path bucket E={bk.E}")
        r = {"Mb": int(bk.hi.shape[0]), "E": bk.E, "B": int(kmers.shape[0]), "equal": True,
             "max_abs_err": err,
             "ms": time_ms(lambda: seed_locate_batch(*a), dev, 20),
             "device_ms": device_ms(lambda: seed_locate_batch(*a), "locate_batch")[0],
             "plain_ms": time_ms(lambda: seed_locate_batch_plain(*a), dev, 3),
             "design_bytes": tp.locate_batch_replay(*a)[2].numel() * SECTOR,
             "table_bytes": bk.hi.numel() * 4,
             "single_ms": time_ms(lambda: seed_locate(*one), dev, 20),
             "single_device_ms": device_ms(lambda: seed_locate(*one), "locate_single")[0]}
        if parent is not None:
            r["parent"] = in_turns(lambda: parent_raw(parent, *a), lambda: seed_locate_batch(*a),
                                   "locate", "locate_batch")
            r["parent_single"] = in_turns(
                lambda: parent_raw(parent, *one), lambda: seed_locate(*one),
                "locate", "locate_single")
        out.append(r)
        log(f"[e2e] main-path bucket {json.dumps(r)}: kernels == plain [{card}]")
    # B4 on the same batch, all buckets in its one launch, and at B = 1
    saved_compact = seed_compact.launches
    compact = []
    for b in (slice(None), slice(0, 1)):
        stacked = m.locate_all(qh[b], sel[b], p)
        B = int(qh[b].shape[0])
        got = seed_compact(stacked, B, m.order)
        err = int_err(got, seed_compact_plain(stacked, B, m.order))
        if err:
            raise AssertionError(f"seed_compact != plain on the main path's batch (B = {B})")

        def call():
            return seed_compact(stacked, B, m.order)

        r = {"B": B, "R": int(m.order.perm.shape[0]), "buckets": len(m.buckets),
             "triples": int(got[1].shape[1]), "equal": True, "max_abs_err": err,
             "ms": time_ms(call, dev, 20), "device_ms": device_ms(call, COMPACT_KERNEL)[0],
             "kernel_rows_per_call": check_one_compact_row(call, f"main path, B = {B}")}
        if compact_parent is not None and B > 1:
            r["parent"] = split_in_turns(
                dev, lambda: parent_compact(compact_parent, stacked, B, m.order), call,
                PARENT_COMPACT_KERNELS, (COMPACT_KERNEL,), 20, a_call=COMPACT_ROWS_A_CALL)
        compact.append(r)
    log(f"[e2e] main-path B4 {json.dumps(compact)}: kernel == plain [{card}]")
    # comparison launches do not count
    seed_locate_batch.launches, seed_locate.launches = saved
    seed_compact.launches = saved_compact
    return out, compact


# --------------------------------------------------------------------------
# phase 9: utils, on a cut of phase 6's genomes, and the TaxId filter on the
# 200-genome index


def write_taxdump(root, n_genomes):
    """A synthetic NCBI taxdump (nodes.dmp: genera 10 and 20, species 11 and
    12 under 10, 21 and 22 under 20) and a genome2taxid file that gives
    genome gNNN the species (11, 12, 21, 22)[NNN % 4]."""
    os.makedirs(root)
    with open(os.path.join(root, "nodes.dmp"), "w") as fh:
        fh.write("1\t|\t1\t|\tno rank\t|\n")
        for genus in (10, 20):
            fh.write(f"{genus}\t|\t1\t|\tgenus\t|\n")
            for species in (genus + 1, genus + 2):
                fh.write(f"{species}\t|\t{genus}\t|\tspecies\t|\n")
    taxid = {f"g{gi:03d}": (11, 12, 21, 22)[gi % 4] for gi in range(n_genomes)}
    path = os.path.join(root, "genome2taxid.tsv")
    with open(path, "w") as fh:
        fh.writelines(f"{g}\t{t}\n" for g, t in taxid.items())
    return path, taxid


def phase_utils(dev, card, tmp, db, n_genomes, qrecs, many, n_cut=16, batch=8):
    """The `utils` commands as a user runs them (`cli.main`), on the first
    `n_cut` of phase 6's genomes: built with `index --engine device -b
    batch` (B10) and with `--engine host`, the trees byte-identical;
    `utils export-index` of the device-built cut, then `utils import-index`
    of the export, the imported seeds and masks those of the cut; the cut's
    queries and the many-hit set searched on the imported index with
    `search -a --engine device` and with `--chain device --wfa device`,
    rows equal to the host engine's on the cut, each run's kernels launched;
    again after `utils reindex-seeds` on a copy of it; `utils 2blast` and
    `utils 2sam` of the device TSV equal to theirs of the host TSV; then
    `search --engine device -T -G` on phase 6's index `db` under a genus
    whitelist and a species blacklist: rows equal to the host engine's,
    non-empty, every genome one the filter allows."""
    import contextlib
    import hashlib
    import io
    import shutil

    from lexicmap_tpu_torch import cli

    def run(argv, what):
        """cli.main(argv) with its stdout kept: (seconds, stdout); raises
        unless it exits 0."""
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        if rc != 0:
            raise AssertionError(f"[utils] {what} exited {rc}")
        return time.perf_counter() - t0, buf.getvalue()

    def rows(path):
        with open(path) as fh:
            return fh.read().splitlines()[1:]

    def write_queries(path, recs):
        with open(path, "wb") as fh:
            for qid, s in recs:
                fh.write(f">{qid}\n".encode() + s + b"\n")
        return path

    def searched(what, argv, path, want, need):
        """Device search of `argv` into `path`: its rows == `want`, each
        kernel of `need` launched; returns (seconds, launches)."""
        reset_launches()  # the path's run starts here
        s, _ = run([*argv, "-o", path], what)
        launches = launch_counts()  # ... and ends here
        if rows(path) != want:
            raise AssertionError(f"[utils] {what}: rows differ from the host engine's")
        if dev.type == "cuda" and not all(launches[n] for n in need):
            raise AssertionError(f"[utils] {what}: a kernel of the path was not launched: "
                                 f"{launches}")
        return s, {n: launches[n] for n in need}

    res = {"genomes": n_cut, "of": n_genomes}
    cut = os.path.join(tmp, "cut")
    gdir = os.path.join(cut, "genomes")
    os.makedirs(gdir)
    for gi in range(n_cut):
        shutil.copy(os.path.join(tmp, "genomes", f"g{gi:03d}.fasta"), gdir)
    log(f"[utils] the cut: {n_cut} of {n_genomes} genomes, in {-(-n_cut // batch)} batches "
        f"(export-index and import-index loop in Python over every posting)")

    # 1. the cut built on the card and on the host
    dev_db, host_db = os.path.join(cut, "dev.lmt"), os.path.join(cut, "host.lmt")
    reset_launches()
    res["build_device_s"], _ = run(["--quiet", "index", "-I", gdir, "-O", dev_db, "-b",
                                    str(batch), "--engine", "device", "--device", str(dev)],
                                   "index --engine device")
    res["capture_launches"] = launch_counts()["capture"]
    res["build_host_s"], _ = run(["--quiet", "index", "-I", gdir, "-O", host_db, "-b",
                                  str(batch), "--engine", "host"], "index --engine host")
    if tree_bytes(dev_db) != tree_bytes(host_db):
        raise AssertionError("[utils] the cut's device build differs from its host build")
    if dev.type == "cuda" and res["capture_launches"] != n_cut:
        raise AssertionError(f"[utils] the cut's device build launched capture "
                             f"{res['capture_launches']} times, expected {n_cut}")

    # 2. the round trip through the reference format
    ref, imp = os.path.join(cut, "ref.lmi"), os.path.join(cut, "imported.lmt")
    res["export_s"], _ = run(["utils", "export-index", "-d", dev_db, "-O", ref], "export-index")
    res["import_s"], _ = run(["utils", "import-index", "-d", ref, "-O", imp], "import-index")
    exported = tree_bytes(ref)
    digest = hashlib.sha256()
    for name in sorted(exported):
        digest.update(name.encode() + b"\0" + exported[name])
    res["exported_files"], res["exported_sha256"] = len(exported), digest.hexdigest()
    orig, back = tree_bytes(dev_db), tree_bytes(imp)
    bad = [n for n in orig if (n.startswith("seeds") or n == "masks.bin") and orig[n] != back[n]]
    if bad:
        raise AssertionError(f"[utils] the imported index differs from the cut in {bad[:5]}")
    res["round_trip_s_at_all"] = (res["export_s"] + res["import_s"]) * n_genomes / n_cut
    log(f"[utils] export-index {res['export_s']:.2f} s ({len(exported)} files, sha256 "
        f"{res['exported_sha256']}), import-index {res['import_s']:.2f} s (both ~linear in "
        f"the postings: ~{res['round_trip_s_at_all']:.0f} s at all {n_genomes} genomes); the "
        f"imported seeds and masks == the cut's [{card}]")

    # 3. the imported index searched on the card
    cut_q = [(qid, s) for qid, s in qrecs if int(qid.rsplit("g", 1)[1]) < n_cut]
    qpath = write_queries(os.path.join(cut, "q.fasta"), cut_q + list(many))
    host_tsv = os.path.join(cut, "host.tsv")
    res["host_search_s"], _ = run(["search", "--quiet", "-d", dev_db, qpath, "-o", host_tsv,
                                   "-a", "--engine", "host"], "search --engine host")
    want = rows(host_tsv)
    hit = {r.split("\t")[0] for r in want}
    if not cut_q or not all(qid in hit for qid, _ in cut_q):
        raise AssertionError(f"[utils] a query of the cut has no host rows: {cut_q and hit}")
    base = ["search", "--quiet", "-d", imp, qpath, "-a", "--engine", "device", "--device",
            str(dev)]
    on_path = ["seed_locate_batch", "seed_compact", "pseudo_probe", "pseudo_chain"]
    dev_tsv = os.path.join(cut, "device.tsv")
    res["device_search_s"], res["device_launches"] = searched(
        "search --engine device on the imported index", base, dev_tsv, want, on_path)
    res["stages_search_s"], res["stages_launches"] = searched(
        "search --chain device --wfa device on the imported index",
        base + ["--chain", "device", "--wfa", "device"], os.path.join(cut, "stages.tsv"), want,
        on_path + ["chain1_forward", "wfa_batch"])
    res["queries"], res["rows"] = len(cut_q) + len(many), len(want)
    res["many_hit_queries_with_rows"] = len({q for q, _ in many} & hit)
    log(f"[utils] imported index, {res['queries']} queries ({len(cut_q)} of the cut, "
        f"{res['many_hit_queries_with_rows']} many-hit with rows): device rows == host rows "
        f"({len(want)} rows); launches {json.dumps(res['device_launches'])}, with --chain "
        f"device --wfa device {json.dumps(res['stages_launches'])}")

    # 4. reindex-seeds on a copy of the imported index
    reindexed = os.path.join(cut, "reindexed.lmt")
    shutil.copytree(imp, reindexed)
    res["reindex_s"], _ = run(["utils", "reindex-seeds", "-d", reindexed], "reindex-seeds")
    base[3] = reindexed
    res["reindexed_search_s"], _ = searched(
        "search --engine device after reindex-seeds", base, os.path.join(cut, "re.tsv"),
        want, on_path)

    # 5. the TSV tools on the device engine's TSV and the host engine's
    for tool in ("2blast", "2sam"):
        out = [os.path.join(cut, f"{tool}.{n}") for n in ("device", "host")]
        for tsv, o in zip((dev_tsv, host_tsv), out):
            run(["utils", tool, tsv, "-o", o], f"utils {tool}")
        with open(out[0], "rb") as a, open(out[1], "rb") as b:
            got, ref_out = a.read(), b.read()
        if got != ref_out or len(got) < 1000:
            raise AssertionError(f"[utils] {tool} of the device TSV != of the host TSV")
        res[f"{tool}_bytes"] = len(got)
    log(f"[utils] reindex-seeds {res['reindex_s']:.2f} s, device rows after it == host rows; "
        f"2blast and 2sam of the device TSV == of the host TSV ({res['2blast_bytes']} and "
        f"{res['2sam_bytes']} bytes)")

    # 6. the TaxId filter on the card, on phase 6's index
    g2t, taxid = write_taxdump(os.path.join(tmp, "taxdump"), n_genomes)
    tq = write_queries(os.path.join(tmp, "tq.fasta"), list(qrecs) + list(many))
    res["taxid"] = {}
    for label, flags, allowed in (("genus 10 whitelist", ["-t", "10"], {11, 12}),
                                  ("species 21 blacklist", ["-t", "-21"], {11, 12, 22})):
        argv = ["search", "--quiet", "-d", db, tq, "-T", os.path.dirname(g2t), "-G", g2t,
                *flags]
        host_out = os.path.join(tmp, "taxid_host.tsv")
        host_s, _ = run([*argv, "-o", host_out, "--engine", "host"], f"{label}, host")
        want = rows(host_out)
        genomes = {r.split("\t")[3] for r in want}
        if not want or not all(taxid[g] in allowed for g in genomes):
            raise AssertionError(f"[utils] {label}: {len(want)} host rows, genomes "
                                 f"{sorted(genomes)[:8]}")
        dev_s, launches = searched(f"{label}, device engine",
                                   [*argv, "--engine", "device", "--device", str(dev)],
                                   os.path.join(tmp, "taxid_device.tsv"), want, on_path)
        res["taxid"][label] = {"rows": len(want), "genomes": len(genomes), "host_s": host_s,
                               "device_s": dev_s, "launches": launches}
        log(f"[utils] TaxId {label}: device rows == host rows ({len(want)} rows over "
            f"{len(genomes)} genomes, all allowed); launches {json.dumps(launches)}")
    return res


# --------------------------------------------------------------------------


def capture_row(rows, build):
    """The kernels line's B10 row: the largest genome's numbers (every
    genome's under "genomes"), launches from the main path's device build,
    the error over phase 8 and the build's first launches against the plain
    version."""
    big = max(rows, key=lambda r: r["bases"])
    err = max([r["max_abs_err"] for r in rows] + [build["main_path_err"]])
    return {"name": "capture", "route": "cuda", "source": "lexicmap_tpu_torch/csrc/capture.cu",
            "replaces": "lexicmap_tpu/parallel/build_device.py:57",
            "launches": build["capture_launches"], "equal": err == 0,
            "max_abs_err": err, "main_path_err": build["main_path_err"],
            "main_path_shape": build["main_path_shape"], "ms": big["ms"],
            "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
            "library_ms": None, "library": "none: no PyTorch call computes a LexicHash capture",
            "device_ms": big["device_ms"], "device_ms_by": big["device_ms_by"],
            "design": "a thread rolls both k-mers over a run of up to 32 positions; the bucket "
                      "table staged in shared memory at p <= 8",
            "shape": {k: big[k] for k in ("bases", "masks", "p")}, "genomes": rows}


def sharded_row(name, replaces, res, launches, main_err, main_shape, library):
    """The kernels line's row of B11 or B12's compaction: the numbers at the
    10k shape, launches and the first launches' check from the main path."""
    err = max(res["max_abs_err"], main_err)
    return {"name": name, "route": "cuda", "source": "lexicmap_tpu_torch/csrc/sharded.cu",
            "replaces": replaces, "launches": launches, "equal": res["equal"] and err == 0,
            "max_abs_err": err, "main_path_err": main_err, "main_path_shape": main_shape,
            "ms": res["ms"], "device_ms": res["device_ms"], "device_ms_by": res["device_ms_by"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"], "library": library,
            "shape": {key: res[key] for key in ("B", "E", "p", "M", "L", "k", "mb_pad", "H")
                      if key in res},
            **{key: res[key] for key in ("sector_bytes", "design_bytes", "io_bytes", "bytes",
                                         "step_ms", "parent", "matcher_ms_per_batch",
                                         "matcher_ms_first_pass_only", "second_pass_queries",
                                         "launches_per_bucket")
               if key in res}}


def compact_row(mres, eres):
    """The kernels line's B4 row: the numbers at the 10k shape, launches
    from phase 6's main path (and the single-query path's), the chunked
    table's and the main path's checks, match_batch's split before and
    after at both densities."""
    comp, chunked = mres["compaction"], mres["chunked"]["compaction"]
    err = max([comp["max_abs_err"], chunked["max_abs_err"]]
              + [r["max_abs_err"] for r in eres["compact_shapes"]])
    return {"name": "seed_compact", "route": "cuda",
            "source": "lexicmap_tpu_torch/csrc/seed_compact.cu",
            "replaces": "lexicmap_tpu/parallel/device_search.py:263",
            "launches": eres["launches"]["seed_compact"], "equal": err == 0, "max_abs_err": err,
            "ms": comp["ms"], "device_ms": comp["device_ms"], "device_ms_by": comp["device_ms_by"],
            "plain_ms": comp["plain_ms"], "bound_ms": comp["bound_ms"], "bound_by": "bytes",
            "library_ms": comp["library_ms"], "library_device_ms": comp["library_device_ms"],
            "library": "torch.nonzero and gathers a bucket, then torch.sort of one int64 "
                       "(query, mask, e0) key",
            "shape": {k: comp[k] for k in ("B", "R", "buckets", "triples", "hit_rows")},
            "bytes": comp["bytes"], "design_bytes": comp["design_bytes"],
            "kernel_rows_per_call": comp["kernel_rows_per_call"],
            **({"parent": comp["parent"]} if "parent" in comp else {}),
            "single_launches": eres["single_compactions"], "chunked_table": chunked,
            "main_path_shape": eres["compact_shapes"],
            "tail_split": {"10k shape": mres["tail_split"]["runs"],
                           "200-genome batch": eres["tail_split"]["runs"]}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--genomes", type=int, default=200)
    ap.add_argument("--queries", type=int, default=40)
    ap.add_argument("--rounds", type=int, default=5,
                    help="end-to-end timing rounds of (host, device, device, host) passes")
    ap.add_argument("--compare-source", metavar="CU", action="append", default=[],
                    help="an earlier tree's csrc/seed_locate.cu, seed_match.cu, chain1.cu, "
                         "wfa.cu, sharded.cu, capture.cu or seed_compact.cu (given once each; "
                         "any header it includes beside it): build it "
                         "too and time its kernels against this tree's, in turns, at the same "
                         "shapes")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import lexicmap_tpu_torch

    if os.path.dirname(os.path.abspath(lexicmap_tpu_torch.__file__)) != os.path.join(
            HERE, "lexicmap_tpu_torch"):
        print("chip_smoke: lexicmap_tpu_torch is not beside this script", file=sys.stderr)
        return 1
    from lexicmap_tpu_torch.kernels import build

    t_all = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, card: {card}")

    t0 = time.perf_counter()
    started = parent_build(args.compare_source)
    libs = build.build(["seed_locate", "seed_match", "pseudo_align", "chain1", "wfa", "capture",
                        "sharded", "seed_compact", "reverse_dispatch"])
    parents = parent_load(started)  # {source name: the earlier tree's library}
    parent = parents.get("seed_locate")
    log(f"[build] {len(libs) + len(parents)} kernel sources built with nvcc in parallel in "
        f"{time.perf_counter() - t0:.1f} s")

    n_edges = check_locate_edges(dev)
    n_match_edges = check_match_edges(dev)
    kres, sres = phase_kernel(dev, card, Mb=20_000, E=10_240, B=32, p=15, seed=args.seed,
                              reps=20, parent=parent)
    torch.cuda.empty_cache()
    bres = phase_seed_match(dev, card, Mb=20_000, E=10_240, p=15, seed=args.seed + 3, reps=20,
                            parent=parents.get("seed_match"))
    torch.cuda.empty_cache()
    mres, mstate = phase_matcher(dev, card, M=20_000, E=10_240, B=32, p=15, seed=args.seed,
                                 reps=5, parent=parents.get("seed_compact"))
    torch.cuda.empty_cache()
    mres["chunked"] = phase_matcher_chunked(dev, card, seed=args.seed, reps=5,
                                            parent=parents.get("seed_compact"))
    torch.cuda.empty_cache()
    rres = phase_reverse(dev, card, seed=args.seed + 17, reps=20)
    torch.cuda.empty_cache()
    shres, cpres, mesh = phase_sharded(dev, card, mstate, seed=args.seed, reps=20,
                                       parent=parents.get("sharded"))
    del mstate
    torch.cuda.empty_cache()
    pres, cres, p4 = phase_pseudo(dev, card, n_stores=4, per_store=250, genome_len=4 << 20,
                                  n_sites=2048, n_sample=256, seed=args.seed + 5, reps=5)
    if p4["blob_bytes"] < 1e9:
        raise AssertionError("the phase-4 blob must hold at least 1 GB")
    torch.cuda.empty_cache()
    cres7, wres7 = phase_chain_wfa(dev, card, seed=args.seed + 9, reps=10, parents=parents)
    torch.cuda.empty_cache()
    capres = phase_capture(dev, card, seed=args.seed + 13, reps=5, parent=parents.get("capture"))
    with tempfile.TemporaryDirectory(prefix="lexicmap_smoke_") as tmp:
        eres = phase_end_to_end(dev, card, args.genomes, args.queries, args.seed, tmp,
                                args.rounds, parent, parents, mesh)
        t0 = time.perf_counter()
        db, qrecs, many = eres.pop("inputs")
        ures = phase_utils(dev, card, tmp, db, args.genomes, qrecs, many)
        ures["seconds"] = time.perf_counter() - t0
    mesh.close()

    def seed_row(name, source, replaces, res, launches, extra=None):
        return {"name": name, "route": "cuda", "source": f"lexicmap_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "equal": res["equal"],
                "max_abs_err": res["max_abs_err"], "ms": res["kernel_ms"],
                "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"], "library_ms": res["library_ms"],
                "shape": {"Mb": res["Mb"], "E": res["E"], "B": res["B"], "p": res["p"]},
                **(extra or {})}

    def pseudo_row(name, replaces, res):
        err = max(res["max_abs_err"], eres["main_path_err"][name])
        return {"name": name, "route": "cuda",
                "source": "lexicmap_tpu_torch/csrc/pseudo_align.cu", "replaces": replaces,
                "launches": eres["launches"][name], "equal": err == 0, "max_abs_err": err,
                "ms": res["ms"], "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"], "library_ms": None,
                "shape": {"windows": res["windows"], "full_windows": res["full_windows"],
                          "full_ms": res["full_ms"]}}

    def stage_row(name, source, replaces, res, shape, share):
        err = max(res["max_abs_err"], eres["main_path_err"][name])
        return {"name": name, "route": "cuda", "source": f"lexicmap_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": eres["launches"][
                    "chain1_forward" if name == "chain1" else "wfa_batch"],
                "equal": err == 0, "max_abs_err": err, "ms": res["ms"],
                "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"], "library_ms": None,
                "library": "none: no PyTorch call computes this DP",
                "device_ms": res["device_ms"], "device_ms_by": res["device_ms_by"],
                "shape": shape, "phase7_device_share": res["device_share"],
                **{k: res[k] for k in ("parent", "us_per_step", "block_min", "by_block_min")
                   if k in res},
                "main_path_device_share": share, "main_path_shape": eres["stage_main_shapes"][name]}

    def locate_extra(res, edges=n_edges, **more):
        keys = ("device_ms", "device_ms_by", "design_bytes", "design_lo_bytes", "sector_bytes",
                "io_bytes", "parent")
        return {**{k: res[k] for k in keys if k in res}, "edge_shapes": edges, **more}

    gs, mesh_run = eres["genome_search"], eres["sharded"]
    main_locate_err = max([gs["main_path_err"], mesh_run["locate_main_path_err"]]
                          + [r["max_abs_err"] for r in eres["shapes"]])
    kres_all = {**kres, "max_abs_err": max(kres["max_abs_err"], main_locate_err)}
    kres_all["equal"] = kres["equal"] and kres_all["max_abs_err"] == 0
    kernels = [
        seed_row("seed_locate_batch", "seed_locate.cu",
                 "lexicmap_tpu/parallel/pallas_kernels.py:119", kres_all,
                 eres["launches"]["seed_locate_batch"],
                 locate_extra(kres, main_path_shapes=eres["shapes"],
                              main_path_err=main_locate_err,
                              main_path_shape=[{**sh, "path": "genome search"}
                                               for sh in gs["main_path_shape"]]
                              + mesh_run["locate_main_path_shape"])),
        seed_row("seed_locate", "seed_locate.cu", "lexicmap_tpu/parallel/pallas_kernels.py:79",
                 sres, eres["single_launches"], locate_extra(sres)),
        seed_row("seed_match", "seed_match.cu", "lexicmap_tpu/parallel/pallas_kernels.py:205",
                 bres, 0, locate_extra(bres, n_match_edges)),
        pseudo_row("pseudo_probe", "lexicmap_tpu/parallel/pseudo_device.py:196", pres),
        pseudo_row("pseudo_chain", "lexicmap_tpu/parallel/pseudo_device.py:464", cres),
        stage_row("chain1", "chain1.cu", "lexicmap_tpu/parallel/chain_device.py:55", cres7,
                  {"sets": cres7["sets"], "anchors": cres7["anchors"], "visits": cres7["visits"]},
                  eres["chain_share"]),
        stage_row("wfa", "wfa.cu", "lexicmap_tpu/parallel/wfa_device.py:49", wres7,
                  {"pairs": wres7["pairs"], "bucket": wres7["bucket"], "cells": wres7["cells"],
                   "answered": wres7["answered"]}, eres["wfa_share"]),
        capture_row(capres, eres["build"]),
        sharded_row("seed_match_shard", "lexicmap_tpu/parallel/sharded.py:41", shres,
                    shres["launches"], shres["main_path_err"], shres["main_path_shape"],
                    "torch.searchsorted x2 over the whole rows"),
        sharded_row("shard_compact", "lexicmap_tpu/parallel/sharded.py:205", cpres,
                    eres["sharded"]["launches"]["shard_compact"],
                    eres["sharded"]["main_path_err"], eres["sharded"]["main_path_shape"],
                    "torch.sort (stable) of the keys, the sort of JAX's step"),
        compact_row(mres, eres),
        reverse_row(rres, eres),
    ]
    log(f"[summary] matcher {json.dumps(mres)}")
    log(f"[summary] phase4 {json.dumps(p4)}")
    log(f"[summary] phase7 chain1 {json.dumps(cres7)}")
    log(f"[summary] phase7 wfa {json.dumps(wres7)}")
    log(f"[summary] capture {json.dumps(capres)}")
    log(f"[summary] sharded: seed_match_shard {json.dumps(shres)}; shard_compact "
        f"{json.dumps(cpres)}; mesh engine "
        f"{json.dumps({k: v for k, v in mesh_run.items() if k != 'launches'})}")
    log(f"[summary] index build {json.dumps({k: v for k, v in eres['build'].items() if k != 'db'})}"
        f"; genome search {json.dumps(eres['genome_search'])}")
    log(f"[summary] utils {json.dumps(ures)}")
    log(f"[summary] e2e q/min device {eres['dev_qpm']} device with chain1 + wfa "
        f"{eres['stage_qpm']} host {eres['host_qpm']}; many-hit "
        f"{json.dumps(eres['many_hit'])}; total {time.perf_counter() - t_all:.1f} s")
    on_path = ("seed_locate_batch", "seed_compact", "reverse_dispatch", "pseudo_probe",
               "pseudo_chain", "chain1_forward", "wfa_batch")
    mesh_path = ("seed_locate_batch", "shard_compact", "reverse_dispatch", "pseudo_probe",
                 "pseudo_chain", "chain1_forward", "wfa_batch")
    if (not all(eres["launches"][n] for n in on_path) or not eres["single_launches"]
            or not eres["single_compactions"]
            or not eres["build"]["capture_launches"] or not shres["launches"]
            or not all(eres["sharded"]["launches"][n] for n in mesh_path)):
        raise AssertionError(f"a kernel of the path was not launched: {eres['launches']}, "
                             f"capture {eres['build']['capture_launches']}, seed_match_shard "
                             f"{shres['launches']}, mesh engine {eres['sharded']['launches']}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
