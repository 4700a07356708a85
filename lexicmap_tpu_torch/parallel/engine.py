"""The device search engine: a whole query batch flows through the search
pipeline with its two device phases on the GPU.

Per batch of up to 32 queries:
  1. host: query masking (capture, the low-complexity filter)
  2a. device: prefix seed matching for ALL queries x all masks, one launch
      of the CUDA seed-locate kernel per bucket (device_search.py); beside
      it, queued before its waits, the reversed-k-mer dispatch of every
      query in one launch (kernels/reverse_dispatch.py)
  2b. host: prefix filter, suffix search and posting gather
  3. host: anchor chaining; with --chain device, the chain1 forward DP of
     every genome of every query in one launch of the CUDA chain1 kernel
     (chain_device.py), the backtrack on the host
  4. host: window extraction (the windows phase 5 extends and aligns);
     device: pseudo-alignment of every candidate window of every query,
     one launch each of the pseudo_probe and pseudo_chain kernels
     (pseudo_device.py)
  5-6. host: extension, WFA, scoring and result assembly with the device
     chain rows injected (`_phase4_assemble` with `pseudo_map`), threaded
     per genome or in one threaded native call for a many-hit query; with
     --wfa device, the WFA spans of every genome of every query go to the
     card in one DeviceWFA call (wfa_device.py) between two threaded host
     stages

Device memory: the seed table is sized first (IndexSearcher builds the
matcher), then the genome store is made resident (resident.py) when it fits
the budget the table leaves; the kernels then read each window from it by
geometry.  A store larger than that leaves the kernels to read each
batch's windows packed and uploaded, the same work on the same card.

Every batch that has windows runs phase 4 on the device; a window the
kernels flag (or one too long for them) is aligned by the host code inside
phase 5.  Phases 5-6 of batch N overlap with phases 1-4 of batch N+1
through `search_many`'s finish pool.

With a mesh (parallel/sharded.py), phase 2a runs through the mask-sharded
ShardedSeedMatcher instead: the seed table split over the mesh's tp shards
(L a rank, each one launch of the seed-locate kernel and one of the
compaction kernel a bucket) and the hits gathered over the ranks.  Phases
3-5 then run on the rank's own device, as the JAX package's multi-process
workers run them (lexicmap_tpu/parallel/multiproc.py).  Where the JAX
package spreads phases 3-5 over the devices of one process along dp
(pseudo_device.py, wfa_device.py, chain_device.py there), a rank here
holds one device and runs them there; the rows are the same either way.

Output is identical to the host engine: the device matchers return exactly
the host bisection's triples (the sharded one compacts a bucket again
where a query passes its hit capacity), the reversed dispatch exactly the
host's arrays (or declines a query, which the host then dispatches), the
device pseudo-aligner
exactly the host's chain rows, the device chainer exactly the host's
forward DP and the device WFA exactly the host's op streams (or flags the
item for the host), and everything downstream is the identical host code
(ref: lib-index-search.go:1154-2897 for the phase structure).
"""

from __future__ import annotations

from time import perf_counter

import numpy as np
import torch

from ..kernels import reverse_dispatch as RD
from ..ops.seqcompare import SeqComparator
from ..utils.kmers import seq_to_codes
from .device_search import default_budget
from .pseudo_device import WORDS_OUT, DevicePseudoAligner
from .resident import DeviceGenomeBlob, store_bytes


def match_phase(idx, matcher, kmers: np.ndarray) -> list:
    """Phase 2a for a [B, m] batch of masked query k-mers: each query's
    device triples, or None where there is no device match (no matcher, or
    a min prefix over 16 bases); a None query is matched by the host
    bisection."""
    if matcher is None or idx.opt.min_prefix > 16:
        return [None] * kmers.shape[0]
    return matcher.match_batch(kmers, idx.opt.min_prefix)


class DeviceSearchEngine:
    def __init__(self, idx, hbm_budget: int | None = None, mesh=None):
        """hbm_budget: bytes the resident genome store may take (default
        `default_budget`, read from the card once the seed table is on
        it).  mesh: a parallel.sharded.Mesh; phase 2a then runs through a
        ShardedSeedMatcher over it, and the engine's device stages run on
        the mesh's device (with chain_engine "device", a DeviceChainer is
        made there when idx has none).  Every rank of the mesh runs
        phase 2a on the same batches (`prepare_batch`)."""
        self.idx = idx
        self.mesh = mesh
        device = idx.opt.device
        if mesh is None:
            self.matcher = idx.device_matcher
        else:
            from .sharded import ShardedSeedMatcher

            device = mesh.device
            self.matcher = ShardedSeedMatcher(idx, mesh)
            if idx.opt.chain_engine == "device" and idx.device_chainer is None:
                idx.device_chainer = idx.make_device_chainer(device)
        copt = idx.opt.seqcompare_options().chaining
        self.pseudo = DevicePseudoAligner(
            band_base=copt.band_base,
            band_count=copt.band_count,
            max_gap=int(copt.max_gap),
            min_score=copt.min_score,
            min_align_len=copt.min_align_len,
            device=device,
        )
        if hbm_budget is None:
            hbm_budget = default_budget(self.pseudo.device)
        # the genome store, resident on the card when it fits: phase-4
        # windows are then read from it by geometry, else uploaded per batch
        self.blob = None
        if store_bytes(idx.genome_stores) <= hbm_budget:
            self.blob = DeviceGenomeBlob(idx.genome_stores, device=self.pseudo.device)
        self.pseudo.blob = self.blob
        # phase 2b's reversed-k-mer dispatch runs on the card wherever phase
        # 2a has a device matcher and the kernel takes the mask set (an
        # index of more masks stays on the host's dispatch): the sorted
        # masks and their tree, once
        self.masks = (None if self.matcher is None or idx.mask_set.m > RD.MAX_M else
                      RD.mask_tree(idx.mask_set.masks, idx.k, self.pseudo.device))
        #: the searcher's span recorder (utils/spans.py), and its totals:
        #: cumulative wall per engine phase (seconds), mask (1), match (2a),
        #: anchors (2b), chain (3), winprep and pseudo (4), align (5-6), and
        #: wfa, the part of align in the device WFA (--wfa device); then the
        #: parts of phases 1 and 2b, the wait on the finish thread, the
        #: waits on the card and the host WFA inside wfa; then the counters
        #: of phase 4's windows and phase 5's WFA pairs, card and host
        #: (items, not seconds; spans.COUNTERS)
        self.spans = idx.spans
        self.times = self.spans.totals

    # two-stage API so that search_many can overlap host phases 5-6 of
    # batch N with phases 1-4 of batch N+1

    def prepare_batch(self, seqs: list[bytes], matched=None):
        """Phases 1-4: host masking, device seed matching, host posting
        gather and chaining, device pseudo-alignment.  Returns an opaque
        state for finish_batch.

        matched: phases 1-2a already run for these queries, {i: (masked,
        dev_hits)} for every query i of k bases or more (the multi-process
        search matches every query on every rank, then each rank takes
        its own share of them here)."""
        idx = self.idx
        sp = self.spans
        sp.bind_thread()
        sopt = idx.opt.seqcompare_options()
        if sum(len(s) >= idx.k for s in seqs) > 32:
            raise ValueError("engine batches are capped at 32 queries")
        # phase 1 a query: its 2-bit codes and masking
        codes, masked = [], {}
        for i, s in enumerate(seqs):
            if matched is not None or len(s) < idx.k:
                codes.append(seq_to_codes(s.upper()))
                continue
            with sp.span("mask", i):
                codes.append(seq_to_codes(s.upper()))
                masked[i] = idx._mask_query(codes[i], i)
        valid = [i for i, c in enumerate(codes) if c.shape[0] >= idx.k]
        if not valid:
            return (codes, [], {}, {}, {}, {})

        rev = None
        if matched is not None:
            masked = {i: matched[i][0] for i in valid}
            dev_hits = {i: matched[i][1] for i in valid}
            if self.masks is not None:
                with sp.span("match.reverse"):
                    rev = self._reverse(np.stack([masked[i][0] for i in valid]))()
        else:
            kmers = np.stack([masked[i][0] for i in valid])
            with sp.span("match"):
                # the reversed dispatch is queued before phase 2a's waits on
                # the card and fetched after them: match.reverse times the
                # upload and launch, then the fetch
                t0 = perf_counter()
                fetch = None if self.masks is None else self._reverse(kmers)
                t1 = perf_counter()
                dev_hits = match_phase(idx, self.matcher, kmers)
                if fetch is not None:
                    t2 = perf_counter()
                    rev = fetch()
                    sp.add("match.reverse", t1 - t0 + perf_counter() - t2)
            dev_hits = dict(zip(valid, dev_hits))

        pg_of = {}
        for n, i in enumerate(valid):
            with sp.span("anchors", i):
                pg_of[i] = idx._collect_anchors(codes[i], premasked=masked[i],
                                                dev_hits_pre=dev_hits[i], qi=i,
                                                rev_pre=None if rev is None else (rev, n))
        with sp.span("chain"):
            if idx.device_chainer is not None:
                # --chain device: the chain1 DP of every genome of every
                # query in one kernel launch (chain_device.py)
                hits_of = dict(zip(valid, idx._chain_genomes_many(
                    [pg_of[i] or {} for i in valid])))
            else:
                hits_of = {i: (idx._chain_genomes(pg_of[i]) if pg_of[i] else [])
                           for i in valid}

        # window prep, then one device pseudo-align run over every window of
        # every query (the JAX engine's phase 4, lexicmap_tpu/parallel/engine.py);
        # the comparators and windows go on to phase 5
        with sp.span("winprep"):
            queries, windows, geoms, wmeta = [], [], [], []
            cpr_of: dict[int, SeqComparator] = {}
            wins_of: dict[int, dict[int, tuple]] = {}
            for i in valid:
                if not hits_of[i]:
                    continue
                cpr = cpr_of[i] = SeqComparator(sopt)
                cpr.index(codes[i])
                qpos = len(queries)
                queries.append((cpr.qk, cpr.qv))
                for hi, (hit, anchors, paths) in enumerate(hits_of[i]):
                    spaths = sorted(paths, key=lambda p: int(anchors.tbegin[p[0]]))
                    wins = wins_of.setdefault(i, {})[hi] = idx._path_windows(
                        codes[i], hit, anchors, spaths)
                    for pp, (w, meta) in enumerate(zip(wins[0], wins[1])):
                        windows.append((qpos, w, meta[0], meta[1]))
                        wmeta.append((i, hi, pp))
                        if self.blob is None:
                            continue
                        # meta = (q_begin, q_end, t_begin, t_end, rc, seeds); t_end
                        # is already clipped, so the geometry's length equals the
                        # window's unless the store disagrees (then: the host)
                        wb, ph, L = self.blob.geometry(hit.genome_batch, hit.genome_index,
                                                       meta[2], meta[3], meta[4], WORDS_OUT)
                        geoms.append((wb, ph, bool(meta[4])) if L == w.shape[0] else None)
        with sp.span("pseudo"):
            res = self.pseudo.run_batch(queries, windows,
                                        geoms if self.blob is not None else None)
        pseudo_maps: dict[int, dict[int, list]] = {}
        for (i, hi, pp), r in zip(wmeta, res):
            lst = pseudo_maps.setdefault(i, {}).setdefault(hi, [])
            assert len(lst) == pp
            lst.append(r)
        return (codes, valid, hits_of, pseudo_maps, cpr_of, wins_of)

    def _reverse(self, kmers: np.ndarray):
        """The reversed-k-mer dispatch of a [B, m] batch of masked k-mers,
        uploaded and launched on the engine's device; returns the function
        that fetches it (kernels/reverse_dispatch.py::reverse_dispatch)."""
        return RD.reverse_dispatch(
            torch.from_numpy(kmers.view(np.int64)).to(self.masks.tree.device), self.masks)

    def finish_batch(self, prepared):
        """Phases 5-6: extension, alignment and assembly, with the device
        chain rows of phase 4.

        With --wfa device (and no -a) the WFA spans of EVERY genome of
        EVERY query in the batch are aligned in one DeviceWFA.align_batch
        call, between a threaded stage that collects them and a threaded
        stage that scores and assembles with the op streams injected
        (ref: the JAX engine's batch-wide flow)."""
        self.spans.bind_thread()
        with self.spans.span("align"):
            return self._finish(*prepared)

    def _finish(self, codes, valid, hits_of, pseudo_maps, cpr_of, wins_of):
        idx = self.idx
        out = [[] for _ in codes]
        if idx.device_wfa is None or idx.opt.output_seq:
            for i in valid:
                if hits_of[i]:
                    out[i] = idx._phase4_assemble(codes[i], hits_of[i],
                                                  pseudo_map=pseudo_maps.get(i),
                                                  cpr=cpr_of[i], wins_map=wins_of.get(i))
            return out

        jobs = []
        for i in valid:
            for hi, (hit, anchors, paths) in enumerate(hits_of[i]):
                jobs.append({
                    "i": i, "hi": hi, "hit": hit, "anchors": anchors,
                    "paths": sorted(paths, key=lambda p: int(anchors.tbegin[p[0]])),
                    "pseudo": pseudo_maps.get(i, {}).get(hi),
                    "wins": wins_of.get(i, {}).get(hi)})
        pool = idx.phase4_pool()

        # stage A (threaded; the native span collection releases the GIL):
        # each genome's align_paths arguments and its WFA spans
        def prep(job):
            i = job["i"]
            ctx = idx._align_prepare_native(codes[i], job["hit"], job["anchors"], job["paths"],
                                            cpr_of[i], job["pseudo"], job["wins"])
            job["ctx"] = ctx
            job["pairs"] = idx._align_spans_native(codes[i], ctx) if isinstance(ctx, dict) else []

        list(pool.map(prep, jobs))
        # stage B: one device alignment over every span of the batch
        with self.spans.span("wfa"):
            all_pairs = [p for job in jobs for p in job["pairs"]]
            all_ops = idx.device_wfa.align_batch(all_pairs) if all_pairs else []
        o = 0
        for job in jobs:
            k = len(job["pairs"])
            job["ops"] = all_ops[o: o + k] if k else None
            o += k

        # stage C (threaded): align_paths with the op streams injected,
        # then the per-genome details
        def fin(job):
            i, ctx = job["i"], job["ctx"]
            r = None
            if ctx is not None and ctx is not NotImplemented:
                r = idx._align_finish_native(codes[i], job["hit"], ctx, job["ops"])
            if ctx is NotImplemented or r is NotImplemented:
                r = idx._align_genome(codes[i], job["hit"], job["anchors"], job["paths"],
                                      cpr_of[i], pseudo=job["pseudo"], wins=job["wins"])
            job["result"] = r

        list(pool.map(fin, jobs))
        # stage D: per query, the chunk merge, qcovGnm and output order
        for i in valid:
            got = [job["result"] for job in jobs if job["i"] == i and job["result"] is not None]
            out[i] = idx._assemble_results(codes[i], got)
        return out
