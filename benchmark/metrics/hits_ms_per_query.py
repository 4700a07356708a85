"""hits_ms_per_query: the per-hit stages (phase 3 chaining, phase 4 window
prep and pseudo-alignment, phases 5-6 alignment and assembly, the device
WFA inside them) a query, from the engine's phase timers.  Phase 5 runs in
the finish thread, beside the next batch's phases 1-4."""


def read(run):
    t = run.eng_times
    if not t or not run.n_queries:
        return None
    return (t["chain"] + t["winprep"] + t["pseudo"] + t["align"]) / run.n_queries * 1e3
