"""front_ms_per_query: the query front end's host time (phase 1, masking,
and phase 2b, the posting gather) a query, from the engine's own phase
timers over the window."""


def read(run):
    t = run.eng_times
    if not t or not run.n_queries:
        return None
    return (t["mask"] + t["anchors"]) / run.n_queries * 1e3
