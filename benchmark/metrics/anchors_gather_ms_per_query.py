"""anchors_gather_ms_per_query: phase 2b's posting gather and grouping into
Anchors (IndexSearcher._collect_anchors) a query, from the program's span
`anchors.gather` over the window.  Nothing where the program has no such
span."""


def read(run):
    t = run.eng_times.get("anchors.gather")
    if t is None or not run.n_queries:
        return None
    return t / run.n_queries * 1e3
