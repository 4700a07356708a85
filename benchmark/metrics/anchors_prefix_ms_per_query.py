"""anchors_prefix_ms_per_query: phase 2b's prefix filter over the card's
triples (each chunk's entry ranges, reverse-flag check and LCP, in
IndexSearcher._collect_anchors) a query, from the program's counter
`anchors.prefix` over the window.  Nothing where the program has none."""


def read(run):
    t = run.eng_times.get("anchors.prefix")
    if t is None or not run.n_queries:
        return None
    return t / run.n_queries * 1e3
