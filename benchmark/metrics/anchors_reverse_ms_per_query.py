"""anchors_reverse_ms_per_query: phase 2b's reversed-k-mer dispatch (nearest
masks and the sort, IndexSearcher._reversed_query_kmers) a query, from the
program's span `anchors.reverse` over the window.  Nothing where the
program has no such span."""


def read(run):
    t = run.eng_times.get("anchors.reverse")
    if t is None or not run.n_queries:
        return None
    return t / run.n_queries * 1e3
