"""mask_filter_ms_per_query: phase 1's low-complexity filter (poly-base and
DUST k-mers zeroed, IndexSearcher._mask_query) a query, from the program's
span `mask.filter` over the window.  Nothing where the program has no such
span."""


def read(run):
    t = run.eng_times.get("mask.filter")
    if t is None or not run.n_queries:
        return None
    return t / run.n_queries * 1e3
