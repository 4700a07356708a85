"""anchors_suffix_ms_per_query: phase 2b's suffix range match of the
reversed k-mers, each chunk's (IndexSearcher._collect_anchors), a query,
from the program's counter `anchors.suffix` over the window.  Nothing
where the program has none."""


def read(run):
    t = run.eng_times.get("anchors.suffix")
    if t is None or not run.n_queries:
        return None
    return t / run.n_queries * 1e3
