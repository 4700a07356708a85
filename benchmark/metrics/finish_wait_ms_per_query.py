"""finish_wait_ms_per_query: the client thread's wait on the finish thread
(phases 5-6 of a request's last batch, IndexSearcher.search_many) a query,
from the program's span `finish_wait` over the window.  Nothing where the
program has no such span."""


def read(run):
    t = run.eng_times.get("finish_wait")
    if t is None or not run.n_queries:
        return None
    return t / run.n_queries * 1e3
