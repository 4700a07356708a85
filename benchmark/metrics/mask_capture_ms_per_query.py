"""mask_capture_ms_per_query: phase 1's capture (the query's k-mer arrays
and the native capture, IndexSearcher._mask_query) a query, from the
program's span `mask.capture` over the window.  Nothing where the program
has no such span."""


def read(run):
    t = run.eng_times.get("mask.capture")
    if t is None or not run.n_queries:
        return None
    return t / run.n_queries * 1e3
