"""wfa_host_ms_per_query: phase 5's host WFA (the pairs the device WFA
declined, an empty side or longer than its last bucket, and those its
kernels flagged) a query, from the program's span `wfa.host` over the
window.  Nothing where the program has no such span."""


def read(run):
    t = run.eng_times.get("wfa.host")
    if t is None or not run.n_queries:
        return None
    return t / run.n_queries * 1e3
