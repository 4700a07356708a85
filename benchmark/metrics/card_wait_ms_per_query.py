"""card_wait_ms_per_query: the host's waits on the card (every fetch of the
search path, parallel.fetch_numpy) a query, from the program's span
`card_wait` over the window.  Nothing where the program has no such span."""


def read(run):
    t = run.eng_times.get("card_wait")
    if t is None or not run.n_queries:
        return None
    return t / run.n_queries * 1e3
