"""match_reverse_ms_per_query: phase 2b's reversed-k-mer dispatch on the card
(the batch's upload, launch and fetch, DeviceSearchEngine.prepare_batch) a
query, from the program's span `match.reverse` over the window.  Nothing
where the program has no such span."""


def read(run):
    t = run.eng_times.get("match.reverse")
    if t is None or not run.n_queries:
        return None
    return t / run.n_queries * 1e3
