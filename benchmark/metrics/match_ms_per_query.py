"""match_ms_per_query: phase 2a (seed matching on the card, B1 and B4
with their host parts) a query, from the engine's phase timer."""


def read(run):
    t = run.eng_times
    if not t or not run.n_queries:
        return None
    return t["match"] / run.n_queries * 1e3
