"""queries_per_min: every query completed in the window over the
window's length, one closed-loop client (host clock)."""


def read(run):
    return run.n_queries / run.window_s * 60.0 if run.n_queries and run.window_s > 0 else None
