"""kernel_us_per_query: every CUDA kernel's device time in the traced
window (torch.profiler's device rows, copies and memsets left out) a
query.  Nothing when the trace holds no kernel."""


def read(run):
    tr = run.trace
    if tr is None or not run.n_queries:
        return None
    w0, w1 = tr.window
    ks = [(s, e) for _, s, e in tr.kernels() if e > w0 and s < w1]
    if not ks:
        return None
    return sum(min(e, w1) - max(s, w0) for s, e in ks) / run.n_queries
