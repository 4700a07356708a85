"""query_p95_ms: the 95th percentile of every request's latency in the
window, submit to formatted rows (host clock).  BENCHMARK.json lists the
cells that report it: those whose requests carry one query."""

import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s), 95)) * 1e3
