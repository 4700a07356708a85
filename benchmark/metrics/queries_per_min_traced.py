"""queries_per_min_traced: every query completed in the traced window
over the window's length, one closed-loop client (host clock).  The
quantity of queries_per_min.py, read in the --trace 1 run: the host's
pace drifts too widely from run to run for an end-to-end bound."""

from benchmark.metrics.queries_per_min import read  # noqa: F401
