"""setup_s: process start to the first timed request: imports, the CUDA
context and kernel libraries, generating the database, building its
index, opening the searcher and the warm requests (host clock)."""


def read(run):
    return run.setup_s
