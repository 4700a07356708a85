"""Helpers shared by the port's CLI families: `_open_out`, which
`cli_genome.py` uses, and `no_cuda`, the one refusal of a device stage
without a CUDA device; the `utils` subcommands are still to port."""

from __future__ import annotations

import sys


def _open_out(path):
    import gzip

    if not path or path == "-":
        return sys.stdout, False
    if path.endswith(".gz"):
        return gzip.open(path, "wt"), True
    return open(path, "w"), True


def no_cuda(instead: str) -> bool:
    """True, after printing why, when no CUDA device is present: a command
    asked to run a device stage on the card then exits 1 rather than fall
    back to the CPU on its own.  `instead` names the flags that run the
    command without the card."""
    import torch

    if torch.cuda.is_available():
        return False
    print(f"error: no CUDA device is available; pass --device cpu to {instead}",
          file=sys.stderr)
    return True
