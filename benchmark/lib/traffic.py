"""The one traffic generator: reads a mix (traffic/<name>.json) and yields
queries with the truth of where each one's copies lie.

A mix's keys:
  request_queries  queries a request carries (the CLI's batch is 32)
  warm_requests    requests sent before the window (never repeated in it)
  classes          [{kind, share, ...}]: a query class per entry, made by
                   queries/<kind>.py; its other keys are that class's
                   parameters (lengths, divergence)
Query i draws its class, length and divergence from rotation sequences
(the same sizes for every seed, in an order set by the seed), and its
source genome, place, strand and bases from the seed's generator.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from statistics import NormalDist

import numpy as np

from benchmark.lib.seqgen import equidistributed, to_ascii

STEP_CLASS = 0.7320508075688772  # sqrt(3) - 1
STEP_LEN = 0.6180339887498949  # golden ratio - 1
STEP_DIV = 0.41421356237309515  # sqrt(2) - 1


@dataclass
class Query:
    qid: str
    codes: np.ndarray
    kind: str
    genome: int  # the genome it was cut from
    rev: bool  # sent as the reverse complement of its source stretch
    to_source: object  # query positions -> source coordinates (vectorised)
    occurrences: list = field(default_factory=list)  # [(genome, source -> genome positions, orient)]
    expected: list = field(default_factory=list)  # genomes a search must hit

    @property
    def seq(self) -> bytes:
        return to_ascii(self.codes)


def lognormal_length(u: float, spec: dict) -> int:
    x = spec["median"] * np.exp(spec["sigma"] * NormalDist().inv_cdf(min(max(u, 1e-9), 1 - 1e-9)))
    return int(np.clip(round(x), spec["min"], spec["max"]))


def query_class(kind: str):
    return importlib.import_module(f"benchmark.queries.{kind}")


class QueryStream:
    """Queries in a fixed order for (database, mix, seed)."""

    def __init__(self, db, mix: dict, seed: int):
        self.db = db
        self.mix = mix
        self.rng = np.random.default_rng([int(seed), 2])
        self.offsets = self.rng.random(3)
        shares = np.array([c["share"] for c in mix["classes"]], dtype=np.float64)
        self.cum = np.cumsum(shares / shares.sum())
        self.makers = [query_class(c["kind"]) for c in mix["classes"]]
        self.i = 0

    def next(self) -> Query:
        i = self.i
        self.i += 1
        u_cls = equidistributed(i, self.offsets[0], STEP_CLASS)
        c = min(int(np.searchsorted(self.cum, u_cls, side="right")), len(self.cum) - 1)
        spec = self.mix["classes"][c]
        u_len = equidistributed(i, self.offsets[1], STEP_LEN)
        u_div = equidistributed(i, self.offsets[2], STEP_DIV)
        return self.makers[c].make(self.db, self.rng, spec, u_len, u_div, f"q{i}")

    def take(self, n: int) -> list:
        return [self.next() for _ in range(n)]
