"""Database generator `clades`: species of random ancestral genomes, each
present as one or more strains mutated from its ancestor, optionally
with copies of a species-specific rRNA-like gene planted in every genome.

A configuration's keys (see configs/*.json):
  species           [[n_species, strains_each], ...] (their total, `genomes`)
  genome_bp         [lo, hi]: ancestor lengths, spread evenly over the range
  strain_substitution, strain_indel   [lo, hi] rates of a strain from its
                    ancestor (a species of one strain is its ancestor)
  rrna              null, or {length, species_divergence [lo, hi],
                    copies [lo, hi]}: one universal ancestral gene, a variant
                    per species (substitutions only), and that many
                    identical copies of it in each genome of the species,
                    on either strand; strain mutations never touch them
The sizes (lengths, rates, copy counts) are the same set for every seed;
the seed orders them and draws every base.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from benchmark.lib.seqgen import PosMap, mutate, random_codes, revcomp, stratified, substitute


@dataclass
class Genome:
    name: str
    codes: np.ndarray
    species: int
    smap: PosMap  # ancestor -> this genome
    rrna: list = field(default_factory=list)  # [(start, orient)] copies of the species' variant


@dataclass
class Species:
    ancestor_len: int
    strains: list  # genome indices
    rrna_variant: np.ndarray | None = None


@dataclass
class Database:
    genomes: list
    species: list
    rrna_len: int = 0

    @property
    def bases(self) -> int:
        return sum(g.codes.shape[0] for g in self.genomes)


def _spread(rng, n: int, lo_hi) -> np.ndarray:
    lo, hi = lo_hi
    return rng.permutation(stratified(n, float(lo), float(hi)))


def generate(cfg: dict, seed: int) -> Database:
    rng = np.random.default_rng([int(seed), 1])
    strains_of = [int(s) for n, s in cfg["species"] for _ in range(int(n))]
    if "genomes" in cfg and cfg["genomes"] != sum(strains_of):
        raise ValueError(f"{cfg['name']}: species hold {sum(strains_of)} genomes, "
                         f"not {cfg['genomes']}")
    n_sp = len(strains_of)
    anc_len = np.rint(_spread(rng, n_sp, cfg["genome_bp"])).astype(np.int64)
    n_mutants = sum(s for s in strains_of if s > 1)
    sub_rates = list(_spread(rng, n_mutants, cfg.get("strain_substitution", [0, 0])))
    indel_rates = list(_spread(rng, n_mutants, cfg.get("strain_indel", [0, 0])))

    rr = cfg.get("rrna")
    rr_len = int(rr["length"]) if rr else 0
    if rr:
        rr_anc = random_codes(rng, rr_len)
        rr_div = _spread(rng, n_sp, rr["species_divergence"])
        lo, hi = rr["copies"]
        rr_copies = rng.permutation(np.resize(np.arange(int(lo), int(hi) + 1), n_sp))

    genomes, species = [], []
    for s, n_strains in enumerate(strains_of):
        anc = random_codes(rng, int(anc_len[s]))
        sp = Species(ancestor_len=anc.shape[0], strains=[])
        protect = None
        anc_copies = []
        if rr:
            sp.rrna_variant = substitute(rng, rr_anc, float(rr_div[s]))
            anc_copies = _plant(rng, anc, sp.rrna_variant, int(rr_copies[s]))
            protect = np.ones(anc.shape[0], dtype=bool)
            for c0, _ in anc_copies:
                protect[max(c0 - 4, 0): c0 + rr_len + 4] = False
        for _ in range(n_strains):
            if n_strains == 1:
                codes, smap = anc, PosMap.identity(anc.shape[0])
            else:
                codes, smap = mutate(rng, anc, float(sub_rates.pop()), float(indel_rates.pop()),
                                     allowed=protect)
            copies = [(int(smap.fwd(c0)), o) for c0, o in anc_copies]
            gi = len(genomes)
            genomes.append(Genome(name=f"g{gi:03d}", codes=codes, species=s, smap=smap,
                                  rrna=copies))
            sp.strains.append(gi)
        species.append(sp)
    return Database(genomes=genomes, species=species, rrna_len=rr_len)


def _plant(rng, anc: np.ndarray, gene: np.ndarray, n: int) -> list:
    """Overwrite n non-overlapping stretches of anc with gene (or its
    reverse complement); returns [(start, orient)] sorted by start."""
    L = gene.shape[0]
    slots = anc.shape[0] // (L + 100)
    starts = np.sort(rng.choice(slots, size=n, replace=False)) * (L + 100) + 50
    out = []
    for c0 in starts.tolist():
        o = 1 if rng.random() < 0.5 else -1
        anc[c0: c0 + L] = gene if o > 0 else revcomp(gene)
        out.append((c0, o))
    return out
