"""MoBPS breeding-simulation bridge.

Reference: src/miraculix/MoBPS_R.cc:55-681 —
- ``codeOrigins`` / ``decodeOrigins``: pack (generation, sex, nr, haplotype)
  pedigree origins into one uint32 (6 + 1 + 22 + 3 bits, 1-based in/out,
  MoBPS_R.cc:86-176).
- ``computeSNPS``: reconstruct genotypes of descendants from founder
  haplotypes, per-haplotype recombination breakpoints with origin codes per
  segment, and mutation lists (MoBPS_R.cc:258-593).
- ``compute``: on-the-fly relationship matrix of selected individuals.

The population model here is an explicit dataclass graph instead of the
MoBPS nested R list; semantics match: an individual's haplotype h is the
concatenation, over segments between recombination breakpoints, of the
(recursively resolved) origin haplotypes, XOR'd with its mutation positions.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

BITS_GENE_INPUT = 6
BITS_SEX = 1
BITS_INDIVIDUALS = 22
BITS_HAPLO = 3
MAX_GENE_INPUT = 1 << BITS_GENE_INPUT
MAX_SEX = 1 << BITS_SEX
MAX_INDIVIDUALS = 1 << BITS_INDIVIDUALS
MAX_HAPLO = 1 << BITS_HAPLO


def code_origins(m: np.ndarray) -> np.ndarray:
    """Pack [n, 4] (generation, sex, nr, haplo), all 1-based, into uint32
    origin codes (reference codeOrigins, MoBPS_R.cc:128-176)."""
    m = np.asarray(m, dtype=np.int64)
    g, s, n, h = m[:, 0], m[:, 1], m[:, 2], m[:, 3]
    if ((g < 1) | (g > MAX_GENE_INPUT) | (s < 1) | (s > MAX_SEX)
            | (n < 1) | (n > MAX_INDIVIDUALS) | (h < 1) | (h > MAX_HAPLO)).any():
        raise ValueError("origin component out of bounds")
    packed = ((((((g - 1) << BITS_SEX) + (s - 1)) << BITS_INDIVIDUALS)
               + (n - 1)) << BITS_HAPLO) + (h - 1)
    return packed.astype(np.uint32)


def decode_origins(codes: np.ndarray) -> np.ndarray:
    """Inverse of :func:`code_origins` -> [n, 4] 1-based
    (reference decodeOrigins, MoBPS_R.cc:103-126)."""
    x = np.asarray(codes, dtype=np.uint32).astype(np.int64)
    h = x & (MAX_HAPLO - 1)
    x >>= BITS_HAPLO
    n = x & (MAX_INDIVIDUALS - 1)
    x >>= BITS_INDIVIDUALS
    s = x & (MAX_SEX - 1)
    x >>= BITS_SEX
    return np.stack([x + 1, s + 1, n + 1, h + 1], axis=1)


@dataclasses.dataclass
class Individual:
    """One animal: either materialized haplotypes or a recombination recipe.

    - ``haplo``: uint8 [2, snps] allele matrix (founders / stored gens).
    - ``recombi``: per haplotype h, breakpoint positions (in the unit of
      ``Population.positions``; the segment [recombi[k], recombi[k+1]) takes
      origin ``origins[h][k]``).  First breakpoint must be the chromosome
      start, last must be the end (MoBPS convention).
    - ``origins``: per haplotype h, uint32 origin codes (code_origins).
    - ``mutations``: per haplotype h, SNP indices whose allele flips.
    """

    haplo: Optional[np.ndarray] = None
    recombi: Tuple[Sequence[float], Sequence[float]] = ((), ())
    origins: Tuple[Sequence[int], Sequence[int]] = ((), ())
    mutations: Tuple[Sequence[int], Sequence[int]] = ((), ())


@dataclasses.dataclass
class Population:
    """(generation, sex, nr) -> Individual, 1-based keys like MoBPS.

    ``positions``: genetic position per SNP (breakpoints are compared
    against these; pass np.arange(snps) to use SNP indices directly).
    """

    snps: int
    individuals: Dict[Tuple[int, int, int], Individual]
    positions: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.positions is None:
            self.positions = np.arange(self.snps, dtype=np.float64)

    def get(self, gen: int, sex: int, nr: int) -> Individual:
        try:
            return self.individuals[(gen, sex, nr)]
        except KeyError:
            raise KeyError(f"no individual (gen={gen}, sex={sex}, nr={nr})")


def _resolve_haplotype(pop: Population, gen: int, sex: int, nr: int,
                       hap: int, _depth: int = 0) -> np.ndarray:
    """Allele vector [snps] for one haplotype, resolving origins recursively
    down to materialized ancestors (IcomputeSNPS walk, MoBPS_R.cc:430-581)."""
    if _depth > 64:
        raise RecursionError("origin chain too deep (cycle?)")
    ind = pop.get(gen, sex, nr)
    if ind.haplo is not None:
        return ind.haplo[hap].astype(np.uint8)
    breaks = np.asarray(ind.recombi[hap], dtype=np.float64)
    origins = np.asarray(ind.origins[hap], dtype=np.uint32)
    if len(breaks) != len(origins) + 1:
        raise ValueError("need len(recombi) == len(origins) + 1")
    out = np.zeros(pop.snps, dtype=np.uint8)
    pos = pop.positions
    for k in range(len(origins)):
        sel = (pos >= breaks[k]) & (pos < breaks[k + 1])
        if not sel.any():
            continue
        og, os_, on, oh = decode_origins(origins[k: k + 1])[0]
        src = _resolve_haplotype(pop, int(og), int(os_), int(on),
                                 int(oh) - 1, _depth + 1)
        out[sel] = src[sel]
    mut = np.asarray(ind.mutations[hap], dtype=np.int64)
    if mut.size:
        out[mut] ^= 1  # mutation flips the allele
    return out


def compute_snps(
    pop: Population,
    generation: Sequence[int],
    sex: Sequence[int],
    nr: Sequence[int],
    from_snp: int = 0,
    to_snp: Optional[int] = None,
) -> np.ndarray:
    """Genotype matrix [len(selection), snps_window] of the selected
    individuals: allele sums of both reconstructed haplotypes
    (reference computeSNPS, MoBPS_R.cc:595-681)."""
    to_snp = pop.snps if to_snp is None else to_snp
    rows = []
    for g, s, n in zip(generation, sex, nr):
        h0 = _resolve_haplotype(pop, int(g), int(s), int(n), 0)
        h1 = _resolve_haplotype(pop, int(g), int(s), int(n), 1)
        rows.append((h0 + h1)[from_snp:to_snp])
    return np.stack(rows).astype(np.uint8)


def compute_relationship(
    pop: Population,
    generation: Sequence[int],
    sex: Sequence[int],
    nr: Sequence[int],
    scale: bool = True,
):
    """On-the-fly relationship matrix of selected individuals (reference
    ``compute``, MoBPS_R.cc): reconstruct genotypes, pack, run the packed GRM."""
    from . import from_dense, grm

    geno = compute_snps(pop, generation, sex, nr)
    return grm(from_dense(geno), scale=scale)
