"""miraculix_tpu — genotype linear algebra on packed genotypes.

A from-scratch JAX/Pallas framework with the capabilities of
alexfreudenberg/miraculix: linear algebra directly on 2-bit-compressed
genotype matrices — dgemm_compressed ('n'/'t' with allele-frequency
centering), GRM/LD crossproducts, and GBLUP equation solving — on the GPU:
planar16 packing decoded in registers inside a Triton kernel feeding the
tensor cores, sharded across device meshes with XLA collectives.
"""
# NB: the gblup ESTIMATOR stays at miraculix_tpu.gblup.gblup — re-exporting
# the function here would shadow the submodule of the same name
from .geno import GenoMatrix, from_bed, from_dense, from_plink, load, save
from .options import Options, get_global_options, set_global_options
from .ops.dgemm import dgemm, packed_matmul
from .gwas import (GWASResult, MixedGWASResult, gwas_linear,
                   gwas_logistic, gwas_mixed, gwas_mixed_loco)
from .ops.grm import (dominance_grm, grm, grm_blocked, grm_yang,
                      ld, ld_blocked, ld_prune, ld_score, ld_windowed,
                      pairwise_nonmissing, snp_crossprod)
from .streamed import StreamedGeno
# NB: like gblup, the ssgblup SOLVER stays at miraculix_tpu.ssgblup.ssgblup
# (re-exporting the function would shadow the submodule)
from .pedigree import SparseCOO, a_inverse, a_matrix, inbreeding
from .ssgblup import SingleStepHInv

__version__ = "0.2.0"

__all__ = [
    "GenoMatrix",
    "Options",
    "StreamedGeno",
    "dgemm",
    "dominance_grm",
    "from_bed",
    "from_dense",
    "from_plink",
    "get_global_options",
    "grm",
    "grm_blocked",
    "grm_yang",
    "pairwise_nonmissing",
    "ld",
    "ld_blocked",
    "GWASResult",
    "gwas_linear",
    "gwas_logistic",
    "gwas_mixed",
    "gwas_mixed_loco",
    "MixedGWASResult",
    "ld_prune",
    "ld_score",
    "ld_windowed",
    "load",
    "packed_matmul",
    "save",
    "set_global_options",
    "snp_crossprod",
    "SparseCOO",
    "a_inverse",
    "a_matrix",
    "inbreeding",
    "SingleStepHInv",
]
