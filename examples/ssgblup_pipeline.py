"""Single-step GBLUP end to end: pedigree + partial genotyping + phenotypes
on a subset — the evaluation MiXBLUP runs with the reference's sparse-solve
and packed-GEMM engines (solve_cuda.cu / mod5codesapi.f90), composed here
into one matrix-free device solve.

Run from the repo root:  python examples/ssgblup_pipeline.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import miraculix_tpu as mx
from miraculix_tpu import pedigree as ped
from miraculix_tpu import ssgblup as ss
from miraculix_tpu.io import bed

# env knobs so the test suite can smoke-run this at tiny shapes
N_ANIM = int(os.environ.get("MX_EX_ANIM", 2000))
N_GENO = int(os.environ.get("MX_EX_GENO", 600))
N_SNPS = int(os.environ.get("MX_EX_SNPS", 20_000))
H2 = 0.4

rng = np.random.default_rng(1)
print(f"pedigree: {N_ANIM} animals, {N_GENO} genotyped, {N_SNPS} SNPs")
sire, dam = ped.simulate_pedigree(N_ANIM, n_founders=80, seed=4)
f = ped.inbreeding(sire, dam)
print(f"inbreeding: mean F = {f.mean():.4f}, max F = {f.max():.4f}")

# genotype the youngest animals (selection candidates), phenotype the rest
geno_ids = np.arange(N_ANIM - N_GENO, N_ANIM) + 1
geno = bed.simulate_genotypes(N_GENO, N_SNPS, seed=11)
gm = mx.from_dense(geno)

obs_ids = np.arange(1, N_ANIM - N_GENO + 1)          # older, phenotyped
u_true = rng.standard_normal(N_ANIM)                  # toy breeding values
y = 2.0 + u_true[obs_ids - 1] + rng.standard_normal(len(obs_ids))

hinv = ss.SingleStepHInv(sire, dam, gm, geno_ids, blend=0.05)
res = ss.ssgblup(y, hinv, obs_ids=obs_ids, h2=H2, tol=1e-5)
print(f"outer CG iterations: {res.iterations}  "
      f"residual: {res.residual_norm:.2e}")
print(f"intercept estimate: {res.beta[0]:.3f} (true 2.0)")

# the point of single-step: UNphenotyped, genotyped candidates get
# genomically-informed EBVs; compare to the pedigree-only fit
lam = (1 - H2) / H2
a = ped.a_matrix(sire, dam)
w = np.zeros((len(y), N_ANIM))
w[np.arange(len(y)), obs_ids - 1] = 1.0
x = np.ones((len(y), 1))
mme = np.vstack([
    np.column_stack([x.T @ x, x.T @ w]),
    np.column_stack([w.T @ x, w.T @ w + lam * np.linalg.inv(a)]),
])
u_ped = np.linalg.solve(mme, np.concatenate([x.T @ y, w.T @ y]))[1:]

cand = geno_ids - 1
print(f"candidate EBV shift (ssGBLUP vs pedigree BLUP): "
      f"mean |delta| = {np.abs(res.u[cand] - u_ped[cand]).mean():.4f}")
print("ssGBLUP done")
