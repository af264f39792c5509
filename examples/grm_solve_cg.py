"""Conjugate-gradient solve on the GRM using only dgemm_compressed —
the rebuild of the reference's examples/iterative_solver/
grm_solve_cg.jl, with the loop fully on-device (their stated wish:
"A further boost ... if the whole PCG is transferred to the GPU",
src/cuda/dgemm_compressed_cuda.cu:251-253).

    python examples/grm_solve_cg.py [--snps 50000] [--indiv 10000]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import time

import numpy as np

import miraculix_tpu as mx
from miraculix_tpu.io import bed
from miraculix_tpu.solve.cg import grm_cg_solve


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--snps", type=int, default=20000)
    ap.add_argument("--indiv", type=int, default=4000)
    ap.add_argument("--lam", type=float, default=100.0)
    args = ap.parse_args()

    geno = bed.simulate_genotypes(args.indiv, args.snps, seed=0)
    gm = mx.from_dense(geno)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(args.indiv).astype(np.float32)

    t0 = time.time()
    res = grm_cg_solve(gm, b, lam=args.lam, tol=1e-4, maxiter=2000)
    x = np.asarray(res.x)
    dt = time.time() - t0
    print(f"CG converged in {int(res.iterations)} iterations, {dt:.2f}s "
          f"(residual {float(res.residual_norm.max()):.2e})")


if __name__ == "__main__":
    main()
