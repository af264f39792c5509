"""GBLUP end to end: simulate -> ingest -> GRM-PCA -> BLUE/BLUP.

The rebuild of the reference's examples/gblup/calculate_gblup.jl
(simulate_population.R provides phenotypes there; here simulate_phenotypes).

    python examples/gblup_pipeline.py [--snps 50000] [--indiv 10000]
                                      [--h2 0.5] [--mesh N]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np

import miraculix_tpu as mx
from miraculix_tpu.gblup import gblup, randomized_grm_pca, simulate_phenotypes
from miraculix_tpu.io import bed


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--snps", type=int, default=20000)
    ap.add_argument("--indiv", type=int, default=4000)
    ap.add_argument("--h2", type=float, default=0.5)
    ap.add_argument("--pcs", type=int, default=10)
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard over N devices (0 = single chip)")
    args = ap.parse_args()

    geno = bed.simulate_genotypes(args.indiv, args.snps, seed=0)
    y, bv_true = simulate_phenotypes(geno, h2=args.h2, seed=1)

    if args.mesh:
        from miraculix_tpu import parallel

        g = parallel.shard_genotypes(geno, parallel.make_mesh(args.mesh))
    else:
        g = mx.from_dense(geno)

    w, _ = randomized_grm_pca(g, k=args.pcs)
    print("top GRM eigenvalues:", np.round(w[:5], 1))

    res = gblup(g, y, h2=args.h2, n_pcs=args.pcs, solver="cg")
    print(f"CG iterations: {res.cg_iterations}")
    print(f"cor(estimated BV, true BV) = "
          f"{np.corrcoef(res.g_hat, bv_true)[0, 1]:.3f}")


if __name__ == "__main__":
    main()
