"""Double-precision results from single-precision device products.

Two layered techniques:

1. ``packed_matmul_exact`` / ``dgemm(precision='f64')`` — the RHS expands
   in base-2^7 int8 digits; each digit slice is one EXACT int8 product
   (int32 accumulation, zero rounding) and the partials recombine in host
   float64.  Total error ~1e-15 relative: true double precision.
   (Reference counterpart: the double / long-double accumulators of
   Vector.matrix.D.cc:42-229 and the CUTLASS f64 path of
   dgemm_compressed_cuda.h:111-698.)

2. ``solve.grm_cg_solve_refined`` — iterative refinement: the inner CG
   runs entirely on device in fast-f32 (bf16-split, ~1e-5 per solve),
   the outer loop computes TRUE float64 residuals through the exact
   operator and re-solves for the correction.  Each pass multiplies the
   error by the inner accuracy, so 2-3 passes reach ~1e-12 — the accuracy
   class of the reference's cuSOLVER double path (solve_cuda.cu:70-279)
   at device speed.

    python examples/exact_f64_solves.py [--snps 8192] [--indiv 1024]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import time

import numpy as np

import miraculix_tpu as mx
from miraculix_tpu import solve
from miraculix_tpu.io import bed
from miraculix_tpu.ops.dgemm import packed_matmul_exact


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--snps", type=int, default=8192)
    ap.add_argument("--indiv", type=int, default=1024)
    args = ap.parse_args()

    g = bed.simulate_genotypes(args.indiv, args.snps, seed=0)
    gm = mx.from_dense(g)
    rng = np.random.default_rng(1)

    # --- exact product -------------------------------------------------
    b = rng.standard_normal((args.snps, 8))
    t0 = time.time()
    c = packed_matmul_exact(gm.zq_n, b)[: args.indiv]
    dt = time.time() - t0
    want = g.astype(np.float64) @ b
    rel = np.abs(c - want).max() / np.abs(want).max()
    print(f"exact product: {rel:.2e} relative vs float64 oracle "
          f"({dt*1e3:.0f} ms incl. digit extraction)")

    # --- f64-grade GRM solve -------------------------------------------
    f = np.asarray(gm.freq, np.float64)
    zc = g.astype(np.float64) - 2.0 * f[None, :]
    lam = 10.0
    y = rng.standard_normal(args.indiv)
    t0 = time.time()
    x, outer, inner, relres = solve.grm_cg_solve_refined(
        gm, y, lam=lam, tol=1e-10)
    dt = time.time() - t0
    xs = np.linalg.solve(zc @ zc.T + lam * np.eye(args.indiv), y)
    err = np.abs(x - xs).max() / np.abs(xs).max()
    print(f"refined solve: {err:.2e} relative vs numpy float64 "
          f"({outer} outer / {inner} inner iterations, {dt:.2f} s)")


if __name__ == "__main__":
    main()
