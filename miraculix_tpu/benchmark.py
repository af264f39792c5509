"""Benchmark suite: panels x ops, comparator baselines, roofline reporting.

Rebuild of the reference's benchmark harnesses
(utils/benchmark/benchmark_suite.jl:39-273 — GRM/LD suites vs PLINK 1.9,
GCTA, cuBLAS uint8; utils/benchmark/benchmark.f90:150-296 — dgemm sweeps vs
MKL).  External binaries (PLINK/GCTA) are not available here; the comparator
is the dense-XLA path (decode the panel to f32 and run a plain jnp matmul) —
the exact role the cuBLAS-uint8 comparator plays in the reference
(utils/benchmark/cublas_uint8.cu).

Timing: N iterations inside one jit via lax.scan with a real data dependence,
host-transfer sync, iters=1 vs iters=N+1 differencing.

Run:  python -m miraculix_tpu.benchmark [--suite dgemm|grm|scaling|all]
Emits one JSON object per config on stdout.
"""
from __future__ import annotations

import argparse
import functools
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from .utils.peaks import device_peaks

# Panel definitions scaled from the reference's simulated panels
# (utils/genotype_simulation_plink/Makefile:1-9), sized to one card.
PANELS: Dict[str, Dict[str, int]] = {
    "xsmall": dict(snps=16384, indiv=2048),
    "small": dict(snps=65536, indiv=4096),
    "medium": dict(snps=262144, indiv=4096),
    "many_snps": dict(snps=1048576, indiv=2048),
    "many_indiv": dict(snps=65536, indiv=16384),
}



def _interleaved_per_iter(run_base: Callable, run_full: Callable,
                          iters: int, reps: int = 5,
                          stats: dict = None) -> float:
    """Differenced per-iteration time from INTERLEAVED (full, base) pairs.

    Device speed can drift between calls, so the two halves of one
    difference must be adjacent in time (the bench.py protocol).  The
    MEDIAN of the pairwise differences is used: min is optimistically
    biased when per-call noise rivals the differenced signal.  When the
    problem is below the noise floor entirely (median <= 0), fall back to
    the full-run upper bound.

    ``stats`` (optional dict) receives the measurement's error bars:
    ``spread_pct`` = interquartile range of the pairwise estimates as a
    percentage of the median, and ``n_pairs``.
    """
    import statistics

    diffs, best_full = [], float("inf")
    for _ in range(reps):
        t0 = time.time()
        run_full()
        tf = time.time() - t0
        t0 = time.time()
        run_base()
        diffs.append(tf - (time.time() - t0))
        best_full = min(best_full, tf)
    per = statistics.median(diffs) / iters
    if stats is not None and per > 0:
        d = sorted(x / iters for x in diffs)
        q1, q3 = d[len(d) // 4], d[(3 * len(d)) // 4]
        stats["spread_pct"] = round(100.0 * (q3 - q1) / per, 1)
        stats["n_pairs"] = len(d)
    if per <= 0:
        per = best_full / (iters + 1)
        if stats is not None:
            stats["spread_pct"] = None
            stats["n_pairs"] = len(diffs)
    return per


def _timed_scan_zq(fn: Callable, zq, iters: int,
                   stats: dict = None) -> float:
    """Device time per iteration of fn(zq) with the packed matrix as the
    scan carry (one-element in-place XOR = real data dependence that XLA
    cannot hoist, ~O(1) cost)."""
    import jax
    import jax.numpy as jnp

    def mk(nit):
        @jax.jit
        def many(zq):
            def body(z, _):
                out = fn(z)
                s = (out[0, 0].astype(jnp.int32) >> 31).astype(jnp.uint32)
                return z.at[0, 0].set(z[0, 0] ^ s), None
            zf, _ = jax.lax.scan(body, zq, None, length=nit)
            return jnp.float32(zf[0, 0] & jnp.uint32(1))
        return many

    f1, fn_n = mk(1), mk(iters + 1)
    float(f1(zq))
    float(fn_n(zq))
    return _interleaved_per_iter(lambda: float(f1(zq)),
                                 lambda: float(fn_n(zq)), iters,
                                 stats=stats)


def _timed_scan_b(fn: Callable, zq, b, iters: int,
                  stats: dict = None) -> float:
    """Like _timed_scan_zq but with the RHS as carry (dgemm-style)."""
    import jax
    import jax.numpy as jnp

    def mk(nit):
        @jax.jit
        def many(zq, b):
            def body(bc, _):
                out = fn(zq, bc)
                return bc * (1 + out[0, 0] * 1e-30), None
            bf, _ = jax.lax.scan(body, b, None, length=nit)
            return jnp.float32(bf[0, 0])
        return many

    f1, fn_n = mk(1), mk(iters + 1)
    float(f1(zq, b))
    float(fn_n(zq, b))
    return _interleaved_per_iter(lambda: float(f1(zq, b)),
                                 lambda: float(fn_n(zq, b)), iters,
                                 stats=stats)


def bench_dgemm(panel: str, ncol: int = 32, iters: int = 64,
                comparator: bool = False) -> dict:
    """Centered dgemm_compressed 'n' on one card, with roofline ratios."""
    import jax.numpy as jnp

    from .geno import from_dense
    from .io import bed
    from .ops.dgemm import dgemm

    p = PANELS[panel]
    snps, indiv = p["snps"], p["indiv"]
    g = bed.simulate_genotypes(indiv, snps, seed=0)
    gm = from_dense(g)
    zq = gm.zq_n
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal((snps, ncol)), jnp.float32)

    peaks = device_peaks()
    stats = {}
    per = _timed_scan_b(
        lambda gmx, bc: dgemm(gmx, bc, trans="n", center=True), gm, b, iters,
        stats=stats)
    geno_ops = snps * indiv * ncol / per
    # useful tensor-core work: 2 flops x 2 (hi/lo split) per
    # genotype-column op
    tc_flops = 4.0 * indiv * snps * ncol / per
    hbm_bytes = (zq.nbytes + b.nbytes * 4 + indiv * ncol * 4) / per
    out = {
        "suite": "dgemm",
        "panel": panel,
        "config": f"{snps}x{indiv} ncol={ncol} centered 'n'",
        "seconds_per_call": round(per, 6),
        "geno_col_ops_per_s": geno_ops,
        "bf16_peak_share": round(tc_flops / peaks["bf16_flops"], 3),
        "hbm_peak_share": round(hbm_bytes / peaks["hbm_bytes_per_s"], 3),
        **stats,
    }
    if tc_flops > peaks["bf16_flops"]:
        # above the physical roofline = measurement error, not throughput
        out["roofline_warning"] = True
    if comparator:
        if g.size * 4 > 4e9:  # dense f32 panel would exhaust HBM
            out["comparator_dense_xla_s"] = None
        else:
            dense = jnp.asarray(np.where(g == 3, 0, g), jnp.float32)

            def dense_step(d, bc):
                return d @ bc

            per_dense = _timed_scan_b(dense_step, dense, b,
                                      max(2, iters // 4))
            out["comparator_dense_xla_s"] = round(per_dense, 6)
            out["speedup_vs_dense"] = round(per_dense / per, 2)
    return out


def bench_dgemm_exact(panel: str = "small", ncol: int = 8,
                      reps: int = 5) -> dict:
    """The exact f64 tier (integer-digit / Ozaki path): WALL time per call
    including host digit extraction and f64 recombination — the tier is
    host-orchestrated by design, so the interleaved on-device protocol does
    not apply; the median of ``reps`` wall clocks is reported, with the
    f32-HIGHEST tier's wall for context (the tier the exact path replaced
    as the accuracy ceiling)."""
    import statistics

    import jax.numpy as jnp

    from .geno import from_dense
    from .io import bed
    from .ops.dgemm import dgemm, packed_matmul_exact

    p = PANELS[panel]
    snps, indiv = p["snps"], p["indiv"]
    g = bed.simulate_genotypes(indiv, snps, seed=0)
    gm = from_dense(g)
    rng = np.random.default_rng(0)
    b = rng.standard_normal((snps, ncol))

    def wall(fn):
        fn()  # warm (compile + caches)
        ts = []
        for _ in range(reps):
            t0 = time.time()
            fn()
            ts.append(time.time() - t0)
        return statistics.median(ts)

    per = wall(lambda: packed_matmul_exact(gm.zq_n, b))
    b32 = jnp.asarray(b, jnp.float32)
    per_f32 = wall(lambda: np.asarray(
        dgemm(gm, b32, trans="n", center=False, precision="f32")))
    geno_ops = snps * indiv * ncol
    return {
        "suite": "dgemm_exact",
        "panel": panel,
        "config": f"{snps}x{indiv} ncol={ncol} exact-f64 (8 int8 digit "
                  "passes, host recombine)",
        "wall_seconds_per_call": round(per, 4),
        "geno_col_ops_per_s": geno_ops / per,
        "f32_highest_wall_s": round(per_f32, 4),
        "slowdown_vs_f32_tier": round(per / max(per_f32, 1e-12), 2),
        "relative_error_grade": "~1e-15 (vs ~1e-7 for f32-HIGHEST)",
    }


def bench_solve_refined(panel: str = "small", reps: int = 3) -> dict:
    """f64-grade GRM solve by iterative refinement (grm_cg_solve_refined):
    WALL time per solve (host-orchestrated outer loop around the on-device
    CG), with the plain f32 CG wall for context and the achieved true-f64
    relative residual."""
    import statistics

    from .geno import from_dense
    from .io import bed
    from .solve.cg import grm_cg_solve, grm_cg_solve_refined

    p = PANELS[panel]
    snps, indiv = p["snps"], p["indiv"]
    g = bed.simulate_genotypes(indiv, snps, seed=0)
    gm = from_dense(g)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(indiv)
    lam = 100.0

    def wall(fn):
        fn()  # warm (compile + caches)
        ts = []
        for _ in range(reps):
            t0 = time.time()
            fn()
            ts.append(time.time() - t0)
        return statistics.median(ts)

    state = {}

    def refined():
        x, outer, inner, rel = grm_cg_solve_refined(
            gm, b, lam=lam, tol=1e-10)
        state.update(outer=outer, inner=inner, rel=float(rel.max()))

    per = wall(refined)
    per_f32 = wall(lambda: np.asarray(grm_cg_solve(
        gm, np.asarray(b, np.float32), lam=lam, tol=1e-4).x))
    return {
        "suite": "solve_refined",
        "panel": panel,
        "config": f"{snps}x{indiv} (G + {lam} I) x = b, tol 1e-10",
        "wall_seconds_per_solve": round(per, 4),
        "outer_iters": state.get("outer"),
        "inner_iters": state.get("inner"),
        "true_f64_rel_residual": state.get("rel"),
        "f32_cg_wall_s": round(per_f32, 4),
        "slowdown_vs_f32_cg": round(per / max(per_f32, 1e-12), 2),
    }


def bench_gwas(panel: str = "medium", reps: int = 3) -> dict:
    """Whole-panel GWAS linear scan WALL time (3 packed passes + host
    epilogue) — the per-SNP cost the reference's users pay in external
    tools after exporting."""
    import statistics

    from .gblup import simulate_phenotypes
    from .geno import from_dense
    from .gwas import gwas_linear
    from .io import bed

    p = PANELS[panel]
    snps, indiv = p["snps"], p["indiv"]
    g = bed.simulate_genotypes(indiv, snps, seed=0)
    gm = from_dense(g)
    y, _ = simulate_phenotypes(g, h2=0.5, seed=1)
    cov = np.random.default_rng(2).standard_normal((indiv, 3))

    def wall():
        t0 = time.time()
        gwas_linear(gm, y, covariates=cov)
        return time.time() - t0

    wall()  # warm
    per = statistics.median(wall() for _ in range(reps))
    return {
        "suite": "gwas",
        "panel": panel,
        "config": f"{snps}x{indiv} linear scan, 3 covariates",
        "wall_seconds_per_scan": round(per, 4),
        "snps_per_s": snps / per,
    }


def bench_grm(panel: str, iters: int = 8, comparator: bool = False) -> dict:
    """Raw integer crossproduct (GRM direction) throughput."""
    import jax.numpy as jnp

    from .io import bed, codec
    from .ops.grm import packed_crossprod

    p = PANELS[panel]
    snps, indiv = p["snps"], p["indiv"]
    g = bed.simulate_genotypes(indiv, snps, seed=0)
    zq = jnp.asarray(codec.pack_planar16(g, row_mult=512))

    peak = device_peaks()["int8_ops"]
    stats = {}
    per = _timed_scan_zq(lambda z: packed_crossprod(z), zq, iters,
                         stats=stats)
    full_ops = 2.0 * indiv * indiv * snps
    out = {
        "suite": "grm",
        "panel": panel,
        "config": f"{snps}x{indiv} ZZ^T int8",
        "seconds_per_call": round(per, 6),
        "snp_indiv2_ops_per_s": full_ops / per,
        "int8_peak_share": round(full_ops / per / peak, 3),
        "snps_per_s": round(snps / per, 1),
        **stats,
    }
    if full_ops / per > peak:
        out["roofline_warning"] = True
    if comparator and g.size * 4 <= 4e9:
        # same interleaved-median protocol as every other row
        import jax

        dense = jnp.asarray(np.where(g == 3, 0, g), jnp.float32)

        def mk(nit):
            @jax.jit
            def many(d):
                def body(dc, _):
                    m = dc @ dc.T
                    # feed the result back so XLA cannot hoist the matmul
                    return dc * (1 + m[0, 0] * 1e-30), None
                df, _ = jax.lax.scan(body, d, None, length=nit)
                return jnp.float32(df[0, 0])
            return many

        cmp_iters = max(2, iters // 2)
        f1, fn_n = mk(1), mk(cmp_iters + 1)
        float(f1(dense))
        float(fn_n(dense))
        out["comparator_dense_xla_s"] = round(_interleaved_per_iter(
            lambda: float(f1(dense)), lambda: float(fn_n(dense)),
            cmp_iters), 6)
        out["speedup_vs_dense"] = round(
            out["comparator_dense_xla_s"] / per, 2)
    return out


def bench_grm_ref_panel(iters: int = 2) -> dict:
    """The reference's flagship GRM benchmark: 1M SNPs x 21,000 individuals
    (utils/genotype_simulation_plink/Makefile:1-9, benchmarked there against
    PLINK --make-rel / GCTA).  Genotypes are generated as packed words
    on the device, with the real row count 21,248 zero-padded to 21,504,
    and the timed op is ONE production `packed_crossprod` call."""
    import jax
    import jax.numpy as jnp

    from .ops.grm import packed_crossprod

    rows, rows_pad, kw = 21248, 21504, 65536       # 16*65536 = 1,048,576
    chunk = 4096
    full_ops = 2.0 * rows * rows * 16 * kw

    @jax.jit
    def build(key):
        buf = jnp.zeros((rows_pad, kw), jnp.int32)

        def body(i, carry):
            key, buf = carry
            key, sub = jax.random.split(key)
            r = jax.random.bits(sub, (rows, chunk), jnp.uint32).astype(
                jnp.int32)
            a = r & 0x55555555
            b = (r >> 1) & 0x55555555
            words = ((b & ~a) << 1) | (a & ~b)     # 2-bit fields in {0,1,2}
            return key, jax.lax.dynamic_update_slice(buf, words,
                                                     (0, i * chunk))
        _, buf = jax.lax.fori_loop(0, kw // chunk, body,
                                   (jax.random.PRNGKey(0), buf))
        return buf

    zq = build(jax.random.PRNGKey(0))
    zq.block_until_ready()

    def mk(nit):
        @jax.jit
        def many(zq):
            def body(z, _):
                out = packed_crossprod(z)
                s = (out[0, 0].astype(jnp.int32) >> 31).astype(jnp.uint32)
                z = z.at[0, 0].set(
                    (z[0, 0].astype(jnp.uint32) ^ s).astype(jnp.int32))
                return z, None
            zf, _ = jax.lax.scan(body, zq, None, length=nit)
            return jnp.float32(zf[0, 0] & 1)
        return many

    peak = device_peaks()["int8_ops"]
    f1, fn_n = mk(1), mk(iters + 1)
    float(f1(zq))
    float(fn_n(zq))
    stats = {}
    per = _interleaved_per_iter(lambda: float(f1(zq)),
                                lambda: float(fn_n(zq)), iters, stats=stats)
    out = {
        "suite": "grm",
        "panel": "ref_many_snps",
        "config": f"{16 * kw}x{rows} ZZ^T int8 (padded {rows_pad}), "
                  "single-call K grid, on-device gen",
        "seconds_per_call": round(per, 3),
        "snp_indiv2_ops_per_s": full_ops / per,
        "int8_peak_share": round(full_ops / per / peak, 3),
        **stats,
    }
    if full_ops / per > peak:
        out["roofline_warning"] = True
    return out


def bench_ld(panel: str, iters: int = 4) -> dict:
    """Full LD pipeline (crossproduct + centering + sigma-normalize), the
    reference's LD suite role (benchmark_suite.jl:40, vs plink --r).  Only
    panels whose [snps, snps] f32 output fits HBM are meaningful single-card
    (larger SNP counts go through ops.grm.ld_blocked out-of-core)."""
    import jax
    import jax.numpy as jnp

    from .geno import GenoMatrix, from_dense
    from .io import bed
    from .ops.grm import ld

    p = PANELS[panel]
    snps, indiv = p["snps"], p["indiv"]
    if snps * snps * 4 > 8e9:
        return {"suite": "ld", "panel": panel,
                "skipped": "snps^2 f32 output exceeds one card's HBM; "
                           "use ops.grm.ld_blocked"}
    g = bed.simulate_genotypes(indiv, snps, seed=0)
    gm = from_dense(g)

    def mk(nit):
        @jax.jit
        def many(gmx):
            # the carry must feed the OP'S INPUT (zq-XOR pattern,
            # CLAUDE.md invariant) — a carry built only from the output
            # leaves ld() loop-invariant and XLA hoists it out of the scan
            def body(z, _):
                zt = gmx.zq_t.at[0, 0].set(gmx.zq_t[0, 0] ^ z)
                g2 = GenoMatrix(gmx.snps, gmx.indiv, gmx.zq_n, zt,
                                gmx.freq)
                m = ld(g2)
                return z ^ (jnp.abs(m[0, 1]) * 1e-30).astype(jnp.uint32), \
                    None
            zf, _ = jax.lax.scan(body, jnp.uint32(0), None, length=nit)
            return zf
        return many

    f1, fn_n = mk(1), mk(iters + 1)
    float(f1(gm))
    float(fn_n(gm))
    per = _interleaved_per_iter(lambda: float(f1(gm)),
                                lambda: float(fn_n(gm)), iters)
    return {
        "suite": "ld",
        "panel": panel,
        "config": f"{snps}x{indiv} LD r (centered, normalized)",
        "seconds_per_call": round(per, 6),
        "snp_pairs_per_s": snps * snps / per,
    }


def bench_sparse_solve(n: int = 1_000_000, avg_offdiag: int = 9,
                       ncol: int = 12, iters: int = 4) -> dict:
    """Sparse triangular L Lᵀ x = B solve throughput — the reference's
    sparse-solve benchmark (utils/benchmark/sparse_solve.jl: cuSPARSE SpSM
    vs Pardiso on a Cholesky COO factor, ncol=12).  The factor is a
    simulated pedigree-shaped lower triangle (~``avg_offdiag`` off-diagonal
    entries per row); the solver is the blocked O(nnz) substitution."""
    import jax
    import jax.numpy as jnp

    from .solve.sparse import SparseTriangularSolver, simulate_pedigree_factor

    r, c, v = simulate_pedigree_factor(n, avg_offdiag=avg_offdiag,
                                       bandwidth=max(n // 16, 1), seed=0)
    t0 = time.time()
    slv = SparseTriangularSolver(r, c, v, n, dtype=jnp.float32)
    init_s = time.time() - t0
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal((n, ncol)), jnp.float32)

    def mk(nit):
        # the solver rides through jit as a PYTREE ARGUMENT — closing over
        # it embedded the 2 GB analysis buffers as HLO constants
        @jax.jit
        def many(s, b):
            def body(bc, _):
                x = s.solve_lltx(bc)
                return bc * (1 + x[0, 0] * 1e-30), None
            bf, _ = jax.lax.scan(body, b, None, length=nit)
            return jnp.float32(bf[0, 0])
        return many

    f1, fn_n = mk(1), mk(iters + 1)
    float(f1(slv, b))
    float(fn_n(slv, b))
    per = _interleaved_per_iter(lambda: float(f1(slv, b)),
                                lambda: float(fn_n(slv, b)), iters)
    # honesty check: O(nnz) residual of the last solve
    x = slv.solve_lltx(b)
    resid = float(jnp.linalg.norm(slv.matvec(slv.matvec(x, trans="t")) - b)
                  / jnp.linalg.norm(b))
    # f64-grade mixed-precision refinement (reference parity: cuSPARSE
    # solves in true f64, solve_cuda.cu:281-882) — exact host residuals +
    # device substitutions until <=1e-12 relative
    t0 = time.time()
    _, rel64 = slv.solve_lltx_f64(np.asarray(b, np.float64), tol=1e-12)
    f64_s = time.time() - t0
    return {
        "suite": "sparse_solve",
        "config": f"LL^T x=B, n={n}, nnz={slv.nnz}, ncol={ncol}, "
                  f"bs={slv.bs}, f32",
        "init_analysis_s": round(init_s, 3),
        "seconds_per_solve": round(per, 6),
        "nnz_per_s": round(2 * slv.nnz * ncol / per, 1),
        "rel_residual": resid,
        "f64_grade_rel_residual": rel64,
        "f64_grade_seconds": round(f64_s, 3),
    }


def bench_ssgblup(n_anim: int = 200_000, n_geno: int = 20_000,
                  snps: int = 65_536, reps: int = 3) -> dict:
    """Single-step GBLUP at production pedigree scale: WALL time of the
    one-XLA-program MME solve (nested while_loop CGs — see docs/design.md
    §12) plus the host-side init splits (A^-1 build, inbreeding).  The
    reference ecosystem runs this workload as MiXBLUP calling the sparse
    solver + packed GEMM; here it is one framework call."""
    import statistics

    from .geno import from_dense
    from .io import bed
    from . import pedigree as ped
    from . import ssgblup as ssb

    t0 = time.time()
    sire, dam = ped.simulate_pedigree(n_anim, n_founders=n_anim // 100,
                                      seed=3)
    t_ped = time.time() - t0
    geno_ids = np.arange(n_anim - n_geno, n_anim) + 1
    g = bed.simulate_genotypes(n_geno, snps, seed=11)
    gm = from_dense(g)
    rng = np.random.default_rng(1)
    obs_ids = np.arange(1, n_anim - n_geno + 1)
    y = 2.0 + rng.standard_normal(len(obs_ids))

    # deep random pedigrees make exact Meuwissen-Luo ancestor sets explode
    # (docs/design.md §12); production benchmarking uses classical rules
    t0 = time.time()
    hinv = ssb.SingleStepHInv(sire, dam, gm, geno_ids, blend=0.05,
                              f=np.zeros(n_anim))
    t_init = time.time() - t0

    state = {}

    def solve():
        r = ssb.ssgblup(y, hinv, obs_ids=obs_ids, h2=0.4, tol=1e-5,
                        maxiter=500)
        state.update(iters=r.iterations, resid=r.residual_norm)

    solve()  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.time()
        solve()
        ts.append(time.time() - t0)
    return {
        "suite": "ssgblup",
        "config": f"{n_anim} animals, {n_geno} genotyped x {snps} SNPs, "
                  f"phenotypes on the non-genotyped",
        "wall_seconds_per_solve": round(statistics.median(ts), 3),
        "outer_cg_iterations": state.get("iters"),
        "residual": state.get("resid"),
        "init_seconds": round(t_init, 2),
        "pedigree_sim_seconds": round(t_ped, 2),
    }


def bench_gblup_fullscale(snps: int = 1_048_576, indiv: int = 100_096,
                          chunks: int = 16, h2: float = 0.5,
                          tol: float = 1e-3, maxiter: int = 60) -> dict:
    """BASELINE config 5 at full scale: GBLUP CG on ~1M SNPs x 100K
    individuals, ENTIRELY on one card.

    The packed panel (2 x 25 GB for both orientations) exceeds HBM, so the
    SNP axis is chunked and each chunk's packed words are REGENERATED
    on-device from a counter-based hash whenever the matvec touches them —
    trading ~2 integer ops/word for 50 GB of storage, which keeps the whole CG
    loop (lax.while_loop + fori_loop over chunks) on-device with zero
    host<->device traffic.  The .bed-backed equivalent is
    ``cli gblup --stream-chunk`` (StreamedGeno), whose per-chunk compute is
    identical but streams chunks over PCIe from host RAM.

    Single matvec = 't' pass + 'n' pass per chunk with exact 2f
    centering, i.e. (Zc Zcᵀ)x accumulated over chunks — the K-split +
    psum pattern of the distributed layer, serialized on one card.
    """
    import jax
    import jax.numpy as jnp

    from .ops.common import decode_planar16
    from .ops.dgemm import packed_matmul
    from .solve.cg import cg

    if snps % chunks:
        raise ValueError("snps must divide into chunks")
    chunk_snps = snps // chunks
    kw_chunk = chunk_snps // 16
    lam = (1.0 - h2) / h2

    def hash_u32(x):
        # splitmix-style avalanche; uint32 wrap-around arithmetic
        x = (x ^ (x >> jnp.uint32(16))) * jnp.uint32(0x7FEB352D)
        x = (x ^ (x >> jnp.uint32(15))) * jnp.uint32(0x846CA68B)
        return x ^ (x >> jnp.uint32(16))

    def gen_chunk(c):
        # per-chunk SALT folded through the hash, not a uint32 base
        # offset: c*(kw_chunk*indiv+1) wrapped for c >= 11 at the default
        # sizes, silently replaying earlier chunks' hash streams
        salt = hash_u32(jnp.uint32(c) * jnp.uint32(0x9E3779B9)
                        + jnp.uint32(1))
        idx = (jax.lax.broadcasted_iota(jnp.uint32, (indiv, kw_chunk), 0)
               * jnp.uint32(kw_chunk)
               + jax.lax.broadcasted_iota(jnp.uint32, (indiv, kw_chunk), 1))
        r = hash_u32(idx ^ salt)
        a = r & jnp.uint32(0x55555555)
        b = (r >> jnp.uint32(1)) & jnp.uint32(0x55555555)
        return (((b & ~a) << jnp.uint32(1)) | (a & ~b)).astype(jnp.int32)

    row_blk = min(indiv, 4096)
    if indiv % row_blk:
        raise ValueError("indiv must be a multiple of 4096 (or below it)")

    def zt_x(zq, x):
        # Z_ckᵀ x from the individual-major chunk packing: decoded row
        # blocks, f32 products at HIGHEST precision
        def step(r, acc):
            w = jax.lax.dynamic_slice_in_dim(zq, r * row_blk, row_blk)
            xr = jax.lax.dynamic_slice_in_dim(x, r * row_blk, row_blk)
            return acc + jnp.dot(decode_planar16(w, jnp.float32).T, xr,
                                 precision=jax.lax.Precision.HIGHEST)
        return jax.lax.fori_loop(
            0, indiv // row_blk, step,
            jnp.zeros((chunk_snps, x.shape[1]), jnp.float32))

    @jax.jit
    def compute_freq():
        ones = jnp.ones((indiv, 1), jnp.float32)

        def step(c, acc):
            s = zt_x(gen_chunk(c), ones)[:, 0]
            return jax.lax.dynamic_update_slice(acc, s, (c * chunk_snps,))

        sums = jax.lax.fori_loop(0, chunks, step,
                                 jnp.zeros((snps,), jnp.float32))
        return sums / (2.0 * indiv)

    freq = compute_freq()
    freq.block_until_ready()

    def matvec(freqv, lam_s2, x):
        ones_x = jnp.sum(x, axis=0)

        def step(c, y):
            zq = gen_chunk(c)
            u = zt_x(zq, x)                                  # Z_ckᵀ x
            f_ck = jax.lax.dynamic_slice(
                freqv, (c * chunk_snps,), (chunk_snps,))
            uc = u[:chunk_snps] - 2.0 * f_ck[:, None] * ones_x[None, :]
            y2 = packed_matmul(zq, uc)[:indiv]               # Z_ck uc
            corr = jnp.dot(2.0 * f_ck, uc,
                           precision=jax.lax.Precision.HIGHEST)
            return y + y2 - corr[None, :]

        y = jax.lax.fori_loop(0, chunks, step, jnp.zeros_like(x))
        return y + lam_s2 * x

    @jax.jit
    def solve(freqv, y):
        s2 = 2.0 * jnp.sum(freqv * (1.0 - freqv))
        res = cg(lambda v: matvec(freqv, lam * s2, v), y,
                 tol=tol * jnp.linalg.norm(y), maxiter=maxiter)
        return res.x, res.iterations, res.residual_norm

    rng = np.random.default_rng(0)
    y = jnp.asarray(rng.standard_normal((indiv, 1)), jnp.float32)

    t0 = time.time()
    x, iters, resid = solve(freq, y)
    int(iters)  # sync
    compile_s = time.time() - t0
    t0 = time.time()
    x, iters, resid = solve(freq, y)
    iters = int(iters)
    wall = time.time() - t0
    rel = float(resid[0]) / float(jnp.linalg.norm(y))
    return {
        "suite": "gblup_fullscale",
        "config": f"{snps}x{indiv} GBLUP CG on-device, h2={h2}, "
                  f"{chunks} regenerated chunks, ncol=1",
        "cg_iterations": iters,
        "rel_residual": rel,
        "wall_s": round(wall, 2),
        "compile_plus_first_run_s": round(compile_s, 2),
        "converged": bool(rel <= tol * 1.5),
    }


def bench_scaling(n_devices: Optional[int] = None, snps: int = 131072,
                  indiv: int = 1024, ncol: int = 8) -> dict:
    """SNP-sharded dgemm scaling efficiency across the available mesh
    (BASELINE.md target: >= 85% at 2 hosts).  With JAX_PLATFORMS=cpu +
    xla_force_host_platform_device_count it runs the virtual-device path;
    on several GPUs it measures real scaling."""
    import jax
    import jax.numpy as jnp

    from . import parallel
    from .io import bed

    devs = jax.devices()
    d = n_devices or len(devs)
    g = bed.simulate_genotypes(indiv, snps, seed=0)
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal((snps, ncol)), jnp.float32)

    results = {}
    for nd in sorted({1, d}):
        mesh = parallel.make_mesh(nd)
        sg = parallel.shard_genotypes(g, mesh)
        # scan-carry differenced timing;
        # sg rides through jit as a pytree, so tracing happens once.  The
        # mesh binds via closure: tracers cannot carry sharding metadata.
        results[nd] = _timed_scan_b(
            lambda s, bc, m=mesh: parallel.sharded_dgemm(
                s, bc, trans="n", mesh=m),
            sg, b, iters=8)
    eff = None
    if d > 1:
        eff = results[1] / (results[d] * d)
    return {
        "suite": "scaling",
        "devices": d,
        "config": f"{snps}x{indiv} ncol={ncol} sharded 'n'",
        "t_1dev_s": round(results[1], 6),
        f"t_{d}dev_s": round(results[d], 6),
        "scaling_efficiency": round(eff, 3) if eff is not None else None,
    }


def bench_ld_banded(snps: int = 1_048_576, indiv: int = 512,
                    window: int = 512, reps: int = 3) -> dict:
    """Banded LD family at the 1M-SNP scale it was built for: wall times for
    ld_windowed (the O(snps·window) band), ld_score (gcta --ld-score
    role), and ld_prune (plink --indep-pairwise role).  Host-orchestrated
    streaming ops — wall-clock medians after a warm-up rep."""
    import statistics

    from .geno import from_dense
    from .io import bed
    from .ops.grm import ld_prune, ld_score, ld_windowed

    g = bed.simulate_genotypes(indiv, snps, seed=0)
    gm = from_dense(g)

    def wall(fn):
        fn()                      # warm (compiles + native build)
        return statistics.median(
            _walled(fn) for _ in range(reps))

    def _walled(fn):
        t0 = time.time()
        fn()
        return time.time() - t0

    tw = wall(lambda: ld_windowed(gm, window))
    ts = wall(lambda: ld_score(gm, window=window))
    tp = wall(lambda: ld_prune(gm, window=window, r2_threshold=0.2))
    return {
        "suite": "ld_banded",
        "config": f"{snps}x{indiv}, window={window}",
        "ld_windowed_s": round(tw, 3),
        "ld_score_s": round(ts, 3),
        "ld_prune_s": round(tp, 3),
        "snps_per_s_windowed": round(snps / tw, 1),
    }


def main(argv=None) -> int:
    from .utils.compcache import enable_compilation_cache

    enable_compilation_cache()
    ap = argparse.ArgumentParser(prog="miraculix_tpu.benchmark")
    ap.add_argument("--suite", default="all",
                    choices=["dgemm", "dgemm_exact", "grm", "ld", "ld_banded",
                             "sparse_solve", "solve_refined", "gwas",
                             "ssgblup", "gblup_fullscale", "scaling",
                             "all"])
    ap.add_argument("--panels", nargs="*", default=["small"])
    ap.add_argument("--ncol", type=int, default=32)
    ap.add_argument("--sparse-n", type=int, default=1_000_000)
    ap.add_argument("--comparator", action="store_true")
    args = ap.parse_args(argv)

    if args.suite in ("dgemm", "all"):
        for p in args.panels:
            if p not in PANELS:
                continue  # grm-only panel names (e.g. ref_many_snps)
            print(json.dumps(bench_dgemm(p, ncol=args.ncol,
                                         comparator=args.comparator)))
    if args.suite in ("grm", "all"):
        for p in args.panels:
            if p == "ref_many_snps":
                print(json.dumps(bench_grm_ref_panel()))
            else:
                print(json.dumps(bench_grm(p, comparator=args.comparator)))
    if args.suite in ("ld", "all"):
        for p in args.panels:
            if p in PANELS:
                print(json.dumps(bench_ld(p)))
    if args.suite == "ld_banded":
        print(json.dumps(bench_ld_banded()))
    if args.suite == "dgemm_exact":
        for p in args.panels:
            if p in PANELS:
                print(json.dumps(bench_dgemm_exact(p, ncol=args.ncol)))
    if args.suite == "sparse_solve":
        print(json.dumps(bench_sparse_solve(n=args.sparse_n)))
    if args.suite == "solve_refined":
        for p in args.panels:
            if p in PANELS:
                print(json.dumps(bench_solve_refined(p)))
    if args.suite == "gwas":
        for p in args.panels:
            if p in PANELS:
                print(json.dumps(bench_gwas(p)))
    if args.suite == "ssgblup":
        print(json.dumps(bench_ssgblup()))
    if args.suite == "gblup_fullscale":
        print(json.dumps(bench_gblup_fullscale()))
    if args.suite in ("scaling", "all"):
        print(json.dumps(bench_scaling()))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
