"""GWAS linear association scan: per-SNP regression straight off the
packed panel — y ~ intercept + covariates + SNP dosage, one SNP at a time,
WITHOUT ever forming a dense genotype matrix or looping over SNPs.

The classic residualization identity collapses the per-SNP regressions
into three packed operations: with X the covariate matrix (intercept
included) and M = I - X (XᵀX)⁻¹ Xᵀ,

    beta_s = z_sᵀ M y / d_s,      d_s = z_sᵀ M z_s
    d_s    = (ZᵀZ)_ss - a_sᵀ (XᵀX)⁻¹ a_s,   a_s = Xᵀ z_s

- Zᵀ (M y) is ONE packed dgemm 't' pass (ops.dgemm),
- A = Zᵀ X is one more 't' pass with p columns,
- diag(ZᵀZ) is the exact one-pass packed row stats
  (ops.common.packed_row_sq_stats — no crossproduct).

Raw (uncentered) dosages are correct here: X contains the intercept, so M
annihilates constants and M z equals M z_centered.  Missing genotypes are
packed as 0 (the panel-wide convention); for the exact reference
semantics, mean-impute upstream or use panels without missing calls.

t statistics use the per-SNP residual variance
    sigma²_s = (y~ᵀy~ - beta_s² d_s) / (n - p - 1)
with df = n - p - 1; two-sided p-values come from the t survival function
(scipy, shipped with jax).

The reference has no GWAS driver — this is downstream tooling its users
run through PLINK/GCTA after exporting; here it rides the same packed
kernels as everything else.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class GWASResult(NamedTuple):
    beta: np.ndarray      # [snps] per-SNP effect estimates
    se: np.ndarray        # [snps] standard errors
    t: np.ndarray         # [snps] t statistics
    p: np.ndarray         # [snps] two-sided p-values
    df: int               # residual degrees of freedom


def _snp_residual_denominators(g, x: np.ndarray,
                               xtx_inv: np.ndarray) -> np.ndarray:
    """d_s = z_sᵀ M z_s for every SNP (clamped at 0): one packed 't' pass
    (ZᵀX) plus the exact one-pass Σz² row stats — the per-SNP denominator
    shared by the linear, mixed, and LOCO scans.  Streams chunk by chunk
    on a StreamedGeno."""
    import jax
    import jax.numpy as jnp

    from .ops.common import packed_row_sq_stats
    from .ops.dgemm import dgemm
    from .parallel.sharded import (ShardedGeno, sharded_dgemm,
                                   sharded_snp_sq_stats)
    from .streamed import StreamedGeno

    if isinstance(g, StreamedGeno):
        a = np.asarray(g.dgemm(x.astype(np.float32), trans="t",
                               center=False), np.float64)
        zsq = np.concatenate([
            np.asarray(jax.jit(packed_row_sq_stats)(jnp.asarray(c.zq_t)),
                       np.float64)[: c.snps]
            for c in g.chunks])
    elif isinstance(g, ShardedGeno):
        a = np.asarray(sharded_dgemm(
            g, jnp.asarray(x, jnp.float32), trans="t", center=False),
            np.float64)                                      # ZᵀX [snps, p]
        zsq = np.asarray(sharded_snp_sq_stats(g), np.float64)
    else:
        a = np.asarray(dgemm(g, jnp.asarray(x, jnp.float32), trans="t",
                             center=False), np.float64)      # ZᵀX [snps, p]
        zsq = np.asarray(jax.jit(packed_row_sq_stats)(g.zq_t),
                         np.float64)[: g.snps]               # diag(ZᵀZ)
    return np.maximum(zsq - np.einsum("sp,pq,sq->s", a, xtx_inv, a), 0.0)


def _t_pass(g, v: np.ndarray) -> np.ndarray:
    """Zᵀ v (uncentered) as one packed 't' pass on ANY container —
    GenoMatrix, StreamedGeno (chunk loop), or ShardedGeno (row-parallel
    shard_map) — returning numpy f64 [snps, k]."""
    import jax.numpy as jnp

    from .ops.dgemm import dgemm
    from .parallel.sharded import ShardedGeno, sharded_dgemm
    from .streamed import StreamedGeno

    if v.ndim == 1:
        v = v[:, None]
    if isinstance(g, StreamedGeno):
        return np.asarray(g.dgemm(v.astype(np.float32), trans="t",
                                  center=False), np.float64)
    if isinstance(g, ShardedGeno):
        return np.asarray(sharded_dgemm(
            g, jnp.asarray(v, jnp.float32), trans="t", center=False),
            np.float64)
    return np.asarray(dgemm(g, jnp.asarray(v, jnp.float32), trans="t",
                            center=False), np.float64)


def gwas_linear(
    g,
    y: np.ndarray,
    covariates: Optional[np.ndarray] = None,
) -> GWASResult:
    """Per-SNP linear association scan (see module docstring).

    ``g``: GenoMatrix, StreamedGeno (the three passes stream chunk by
    chunk — biobank panels beyond HBM scan out of core), or ShardedGeno
    (each pass is a shard_map over the mesh — the biobank-scale
    multi-card scan).  ``y``: [indiv] phenotype.
    ``covariates``: optional [indiv, c] matrix (the intercept is always
    added).
    """
    n = g.indiv
    y = np.asarray(y, np.float64).reshape(n)
    cols = [np.ones((n, 1))]
    if covariates is not None:
        cov = np.asarray(covariates, np.float64)
        if cov.ndim == 1:
            cov = cov[:, None]
        if cov.shape[0] != n:
            raise ValueError(f"covariates have {cov.shape[0]} rows, "
                             f"expected {n}")
        cols.append(cov)
    x = np.concatenate(cols, axis=1)
    p = x.shape[1]
    df = n - p - 1
    if df <= 0:
        raise ValueError(f"not enough residual df: n={n}, p={p}")

    xtx = x.T @ x
    xtx_inv = np.linalg.inv(xtx)
    # residualized phenotype y~ = M y
    coef = xtx_inv @ (x.T @ y)
    y_res = y - x @ coef
    yty = float(y_res @ y_res)

    # the three packed passes (device; f32-grade is ample for test stats)
    num = _t_pass(g, y_res)[:, 0]                             # Zᵀ M y
    d = _snp_residual_denominators(g, x, xtx_inv)

    with np.errstate(divide="ignore", invalid="ignore"):
        beta = np.where(d > 0, num / np.maximum(d, 1e-300), 0.0)
        sigma2 = np.maximum(yty - beta * num, 0.0) / df
        se = np.sqrt(np.where(d > 0, sigma2 / np.maximum(d, 1e-300),
                              np.inf))
        t = np.where(se > 0, beta / se, 0.0)
        t = np.where(np.isfinite(t), t, 0.0)
    try:
        from scipy.stats import t as tdist

        pvals = 2.0 * tdist.sf(np.abs(t), df)
    except ImportError:  # pragma: no cover - scipy ships with jax
        pvals = np.full_like(t, np.nan)
    return GWASResult(beta=beta, se=se, t=t, p=pvals, df=df)


class MixedGWASResult(NamedTuple):
    beta: np.ndarray      # [snps] GRAMMAR effect estimates (gamma-corrected)
    chi2: np.ndarray      # [snps] 1-df score statistics
    p: np.ndarray         # [snps] p-values (chi2 survival, 1 df)
    gamma: float          # GRAMMAR-gamma correction factor
    cg_iterations: int


def gwas_mixed(
    g,
    y: np.ndarray,
    covariates: Optional[np.ndarray] = None,
    h2: float = 0.5,
    n_gamma_snps: int = 64,
    tol: float = 1e-6,
    maxiter: int = 2000,
    seed: int = 0,
) -> MixedGWASResult:
    """Mixed-model association scan, GRAMMAR-gamma flavor (Svishcheva et
    al. 2012): correct for relatedness/population structure with ONE block
    CG solve against V = G/σ² + λI instead of a per-SNP mixed model.

        y* = V⁻¹ (M y)                       (one on-device block CG)
        U_s = (M z_s)ᵀ y* = z_sᵀ (M y*)      (one packed 't' pass)
        χ²_s = U_s² / (γ · d_s),   d_s = z_sᵀ M z_s

    γ̂ = mean over ``n_gamma_snps`` sampled SNPs of (Mz_s)ᵀV⁻¹(Mz_s) / d_s
    (projected consistently on BOTH sides) — the
    sampled columns are extracted with one packed 'n' pass (one-hot RHS)
    and solved in the SAME block CG family, so the whole scan costs ~two
    block solves + three packed passes regardless of SNP count.

    Approximations (standard for GRAMMAR-gamma): a global γ in place of
    per-SNP z_sᵀV⁻¹z_s, and covariate projection applied before (not
    jointly with) the V⁻¹ rotation.  For the exact per-SNP mixed model,
    fall back to per-SNP solves with solve.grm_cg_solve.
    """
    import jax.numpy as jnp

    from .solve.cg import grm_cg_solve
    from .ops.dgemm import dgemm
    from .parallel.sharded import ShardedGeno, sharded_cg_solve, sharded_dgemm

    from .streamed import StreamedGeno

    streamed = isinstance(g, StreamedGeno)
    sharded = isinstance(g, ShardedGeno)
    n = g.indiv
    lam = (1.0 - h2) / h2
    y = np.asarray(y, np.float64).reshape(n)
    cols = [np.ones((n, 1))]
    if covariates is not None:
        cov = np.asarray(covariates, np.float64)
        if cov.ndim == 1:
            cov = cov[:, None]
        cols.append(cov)
    x = np.concatenate(cols, axis=1)
    xtx_inv = np.linalg.inv(x.T @ x)
    y_res = y - x @ (xtx_inv @ (x.T @ y))

    # sampled SNP columns for gamma: on-device subset repack + identity
    # RHS (O(indiv·k)); a [snps, k] one-hot was 256 MB at 1M SNPs just to
    # pick 64 columns.  StreamedGeno has no subset — keep the one-hot
    # there (its dgemm streams the RHS chunk by chunk anyway)
    rng = np.random.default_rng(seed)
    k = min(n_gamma_snps, g.snps)
    sample = np.sort(rng.choice(g.snps, size=k, replace=False))
    if streamed or sharded:
        # one-hot RHS: the streamed dgemm streams it chunk by chunk; the
        # sharded 'n' pass shards it by SNP rows (k<=64 columns is cheap)
        onehot = np.zeros((g.snps, k), np.float32)
        onehot[sample, np.arange(k)] = 1.0
        if streamed:
            zcols = np.asarray(g.dgemm(onehot, trans="n", center=False),
                               np.float64)
        else:
            zcols = np.asarray(sharded_dgemm(
                g, jnp.asarray(onehot), trans="n", center=False),
                np.float64)
    else:
        from .geno import subset_snps

        zcols = np.asarray(dgemm(
            subset_snps(g, sample), jnp.asarray(np.eye(k, dtype=np.float32)),
            trans="n", center=False), np.float64)              # [n, k]
    mzcols = zcols - x @ (xtx_inv @ (x.T @ zcols))             # M z_s

    # ONE block CG over [y_res | projected sampled columns]
    rhs = np.concatenate([y_res[:, None], mzcols], axis=1)
    if streamed:
        # the streamed host-driven PCG (StreamedGeno.cg_solve) plays the
        # role of the on-device block CG — one pass over the chunks per
        # iteration, panels beyond HBM included
        xs, cg_iters, _ = g.cg_solve(rhs, lam=lam, scale=True, tol=tol,
                                     maxiter=maxiter, precondition=True)
        solved = np.asarray(xs, np.float64)
    elif sharded:
        res = sharded_cg_solve(g, jnp.asarray(rhs, jnp.float32), lam=lam,
                               scale=True, tol=tol, maxiter=maxiter,
                               precondition=True)
        solved = np.asarray(res.x, np.float64)
        cg_iters = int(res.iterations)
    else:
        res = grm_cg_solve(g, jnp.asarray(rhs, jnp.float32), lam=lam,
                           scale=True, tol=tol, maxiter=maxiter)
        solved = np.asarray(res.x, np.float64)
        cg_iters = int(res.iterations)
    ystar, vcols = solved[:, 0], solved[:, 1:]
    # project y* so the scan pass computes (M z_s)' y* with raw dosages
    ystar = ystar - x @ (xtx_inv @ (x.T @ ystar))

    # d_s = z_s' M z_s for all SNPs (linear-scan identity)
    d = _snp_residual_denominators(g, x, xtx_inv)

    dv = np.einsum("nk,nk->k", mzcols, vcols)   # (Mz_s)' V^-1 (Mz_s)
    ds = d[sample]
    ok = ds > 0
    gamma = float(np.mean(dv[ok] / ds[ok])) if ok.any() else 1.0

    u = _t_pass(g, ystar)[:, 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        chi2 = np.where(d > 0, u * u / (gamma * np.maximum(d, 1e-300)), 0.0)
        beta = np.where(d > 0, u / (gamma * np.maximum(d, 1e-300)), 0.0)
    try:
        from scipy.stats import chi2 as chi2dist

        pvals = chi2dist.sf(chi2, 1)
    except ImportError:  # pragma: no cover
        pvals = np.full_like(chi2, np.nan)
    return MixedGWASResult(beta=beta, chi2=chi2, p=pvals, gamma=gamma,
                           cg_iterations=int(cg_iters))


def _indicator2_packing(zq):
    """Packed genotype==2 indicator (moved to ops.common.packed_indicator2
    so the sharded weighted diagonal shares it; thin alias kept)."""
    from .ops.common import packed_indicator2

    return packed_indicator2(zq)


def gwas_logistic(
    g,
    y: np.ndarray,
    covariates: Optional[np.ndarray] = None,
    max_irls: int = 50,
    irls_tol: float = 1e-10,
) -> GWASResult:
    """Case-control association: per-SNP logistic SCORE test (the fast
    flavor of `plink --logistic` / the base statistic of SAIGE), with the
    null model fit ONCE and every SNP scored from packed passes:

        U_s = z_sᵀ (y - p̂)
        V_s = Σ_i w_i z²_is - a_sᵀ (XᵀWX)⁻¹ a_s,   a_s = XᵀW z_s,
        w_i = p̂_i (1 - p̂_i),   χ²_s = U_s²/V_s  (1 df)

    The only non-matmul ingredient, Σ w z², comes from z² = z + 2·1(z=2):
    the z=2 indicator is ANOTHER packed genotype matrix obtained by pure
    bit manipulation of the planar16 words (``_indicator2_packing``), so
    the weighted square rides the same packed kernels.  One dgemm 't' pass
    carries [y-p̂ | w | WX] simultaneously; one more carries the indicator.

    ``beta`` in the result is the one-step score approximation U/V (good
    near the null); se = 1/sqrt(V); t := the SIGNED score z-statistic.
    """
    import jax.numpy as jnp

    from .ops.dgemm import packed_matmul

    n = g.indiv
    y = np.asarray(y, np.float64).reshape(n)
    if not np.isin(y, (0.0, 1.0)).all():
        raise ValueError("gwas_logistic needs a 0/1 phenotype")
    cols = [np.ones((n, 1))]
    if covariates is not None:
        cov = np.asarray(covariates, np.float64)
        if cov.ndim == 1:
            cov = cov[:, None]
        if cov.shape[0] != n:
            raise ValueError(f"covariates have {cov.shape[0]} rows, "
                             f"expected {n}")
        cols.append(cov)
    x = np.concatenate(cols, axis=1)
    p = x.shape[1]

    # null logistic fit (IRLS on the small covariate model, host)
    beta0 = np.zeros(p)
    for _ in range(max_irls):
        eta = x @ beta0
        mu = 1.0 / (1.0 + np.exp(-eta))
        w = np.maximum(mu * (1.0 - mu), 1e-12)
        zwork = eta + (y - mu) / w
        wx = x * w[:, None]
        new = np.linalg.solve(x.T @ wx, wx.T @ zwork)
        if np.abs(new - beta0).max() < irls_tol:
            beta0 = new
            break
        beta0 = new
    mu = 1.0 / (1.0 + np.exp(-(x @ beta0)))
    w = np.maximum(mu * (1.0 - mu), 1e-12)
    resid = y - mu
    wx = x * w[:, None]
    xtwx_inv = np.linalg.inv(x.T @ wx)

    # one packed pass for [resid | w | WX]  -> [snps, 2+p]
    from .parallel.sharded import ShardedGeno, sharded_indicator2_dgemm_t
    from .streamed import StreamedGeno

    rhs = np.concatenate([resid[:, None], w[:, None], wx], axis=1)
    zt = _t_pass(g, rhs)
    if isinstance(g, StreamedGeno):
        s2 = np.concatenate([
            np.asarray(packed_matmul(
                _indicator2_packing(jnp.asarray(c.zq_t)),
                jnp.asarray(w[:, None], jnp.float32)), np.float64)[: c.snps, 0]
            for c in g.chunks])
    elif isinstance(g, ShardedGeno):
        s2 = np.asarray(sharded_indicator2_dgemm_t(
            g, jnp.asarray(w[:, None], jnp.float32)), np.float64)[:, 0]
    else:
        s2 = np.asarray(packed_matmul(
            _indicator2_packing(g.zq_t), jnp.asarray(w[:, None], jnp.float32)),
            np.float64)[: g.snps, 0]
    u, zw, a = zt[:, 0], zt[:, 1], zt[:, 2:]
    swz2 = zw + 2.0 * s2                      # Σ w z²
    v = swz2 - np.einsum("sp,pq,sq->s", a, xtwx_inv, a)
    v = np.maximum(v, 0.0)

    with np.errstate(divide="ignore", invalid="ignore"):
        zstat = np.where(v > 0, u / np.sqrt(np.maximum(v, 1e-300)), 0.0)
        beta = np.where(v > 0, u / np.maximum(v, 1e-300), 0.0)
        se = np.where(v > 0, 1.0 / np.sqrt(np.maximum(v, 1e-300)), np.inf)
    try:
        from scipy.stats import norm

        pvals = 2.0 * norm.sf(np.abs(zstat))
    except ImportError:  # pragma: no cover
        pvals = np.full_like(zstat, np.nan)
    return GWASResult(beta=beta, se=se, t=zstat, p=pvals, df=1)


_loco_cg_jit = None


def _loco_cg(g, g_c, rhs, s2_loco, lam, *, tol, maxiter):
    """Jacobi-PCG on the LOCO operator (G_full − G_c)/σ²_(-c) + λI, as ONE
    lazily-built MODULE-level jitted program: both GenoMatrix pytrees are
    ARGUMENTS, so equal-shaped chromosomes genuinely share one executable
    and the packed panel never bakes in as an HLO constant (a
    per-chromosome @jax.jit closure recompiled every iteration of the
    chromosome loop AND embedded the panel — the ssGBLUP HTTP-413
    anti-pattern)."""
    global _loco_cg_jit
    if _loco_cg_jit is None:
        import functools

        import jax

        from .solve.cg import cg, grm_diag, grm_matvec, jacobi_minv

        @functools.partial(jax.jit, static_argnames=("tol", "maxiter"))
        def run(g, g_c, rhs, s2_loco, lam, *, tol, maxiter):
            def op(v):
                gv = (grm_matvec(g, v, center=True)
                      - grm_matvec(g_c, v, center=True)) / s2_loco
                return gv + lam * v

            minv = jacobi_minv((grm_diag(g, center=True)
                                - grm_diag(g_c, center=True)) / s2_loco
                               + lam)
            return cg(op, rhs, tol=tol, maxiter=maxiter, minv=minv)

        _loco_cg_jit = run
    return _loco_cg_jit(g, g_c, rhs, s2_loco, lam, tol=tol, maxiter=maxiter)


def gwas_mixed_loco(
    g,
    y: np.ndarray,
    chrom: np.ndarray,
    covariates: Optional[np.ndarray] = None,
    h2: float = 0.5,
    n_gamma_snps: int = 32,
    tol: float = 1e-6,
    maxiter: int = 2000,
    seed: int = 0,
) -> MixedGWASResult:
    """GRAMMAR-gamma with leave-one-chromosome-out (LOCO) relatedness —
    the standard guard against proximal contamination (testing a SNP
    against a GRM that contains it shrinks its own signal; BOLT-LMM /
    GCTA-LOCO semantics).  ``chrom``: per-SNP chromosome labels (any
    hashable values, e.g. the .bim first column).

    Per chromosome c the rotation solves V_(-c) = G_(-c)/sigma2_(-c) +
    lam I, with the LOCO matvec as the DIFFERENCE of two packed operators

        Zc_full Zc_full' v  -  Zc_c Zc_c' v

    (the chromosome panel is repacked once with the FULL panel's per-SNP
    frequencies, so the subtraction is exact), preconditioned by the
    matching diagonal difference.  d_s = z_s' M z_s is
    chromosome-independent and computed once.  gamma is re-estimated per
    chromosome from SNPs sampled WITHIN it.
    """
    import jax.numpy as jnp

    from .geno import subset_snps
    from .ops.dgemm import dgemm
    from .parallel.sharded import ShardedGeno

    from .streamed import StreamedGeno

    if isinstance(g, StreamedGeno):
        raise TypeError(
            "gwas_mixed_loco needs a device GenoMatrix (the LOCO operator "
            "subsets the packed panel per chromosome); for out-of-core "
            "panels run gwas_mixed per chromosome with a pre-split panel, "
            "or materialize: a GenoMatrix holds 4 genotypes per byte in "
            "each of its two packings")
    if isinstance(g, ShardedGeno):
        return _gwas_mixed_loco_sharded(
            g, y, chrom, covariates=covariates, h2=h2,
            n_gamma_snps=n_gamma_snps, tol=tol, maxiter=maxiter, seed=seed)
    n = g.indiv
    lam = (1.0 - h2) / h2
    y = np.asarray(y, np.float64).reshape(n)
    chrom = np.asarray(chrom)
    if chrom.shape != (g.snps,):
        raise ValueError(f"chrom must have one label per SNP "
                         f"({g.snps}), got {chrom.shape}")
    cols = [np.ones((n, 1))]
    if covariates is not None:
        cov = np.asarray(covariates, np.float64)
        cols.append(cov[:, None] if cov.ndim == 1 else cov)
    x = np.concatenate(cols, axis=1)
    xtx_inv = np.linalg.inv(x.T @ x)

    def proj(v):
        return v - x @ (xtx_inv @ (x.T @ v))

    y_res = proj(y)

    # d_s once, over the full panel (chromosome-independent)
    d = _snp_residual_denominators(g, x, xtx_inv)

    freq = np.asarray(g.freq, np.float64)
    sigma2 = float(g.sigma2)

    rng = np.random.default_rng(seed)
    u = np.zeros(g.snps)
    gamma_by = {}
    iters_total = 0
    for c in np.unique(chrom):
        mask = chrom == c
        idx = np.flatnonzero(mask)
        # chromosome panel with the FULL panel's frequencies -> exact
        # subtraction of the two centered operators (_loco_cg compiles
        # once per distinct chromosome SHAPE; equal-sized chromosomes
        # share one executable).  subset_snps repacks ON DEVICE (2-bit
        # field gather) — no host decode+repack, nothing densifies
        g_c = subset_snps(g, idx)
        s2_loco = sigma2 - float(2.0 * np.sum(freq[idx]
                                              * (1.0 - freq[idx])))
        if s2_loco <= 0:
            raise ValueError(f"chromosome {c!r} carries the whole panel")

        k = min(n_gamma_snps, len(idx))
        sample_local = np.sort(rng.choice(len(idx), size=k, replace=False))
        zcols = np.asarray(dgemm(
            subset_snps(g, idx[sample_local]),
            jnp.asarray(np.eye(k, dtype=np.float32)), trans="n",
            center=False), np.float64)
        mzcols = proj(zcols)

        rhs = np.concatenate([y_res[:, None], mzcols], axis=1)
        res = _loco_cg(g, g_c, jnp.asarray(rhs, jnp.float32),
                       jnp.float32(s2_loco), jnp.float32(lam),
                       tol=tol, maxiter=maxiter)
        solved = np.asarray(res.x, np.float64)
        iters_total += int(res.iterations)
        ystar = proj(solved[:, 0])
        vcols = solved[:, 1:]

        dv = np.einsum("nk,nk->k", mzcols, vcols)
        ds = d[idx][sample_local]
        ok = ds > 0
        gamma_by[c] = float(np.mean(dv[ok] / ds[ok])) if ok.any() else 1.0

        uc = np.asarray(dgemm(g_c, jnp.asarray(ystar[:, None], jnp.float32),
                              trans="t", center=False), np.float64)[:, 0]
        u[idx] = uc / gamma_by[c]  # fold per-chromosome gamma in here

    with np.errstate(divide="ignore", invalid="ignore"):
        # u already gamma-scaled per chromosome: chi2 = (gamma*u')^2*gamma/d
        gam = np.array([gamma_by[c] for c in chrom])
        chi2 = np.where(d > 0, u * u * gam / np.maximum(d, 1e-300), 0.0)
        beta = np.where(d > 0, u / np.maximum(d, 1e-300), 0.0)
    try:
        from scipy.stats import chi2 as chi2dist

        pvals = chi2dist.sf(chi2, 1)
    except ImportError:  # pragma: no cover
        pvals = np.full_like(chi2, np.nan)
    return MixedGWASResult(beta=beta, chi2=chi2, p=pvals,
                           gamma=float(np.mean(list(gamma_by.values()))),
                           cg_iterations=iters_total)


def _gwas_mixed_loco_sharded(
    g,
    y: np.ndarray,
    chrom: np.ndarray,
    covariates=None,
    h2: float = 0.5,
    n_gamma_snps: int = 32,
    tol: float = 1e-6,
    maxiter: int = 2000,
    seed: int = 0,
) -> MixedGWASResult:
    """LOCO GRAMMAR-gamma on a SNP-sharded panel: instead of repacking a
    chromosome subset per fold (ragged across shards), the LOCO operator
    multiplies the 't'-pass output by a 0/1 off-chromosome mask BETWEEN
    the packed passes — mathematically identical (masked rows vanish from
    the product and its centering term), and the mask is a TRACED
    argument, so all chromosomes share ONE compiled distributed CG
    (parallel.sharded_loco_cg_solve)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .parallel.sharded import (_mesh_of, sharded_dgemm,
                                   sharded_loco_cg_solve)

    mesh = _mesh_of(g)
    n = g.indiv
    lam = (1.0 - h2) / h2
    y = np.asarray(y, np.float64).reshape(n)
    chrom = np.asarray(chrom)
    if chrom.shape != (g.snps,):
        raise ValueError(f"chrom must have one label per SNP "
                         f"({g.snps}), got {chrom.shape}")
    cols = [np.ones((n, 1))]
    if covariates is not None:
        cov = np.asarray(covariates, np.float64)
        cols.append(cov[:, None] if cov.ndim == 1 else cov)
    x = np.concatenate(cols, axis=1)
    xtx_inv = np.linalg.inv(x.T @ x)

    def proj(v):
        return v - x @ (xtx_inv @ (x.T @ v))

    y_res = proj(y)
    d = _snp_residual_denominators(g, x, xtx_inv)

    npad = g.freq.shape[0]                      # D * spd (padded, sharded)
    freq = np.asarray(g.freq, np.float64)[: g.snps]
    sigma2 = float(g.sigma2)
    spec = NamedSharding(mesh, P(g.axis))

    rng = np.random.default_rng(seed)
    u = np.zeros(g.snps)
    gamma_by = {}
    iters_total = 0
    for c in np.unique(chrom):
        idx = np.flatnonzero(chrom == c)
        w = np.ones(npad, np.float32)
        w[g.snps:] = 0.0                        # padding (already zero rows)
        w[idx] = 0.0                            # leave chromosome c out
        w_sh = jax.device_put(w, spec)
        s2_loco = sigma2 - float(2.0 * np.sum(freq[idx]
                                              * (1.0 - freq[idx])))
        if s2_loco <= 0:
            raise ValueError(f"chromosome {c!r} carries the whole panel")

        k = min(n_gamma_snps, len(idx))
        sample_local = np.sort(rng.choice(len(idx), size=k, replace=False))
        onehot = np.zeros((g.snps, k), np.float32)
        onehot[idx[sample_local], np.arange(k)] = 1.0
        zcols = np.asarray(sharded_dgemm(
            g, jnp.asarray(onehot), trans="n", center=False), np.float64)
        mzcols = proj(zcols)

        rhs = np.concatenate([y_res[:, None], mzcols], axis=1)
        res = sharded_loco_cg_solve(
            g, w_sh, jnp.asarray(rhs, jnp.float32), jnp.float32(s2_loco),
            jnp.float32(lam), tol=tol, maxiter=maxiter, mesh=mesh)
        solved = np.asarray(res.x, np.float64)
        iters_total += int(res.iterations)
        ystar = proj(solved[:, 0])
        vcols = solved[:, 1:]

        dv = np.einsum("nk,nk->k", mzcols, vcols)
        ds = d[idx][sample_local]
        ok = ds > 0
        gamma_by[c] = float(np.mean(dv[ok] / ds[ok])) if ok.any() else 1.0

        uc = _t_pass(g, ystar)[idx, 0]
        u[idx] = uc / gamma_by[c]

    with np.errstate(divide="ignore", invalid="ignore"):
        gam = np.array([gamma_by[c] for c in chrom])
        chi2 = np.where(d > 0, u * u * gam / np.maximum(d, 1e-300), 0.0)
        beta = np.where(d > 0, u / np.maximum(d, 1e-300), 0.0)
    try:
        from scipy.stats import chi2 as chi2dist

        pvals = chi2dist.sf(chi2, 1)
    except ImportError:  # pragma: no cover
        pvals = np.full_like(chi2, np.nan)
    return MixedGWASResult(beta=beta, chi2=chi2, p=pvals,
                           gamma=float(np.mean(list(gamma_by.values()))),
                           cg_iterations=iters_total)
