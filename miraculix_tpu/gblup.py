"""GBLUP pipeline: GRM -> randomized PCA -> BLUE/BLUP estimation.

Reference: examples/gblup/calculate_gblup.jl — read panel, GRM, randomized
eigendecomposition (Halko) for population-structure covariates, then

    beta_hat = (Xᵀ (G + lam I)⁻¹ X)⁻¹ Xᵀ (G + lam I)⁻¹ y      (BLUE)
    u        = (G + lam I)⁻¹ (y - X beta_hat)
    g_hat    = G u                                             (BLUP)

with lam = sigma_e^2 / sigma_u^2 = (1 - h2) / h2.  Everything runs on
device; ``solver='cg'`` never materializes G (the operator is two packed
matmuls per product), which is the production path for 100K+ individuals.
"""
from __future__ import annotations

import dataclasses
import functools as _functools
from typing import Optional, Tuple

import jax as _jax
import jax.numpy as jnp
import numpy as np

from .geno import GenoMatrix, from_bed
from .ops.grm import grm
from .solve.cg import grm_cg_solve, grm_matvec
from .solve.dense import dense_solve

# f32 device products promise f32 grade: a GPU would take them in TF32
# (~1e-3) at the default precision
_HIGHEST = _jax.lax.Precision.HIGHEST


def _grm_matvec_of(g):
    """G·v operator for a GenoMatrix (single chip), a ShardedGeno /
    ShardedGeno2D (distributed), or a StreamedGeno (out-of-core) — GBLUP
    runs unchanged on any of them."""
    from .parallel import (ShardedGeno, ShardedGeno2D, pad_indiv_vec,
                           sharded_dgemm_2d, sharded_grm_matvec)
    from .streamed import StreamedGeno

    if isinstance(g, StreamedGeno):
        return lambda v: jnp.asarray(g.grm_matvec(np.asarray(v)))
    if isinstance(g, ShardedGeno):
        return lambda v: sharded_grm_matvec(g, v)
    if isinstance(g, ShardedGeno2D):
        def mv2d(v):
            vp = pad_indiv_vec(g, jnp.asarray(v))
            zv = sharded_dgemm_2d(g, vp, trans="t")
            snpmask = (jnp.arange(zv.shape[0]) < g.snps).astype(zv.dtype)
            gv = sharded_dgemm_2d(g, zv * snpmask[:, None], trans="n")
            return gv[: g.indiv]
        return mv2d
    return lambda v: grm_matvec(g, v)


def _grm_diag_of(g):
    """Exact diag(Z_c Z_cᵀ) on any container (the matvec counterpart is
    :func:`_grm_matvec_of`)."""
    from .parallel import (ShardedGeno, ShardedGeno2D, sharded_grm_diag,
                           sharded_grm_diag_2d)
    from .solve.cg import grm_diag
    from .streamed import StreamedGeno

    if isinstance(g, StreamedGeno):
        return np.asarray(g.grm_diag(center=True), np.float64)
    if isinstance(g, ShardedGeno):
        return np.asarray(sharded_grm_diag(g), np.float64)[: g.indiv]
    if isinstance(g, ShardedGeno2D):
        return np.asarray(sharded_grm_diag_2d(g), np.float64)[: g.indiv]
    return np.asarray(grm_diag(g, center=True, scale=False), np.float64)


def _scaled_matvec_of(g):
    """G_s · W for numpy [n, m] blocks on any container — the sigma2-scaled
    batched matvec the REML machinery is built from.  The streamed path
    stays in host numpy (no jnp round-trip: StreamedGeno.grm_matvec is
    host-orchestrated already) but pins chunks in HBM first: every pass
    over host-resident chunks re-uploads the WHOLE packed panel, dozens of
    passes per REML run."""
    from .streamed import StreamedGeno

    sigma2 = float(g.sigma2)
    if isinstance(g, StreamedGeno):
        g.cache_to_device()       # idempotent; overflow chunks stream
        return lambda w: np.asarray(g.grm_matvec(w.astype(np.float32)),
                                    np.float64) / sigma2
    raw = _grm_matvec_of(g)
    return lambda w: np.asarray(raw(jnp.asarray(w, jnp.float32)),
                                np.float64) / sigma2


def randomized_grm_pca(
    g,
    k: int = 10,
    oversample: int = 8,
    power_iters: int = 2,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k eigenpairs of the (unscaled, centered) GRM via the Halko
    randomized range finder, G applied implicitly as Z_c(Z_cᵀ ·) — the
    reference's randomized_snp_pca (calculate_gblup.jl:152-158) without
    ever forming G.  Accepts a GenoMatrix or a sharded container.

    Returns (eigenvalues [k], eigenvectors [indiv, k]).
    """
    n = g.indiv
    matvec = _grm_matvec_of(g)
    rng = np.random.default_rng(seed)
    omega = jnp.asarray(rng.standard_normal((n, k + oversample)), jnp.float32)
    y = matvec(omega)
    for _ in range(power_iters):
        q, _ = jnp.linalg.qr(y)
        y = matvec(q)
    q, _ = jnp.linalg.qr(y)
    t = jnp.matmul(q.T, matvec(q), precision=_HIGHEST)
    t = 0.5 * (t + t.T)
    w, v = jnp.linalg.eigh(t)
    idx = jnp.argsort(w)[::-1][:k]
    return np.asarray(w[idx]), np.asarray(
        jnp.matmul(q, v[:, idx], precision=_HIGHEST))


@dataclasses.dataclass
class GBLUPResult:
    beta: np.ndarray        # fixed effects (intercept + PCs)
    g_hat: np.ndarray       # genomic values (BLUP)
    fitted: np.ndarray      # X beta + g_hat
    pcs: Optional[np.ndarray]
    cg_iterations: int = 0
    u: Optional[np.ndarray] = None  # (G_s + lam I)^-1 (y - X beta):
    # the random-effect solutions snp_effects() backsolves from


def gblup(
    g: GenoMatrix,
    y: np.ndarray,
    h2: float = 0.5,
    n_pcs: int = 10,
    covariates: Optional[np.ndarray] = None,
    solver: str = "cg",
    tol: float = 1e-4,
    maxiter: int = 2000,
    seed: int = 0,
    verbose: bool = False,
) -> GBLUPResult:
    """Full GBLUP estimation (calculate_gblup.jl:163-199 semantics).

    The mixed-model scale: G is VanRaden-scaled (sigma^2 normalized), so
    lam = (1 - h2)/h2 directly.

    ``g`` may be a single-chip GenoMatrix or a distributed ShardedGeno /
    ShardedGeno2D (solver='cg' only) — the whole pipeline (PCA, both CG
    solves, the BLUP matvec) then runs across the mesh with collective
    reductions, the reference's single-GPU pipeline generalized.

    ``solver``: 'cg' (on-device f32 CG, the default), 'refined' (f64-grade
    mixed-model solves via iterative refinement — pass a tight ``tol``
    like 1e-10), or 'dense' (materialized GRM + Cholesky).
    """
    from .parallel import ShardedGeno, ShardedGeno2D
    from .streamed import StreamedGeno

    if solver not in ("cg", "refined", "dense"):
        raise ValueError(f"solver must be cg/refined/dense, got {solver!r}")
    sharded = isinstance(g, (ShardedGeno, ShardedGeno2D, StreamedGeno))
    if sharded and solver != "cg":
        raise ValueError("sharded/streamed GBLUP supports solver='cg' only")
    n = g.indiv
    lam = (1.0 - h2) / h2
    y = np.asarray(y, dtype=np.float64).reshape(n)

    pcs = None
    cols = [np.ones((n, 1))]
    if covariates is not None:
        cov = np.asarray(covariates, dtype=np.float64)
        if cov.ndim == 1:
            cov = cov[:, None]
        if cov.shape[0] != n:
            raise ValueError(f"covariates have {cov.shape[0]} rows, "
                             f"expected {n}")
        cols.append(cov)
    if n_pcs > 0:
        _, pcs = randomized_grm_pca(g, k=n_pcs, seed=seed)
        cols.append(pcs)
    x = np.concatenate(cols, axis=1)
    p = x.shape[1]

    rhs_np = np.concatenate([x, y[:, None]], axis=1)  # float64
    sigma2 = float(g.sigma2)

    def _cg(rhs_np_arr):
        """(Zc Zcᵀ + lam*sigma2 I) b' = rhs on whichever container.

        Takes float64 numpy; the f64-grade 'refined' path keeps it (and
        its solution) in float64 end to end — rounding through f32 on
        either side would cap the result at ~1e-7 and waste the
        refinement (CGResult.x may therefore be a float64 numpy array)."""
        if isinstance(g, StreamedGeno):
            from .solve.cg import CGResult

            x_np, iters, rel = g.cg_solve(
                rhs_np_arr, lam=lam * sigma2,
                scale=False, tol=tol, maxiter=maxiter, verbose=verbose)
            return CGResult(x_np, jnp.int32(iters), jnp.asarray(rel))
        if solver == "refined":
            # f64-grade mixed-model equations: on-device f32 CG inside,
            # true-f64 residual refinement outside (solve.cg)
            from .solve.cg import CGResult, grm_cg_solve_refined

            x_np, _, inner, rel = grm_cg_solve_refined(
                g, rhs_np_arr, lam=lam * sigma2,
                scale=False, tol=tol, inner_maxiter=maxiter)
            return CGResult(x_np, jnp.int32(inner), jnp.asarray(rel))
        rhs_arr = jnp.asarray(rhs_np_arr, jnp.float32)
        if isinstance(g, ShardedGeno):
            from .parallel import sharded_cg_solve

            return sharded_cg_solve(g, rhs_arr, lam=lam * sigma2,
                                    tol=tol, maxiter=maxiter)
        if isinstance(g, ShardedGeno2D):
            from .parallel import sharded_cg_solve_2d
            from .solve.cg import CGResult

            r = sharded_cg_solve_2d(g, rhs_arr, lam=lam * sigma2,
                                    tol=tol, maxiter=maxiter)
            return CGResult(r.x[:n], r.iterations, r.residual_norm)
        return grm_cg_solve(g, rhs_arr, lam=lam * sigma2, scale=False,
                            tol=tol, maxiter=maxiter)

    if solver in ("cg", "refined"):
        # scaled-G operator: (G/sigma2 + lam I) b = rhs, one block solve
        res = _cg(rhs_np)
        b = np.asarray(res.x, np.float64) * sigma2  # un-scale: see below
        iters = int(res.iterations)
        # the CG solved (Zc Zcᵀ + lam*sigma2 I) b' = rhs, i.e.
        # sigma2 (G_scaled + lam I) b' = rhs  =>  b = sigma2 * b'
    else:
        gmat = grm(g, scale=True, dtype=jnp.float32)
        gmat = gmat + lam * jnp.eye(n, dtype=gmat.dtype)
        b = np.asarray(dense_solve(
            gmat, jnp.asarray(rhs_np, jnp.float32)).x, np.float64)
        iters = 0

    bx, by = b[:, :p], b[:, p]
    xtbx = x.T @ bx
    xtby = x.T @ by
    beta = np.linalg.solve(xtbx, xtby)

    if solver in ("cg", "refined"):
        res_u = _cg((y - x @ beta)[:, None])
        u = np.asarray(res_u.x, np.float64)[:, 0] * sigma2
        iters += int(res_u.iterations)
        if solver == "refined":
            from .solve.cg import grm_matvec_f64

            g_hat = grm_matvec_f64(g, u[:, None])[:, 0] / sigma2
        else:
            g_hat = np.asarray(
                _grm_matvec_of(g)(jnp.asarray(u[:, None], jnp.float32)),
                np.float64)[:, 0] / sigma2
    else:
        u = np.asarray(dense_solve(
            gmat, jnp.asarray((y - x @ beta)[:, None], jnp.float32)).x,
            np.float64)[:, 0]
        g_hat = np.asarray(jnp.matmul(gmat - lam * jnp.eye(n), u,
                                      precision=_HIGHEST), np.float64)

    fitted = x @ beta + g_hat
    return GBLUPResult(beta=beta, g_hat=g_hat, fitted=fitted, pcs=pcs,
                       cg_iterations=iters, u=u)


def snp_effects(g, res: GBLUPResult) -> np.ndarray:
    """Backsolve per-SNP marker effects from a GBLUP fit:

        g_hat = Zc alpha,   alpha = Zc' u / sigma2

    (VanRaden 2008's equivalence of GBLUP and SNP-BLUP) — one packed 't'
    pass on any container.  With alpha in hand, new animals are scored
    WITHOUT re-solving (:func:`predict`) — the 'indirect predictions'
    deployment workflow.
    """
    from .parallel import (ShardedGeno, ShardedGeno2D, pad_indiv_vec,
                           sharded_dgemm, sharded_dgemm_2d)
    from .streamed import StreamedGeno
    from .ops.dgemm import dgemm

    if res.u is None:
        raise ValueError("GBLUPResult has no random-effect solutions "
                         "(fit with solver='cg'/'refined'/'dense')")
    u = res.u[:, None]
    if isinstance(g, StreamedGeno):
        a = np.asarray(g.dgemm(u.astype(np.float32), trans="t",
                               center=True), np.float64)
    elif isinstance(g, ShardedGeno):
        a = np.asarray(sharded_dgemm(g, jnp.asarray(u, jnp.float32),
                                     trans="t", center=True), np.float64)
    elif isinstance(g, ShardedGeno2D):
        a = np.asarray(sharded_dgemm_2d(
            g, pad_indiv_vec(g, jnp.asarray(u, jnp.float32)), trans="t"),
            np.float64)[: g.snps]
    else:
        a = np.asarray(dgemm(g, jnp.asarray(u, jnp.float32), trans="t",
                             center=True), np.float64)
    return a[:, 0] / float(g.sigma2)


def predict(g_new, alpha: np.ndarray, freq_train: np.ndarray) -> np.ndarray:
    """Score NEW animals with backsolved marker effects:
    g_hat_new = (Z_new - 2 f_train) alpha — centering MUST use the
    TRAINING allele frequencies, not the new panel's own."""
    from .ops.dgemm import dgemm

    c = 2.0 * np.asarray(freq_train, np.float32)
    out = dgemm(g_new, jnp.asarray(alpha[:, None], jnp.float32), trans="n",
                center=jnp.asarray(c))
    return np.asarray(out, np.float64)[:, 0]


def simulate_phenotypes(
    geno: np.ndarray,
    h2: float = 0.5,
    n_qtl: int = 100,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Additive phenotype simulation (the role of MoBPS in the reference's
    example): random QTL effects + environmental noise scaled to h2.
    Returns (phenotypes, true breeding values)."""
    rng = np.random.default_rng(seed)
    n, s = geno.shape
    qtl = rng.choice(s, size=min(n_qtl, s), replace=False)
    eff = rng.standard_normal(len(qtl))
    z = np.where(geno == 3, 0, geno).astype(np.float64)
    bv = (z[:, qtl] - z[:, qtl].mean(0)) @ eff
    bv /= bv.std() + 1e-12
    e = rng.standard_normal(n) * np.sqrt((1 - h2) / h2)
    return bv + e, bv


def run_gblup(bed_path: str, h2: float = 0.5, pcs: int = 10,
              solver: str = "cg", stream_chunk: int = 0,
              tol: float = 1e-4, verbose: bool = False,
              estimate_h2: bool = False, h2_method: str = "he",
              maxiter: int = 2000, effects_out: Optional[str] = None) -> int:
    """CLI entry: full pipeline on a .bed fileset; phenotypes from the .fam
    6th column when present, else simulated with known breeding values.

    ``stream_chunk`` > 0 switches to the out-of-core StreamedGeno container
    (SNP chunks of that size, host-resident, device-streamed) — the
    BASELINE config-5 path for panels whose packed form exceeds HBM."""
    from .io import bed as bedio
    from .streamed import StreamedGeno

    if stream_chunk > 0:
        g = StreamedGeno.from_bed(bed_path, chunk_snps=stream_chunk,
                                  verbose=True)
        cached = g.cache_to_device()  # hybrid: pin what fits in free HBM
        print(f"streamed panel: {g.snps} snps x {g.indiv} indiv, "
              f"{g.n_chunks} chunks, {g.nbytes() / 1e9:.1f} GB packed "
              f"({cached} chunks pinned in HBM, rest host-streamed)")
    else:
        g = from_bed(bed_path)
    # phenotype = 6th whitespace column of each .fam line (parse per line:
    # extra columns or odd spacing must not shift the stride)
    with open(bed_path[:-4] + ".fam") as fh:
        pheno_col = np.array([ln.split()[5] for ln in fh if ln.strip()],
                             dtype=object)
    bv_true = None
    # parse per value so ONE bad token cannot flip the whole run to
    # simulated phenotypes (a single 'NA' used to discard every real
    # record with only a one-line notice), and so string 'nan' cannot
    # slip past the missing-value guard as a NaN trait value
    y = np.full(len(pheno_col), np.nan)
    for k, v in enumerate(pheno_col):
        sv = str(v)
        if sv.upper() in ("NA", "NAN", ".", "-9"):
            continue                       # missing codes -> NaN
        try:
            y[k] = float(sv)
        except ValueError:
            raise SystemExit(
                f".fam line {k + 1}: unparseable phenotype {sv!r} "
                "(numeric, or NA/./-9 for missing)")
    y[y == -9.0] = np.nan                  # "-9.0" parses numerically
    n_miss = int(np.isnan(y).sum())
    if 0 < n_miss < len(y):
        # missing among real values: fitting placeholders would silently
        # corrupt the solve
        raise SystemExit(
            f"{n_miss} individuals have missing phenotype (-9/NA) in the "
            ".fam; subset the panel to phenotyped individuals before "
            "running GBLUP")
    if n_miss == len(y):                   # no phenotypes at all: simulate
        if stream_chunk > 0:
            # out-of-core panel: draw QTLs from one SNP window only — the
            # dense fallback below would materialize the full panel
            from .io import codec as _codec

            qwin = min(1024, g.snps)
            plink_slice, _, _ = bedio.read_bed_slice(bed_path, 0, qwin)
            geno = _codec.plink_to_dense(plink_slice, g.indiv)
        else:
            # dense genotypes are only needed for the simulation fallback
            geno, _ = bedio.read_bed_genotypes(bed_path)
        y, bv_true = simulate_phenotypes(geno, h2=h2)
        print("(.fam has no phenotypes — simulated with known BVs)")

    if estimate_h2:
        if h2_method == "reml":
            h2_hat, det = estimate_h2_reml(g, y, verbose=verbose)
            print(f"AI-REML h2 = {h2_hat:.3f} (SE {det['se_h2']:.3f}, "
                  f"{det['iterations']} AI steps, converged="
                  f"{det['converged']}; replacing --h2 {h2})")
        else:
            h2_hat, _ = estimate_h2_he(g, y)
            print(f"HE-estimated h2 = {h2_hat:.3f} (replacing --h2 {h2})")
        h2 = min(max(h2_hat, 0.01), 0.99)

    res = gblup(g, y, h2=h2, n_pcs=pcs, solver=solver, tol=tol,
                maxiter=maxiter, verbose=verbose or stream_chunk > 0)
    print(f"beta: {np.round(res.beta[:3], 4)}... "
          f"(CG iterations: {res.cg_iterations})")
    if bv_true is not None:
        cor = np.corrcoef(res.g_hat, bv_true)[0, 1]
        print(f"cor(estimated BV, true BV) = {cor:.3f}")
    cor_fit = np.corrcoef(res.fitted, y)[0, 1]
    print(f"cor(fitted, phenotype)     = {cor_fit:.3f}")
    if effects_out:
        # marker-effect export for indirect prediction (cli score / the
        # plink --score deployment loop): SNP id + effect allele from the
        # .bim, backsolved dosage effect, training allele frequency.
        # The codec decodes 0b00 (hom A1) to dosage 0, so dosage counts
        # copies of A2 — the effect allele is the .bim's 6th column (A2),
        # matching what plink --score needs to reproduce these scores.
        alpha = snp_effects(g, res)
        freq = np.asarray(g.freq, np.float64)
        bim = bedio.read_bim(bed_path)
        if len(bim) != len(alpha):
            raise SystemExit(f".bim has {len(bim)} SNPs but the panel has "
                             f"{len(alpha)} — fileset out of sync")
        with open(effects_out, "w") as fh:
            fh.write("snp\tallele\teffect\tfreq_train\n")
            for row, a, f in zip(bim, alpha, freq):
                fh.write(f"{row[1]}\t{row[5]}\t{a:.10g}\t{f:.10g}\n")
        print(f"wrote {effects_out}: {len(alpha)} marker effects "
              "(score new panels with `cli score`)")
    return 0


def cross_validate(
    g,
    y: np.ndarray,
    h2: float = 0.5,
    k: int = 5,
    tol: float = 1e-5,
    maxiter: int = 2000,
    seed: int = 0,
):
    """K-fold cross-validated genomic prediction accuracy — the standard
    GBLUP evaluation loop (reference users script it by exporting G; here
    each fold is ONE on-device CG with a masked operator).

    Per fold: solve (G_tt/σ² + λI) u_t = y_t on the TRAINING rows without
    ever slicing G — the operator zero-masks the held-out rows
    (op(v) = m·(G(m·v))/σ² + λ m·v + (1-m)·v keeps the system SPD and the
    held-out components decoupled), then predicts ŷ_test = (G u)/σ²
    restricted to the test rows.  Phenotypes are train-mean-centered per
    fold (intercept-only fixed effects).

    Returns ``(per_fold_correlations, mean_correlation)``.
    """
    import jax.numpy as jnp

    from .solve.cg import cg, grm_matvec

    n = g.indiv
    lam = (1.0 - h2) / h2
    y = np.asarray(y, np.float64).reshape(n)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    folds = np.array_split(perm, k)
    sigma2 = float(g.sigma2)
    cors = []
    for test_idx in folds:
        mask = np.ones(n, np.float32)
        mask[test_idx] = 0.0
        mj = jnp.asarray(mask[:, None])
        ybar = y[mask.astype(bool)].mean()
        yc = (y - ybar) * mask
        b = jnp.asarray(yc[:, None], jnp.float32)

        def op(v, mj=mj):
            gv = grm_matvec(g, mj * v, center=True) / sigma2
            return mj * gv + lam * (mj * v) + (1.0 - mj) * v

        res = cg(op, b, tol=tol, maxiter=maxiter)
        u = np.asarray(res.x, np.float64)
        pred = np.asarray(
            grm_matvec(g, jnp.asarray(u, jnp.float32), center=True),
            np.float64)[:, 0] / sigma2
        yhat = pred[test_idx] + ybar
        cors.append(float(np.corrcoef(yhat, y[test_idx])[0, 1]))
    return np.asarray(cors), float(np.mean(cors))


def _ridge_solver(g, tol: float, maxiter: int):
    """(Z_c Z_cᵀ + lam·I)⁻¹ applied to a numpy RHS block, per-call ``lam``,
    on any container (GenoMatrix / Sharded / 2D / Streamed).  Returns
    ``solve(rhs, lam) -> (x float64, iterations)``.  The single-chip path
    rides :func:`solve.cg.grm_cg_solve`, whose ``lam`` is traced — sweeping
    lambda (REML iterations) reuses one compiled CG executable."""
    from .parallel import ShardedGeno, ShardedGeno2D, sharded_cg_solve
    from .parallel import sharded_cg_solve_2d
    from .solve.cg import grm_cg_solve
    from .streamed import StreamedGeno

    if isinstance(g, StreamedGeno):
        def solve(rhs, lam):
            x, iters, _ = g.cg_solve(rhs, lam=float(lam), scale=False,
                                     tol=tol, maxiter=maxiter,
                                     precondition=True)
            return np.asarray(x, np.float64), int(iters)
    elif isinstance(g, ShardedGeno):
        def solve(rhs, lam):
            r = sharded_cg_solve(g, jnp.asarray(rhs, jnp.float32),
                                 lam=float(lam), tol=tol, maxiter=maxiter,
                                 precondition=True)
            return np.asarray(r.x, np.float64), int(r.iterations)
    elif isinstance(g, ShardedGeno2D):
        def solve(rhs, lam):
            r = sharded_cg_solve_2d(g, jnp.asarray(rhs, jnp.float32),
                                    lam=float(lam), tol=tol, maxiter=maxiter,
                                    precondition=True)
            return np.asarray(r.x, np.float64)[: g.indiv], int(r.iterations)
    else:
        def solve(rhs, lam):
            r = grm_cg_solve(g, jnp.asarray(rhs, jnp.float32), lam=lam,
                             scale=False, tol=tol, maxiter=maxiter,
                             precondition=True)
            return np.asarray(r.x, np.float64), int(r.iterations)
    return solve


def estimate_h2_reml(
    g,
    y: np.ndarray,
    covariates: Optional[np.ndarray] = None,
    n_probes: int = 16,
    probes: Optional[np.ndarray] = None,
    max_iter: int = 30,
    tol: float = 5e-4,
    cg_tol: float = 1e-5,
    cg_maxiter: int = 2000,
    seed: int = 0,
    init_h2: Optional[float] = None,
    verbose: bool = False,
):
    """REML variance components by stochastic AI-REML — the GCTA ``--reml``
    role (a comparator the reference's benchmark suite runs against,
    utils/benchmark/benchmark_suite.jl:230-273) built ONLY from matvec
    primitives, so it runs on single-chip, sharded, and out-of-core panels
    alike with G never materialized.

    Model: y = Xβ + u + e, u ~ N(0, σ²_g·G_s), e ~ N(0, σ²_e·I) with G_s
    the VanRaden-scaled GRM.  Each AI-REML iteration needs V⁻¹ against a
    block of vectors; since V = σ²_g·G_s + σ²_e·I = (σ²_g/σ²)·(Z_cZ_cᵀ +
    λ·I) with λ = σ²_e·σ²/σ²_g, every V⁻¹ is ONE ridge block-CG on the
    packed panel.  The traces in the REML score, tr(P) and tr(P·G_s), are
    Hutchinson estimates over ``n_probes`` Rademacher probes (shared across
    iterations — common random numbers keep the fixed point stable), the
    same trick BOLT-LMM uses to scale REML past explicit matrices.  The
    update is the average-information step

        θ ← θ + AI⁻¹·score,   AI_ij = ½·yᵀP·V_i·P·V_j·P·y

    (exact — no stochastic error: all AI terms are quadratic forms in
    P·y), falling back to an EM step when AI sends a component out of
    bounds.  Per iteration: one block CG with p+1+n_probes RHS, one with
    2 RHS, and one batched G_s matvec.

    ``probes`` overrides the random probes with explicit columns (pass
    ``np.eye(n)`` for exact traces on small panels).  ``init_h2`` seeds
    the iteration (defaults to the Haseman–Elston estimate —
    :func:`estimate_h2_he` — so typically only a few AI steps remain).

    Returns ``(h2, details)``: details carries the variance components on
    the standardized-y scale (``s2g``/``s2e``), their original-scale
    counterparts (``vg``/``ve``, multiplied by var(y)), the delta-method
    ``se_h2`` from the inverse AI matrix, convergence info, and the total
    CG iteration count.
    """
    n = g.indiv
    y = np.asarray(y, np.float64).reshape(n)
    yvar = float(y.var())
    yt = (y - y.mean()) / max(y.std(), 1e-12)
    sigma2 = float(g.sigma2)

    cols = [np.ones((n, 1))]
    if covariates is not None:
        cov = np.asarray(covariates, np.float64)
        cols.append(cov[:, None] if cov.ndim == 1 else cov)
    x = np.concatenate(cols, axis=1)
    p = x.shape[1]

    if probes is None:
        rng = np.random.default_rng(seed)
        z = rng.choice((-1.0, 1.0), size=(n, n_probes))
        exact_traces = False
    else:
        z = np.asarray(probes, np.float64)
        if z.shape[0] != n:
            raise ValueError(f"probes have {z.shape[0]} rows, expected {n}")
        n_probes = z.shape[1]
        # identity probes = exact traces (tr A = sum of diag(A·I))
        exact_traces = (z.shape[1] == n
                        and np.array_equal(z, np.eye(n)))

    gs_mv = _scaled_matvec_of(g)

    solve = _ridge_solver(g, cg_tol, cg_maxiter)

    if init_h2 is None:
        init_h2, _ = estimate_h2_he(g, y, seed=seed)
        if not np.isfinite(init_h2):
            init_h2 = 0.5
    s2g = float(np.clip(init_h2, 0.05, 0.95))
    s2e = 1.0 - s2g
    floor = 1e-6

    gz = gs_mv(z)                       # G_s·probes, reused every iteration
    cg_total = 0
    converged = False
    ai = np.eye(2)
    for it in range(max_iter):
        lam = s2e * sigma2 / s2g
        block = np.concatenate([x, yt[:, None], z], axis=1)
        sol, iters = solve(block, lam)
        cg_total += iters
        sol *= sigma2 / s2g             # (ZZᵀ+λI)⁻¹ → V⁻¹
        vinv_x, vinv_y, vinv_z = sol[:, :p], sol[:, p], sol[:, p + 1:]

        xtvx = x.T @ vinv_x
        xtvx = 0.5 * (xtvx + xtvx.T)
        c = np.linalg.inv(xtvx)

        def proj(vinv_w):
            return vinv_w - vinv_x @ (c @ (x.T @ vinv_w))

        py = proj(vinv_y[:, None])[:, 0]
        pz = proj(vinv_z)

        gspy = gs_mv(py[:, None])[:, 0]
        ypgpy = float(py @ gspy)
        yppy = float(py @ py)
        if exact_traces:
            # pz = P, gz = G_s: tr(P·G_s) = Σ_ij P_ij (G_s)_ij (symmetric)
            tr_pg = float((pz * gz).sum())
            tr_p = float(np.trace(pz))
        else:
            tr_pg = float(np.mean(np.sum(pz * gz, axis=0)))
            tr_p = float(np.mean(np.sum(z * pz, axis=0)))

        score = np.array([-0.5 * (tr_pg - ypgpy), -0.5 * (tr_p - yppy)])

        sol2, iters2 = solve(np.stack([gspy, py], axis=1), lam)
        cg_total += iters2
        sol2 *= sigma2 / s2g
        pw = proj(sol2)                 # [P·G_s·P·y, P·P·y]
        ai = 0.5 * np.array([
            [gspy @ pw[:, 0], gspy @ pw[:, 1]],
            [py @ pw[:, 0], py @ pw[:, 1]],
        ])
        ai = 0.5 * (ai + ai.T)

        theta = np.array([s2g, s2e])
        try:
            delta = np.linalg.solve(ai, score)
            new = theta + delta
        except np.linalg.LinAlgError:
            new = np.array([np.nan, np.nan])
        if not np.all(np.isfinite(new)) or (new < floor).any() or \
                new.sum() > 10.0:
            # EM fallback: θ_i ← θ_i + θ_i²·(yᵀPV_iPy − tr(PV_i))/n
            quad = np.array([ypgpy, yppy])
            tr = np.array([tr_pg, tr_p])
            new = theta + theta ** 2 * (quad - tr) / n
            new = np.clip(new, floor, 10.0)
        step = float(np.abs(new - theta).max() / max(new.sum(), 1e-12))
        s2g, s2e = float(new[0]), float(new[1])
        if verbose:
            print(f"  reml iter {it + 1}: s2g={s2g:.4f} s2e={s2e:.4f} "
                  f"score=({score[0]:+.3e},{score[1]:+.3e}) step={step:.2e}",
                  flush=True)
        if step < tol:
            converged = True
            break

    h2 = s2g / (s2g + s2e)
    se_h2 = float("nan")
    try:
        cov_theta = np.linalg.inv(ai)
        grad = np.array([s2e, -s2g]) / (s2g + s2e) ** 2
        v = float(grad @ cov_theta @ grad)
        se_h2 = float(np.sqrt(v)) if v > 0 else float("nan")
    except np.linalg.LinAlgError:
        pass
    return float(h2), {
        "s2g": s2g, "s2e": s2e,
        "vg": s2g * yvar, "ve": s2e * yvar,
        "se_h2": se_h2, "iterations": it + 1, "converged": converged,
        "cg_iterations": cg_total, "n_probes": n_probes,
        "exact_traces": exact_traces,
    }


def estimate_h2_he(
    g,
    y: np.ndarray,
    n_probes: int = 16,
    seed: int = 0,
):
    """Haseman–Elston regression estimate of SNP heritability h² — from
    matvec-only primitives, G never materialized:

        ĥ² = Σ_{i≠j} G_ij ỹ_i ỹ_j / Σ_{i≠j} G_ij²
           = (ỹᵀGỹ - Σ_i G_ii ỹ_i²) / (tr(G²) - Σ_i G_ii²)

    with ỹ the standardized phenotype, ỹᵀGỹ ONE on-device matvec, the
    diagonal the exact one-pass `solve.grm_diag`, and tr(G²) a Hutchinson
    estimate (mean over Rademacher probes z of ‖Gz‖² — ``n_probes``
    matvecs batched as one block).  The reference pipeline takes variance
    ratios as INPUT; this closes the loop so `gblup(h2=...)` can be fed
    from the data.  Returns ``(h2_hat, details dict)``; the estimate is
    clipped to [0, 1].
    """
    n = g.indiv
    y = np.asarray(y, np.float64).reshape(n)
    yt = (y - y.mean()) / max(y.std(), 1e-12)
    sigma2 = float(g.sigma2)

    diag = _grm_diag_of(g) / sigma2
    mv = _scaled_matvec_of(g)   # container dispatch lives in ONE place

    gy = mv(yt[:, None])[:, 0]
    num = float(yt @ gy - (diag * yt * yt).sum())

    rng = np.random.default_rng(seed)
    zprobes = rng.choice((-1.0, 1.0), size=(n, n_probes))
    gz = mv(zprobes)
    tr_g2 = float(np.mean(np.sum(gz * gz, axis=0)))
    den = tr_g2 - float((diag * diag).sum())
    h2 = num / den if den > 0 else float("nan")
    return float(np.clip(h2, 0.0, 1.0)), {
        "numerator": num, "trace_g2_estimate": tr_g2,
        "diag_sq_sum": float((diag * diag).sum()), "n_probes": n_probes,
    }


def _multi_v_solver(g, t: int, dG: np.ndarray, cg_tol: float,
                    cg_maxiter: int):
    """ON-DEVICE block-CG for V = (Sg ⊗ G_s) + (Se ⊗ I) over trait pages
    [n, t, m] — the inner solve of :func:`estimate_multi_reml`.

    The whole CG is one jitted XLA program (matvec = ONE batched packed
    G-pass over t·m flattened columns + two [t, t] einsum mixes + the
    Jacobi multiply), with Sg/Se TRACED arguments: every AI-REML iteration
    and both of its per-iteration solves reuse the same compiled
    executable per RHS width, and nothing crosses host<->device until
    convergence (the univariate path's traced-λ trick, generalized to
    traced component matrices).  The container rides through jit as a
    pytree ARGUMENT (not a closure capture — captured packed panels embed
    as HLO constants, the ssGBLUP HTTP-413 lesson).

    Returns ``solve(b3 [n, t, m] f64, sg, se) -> (x3 f64, iterations)``.
    StreamedGeno takes the :func:`_multi_v_solver_streamed` route: the
    chunk loop cannot live inside one XLA program, but every VECTOR of the
    CG stays device-resident and each chunk pass is the jitted packed
    kernel (chunks pin in HBM via ``cache_to_device`` when they fit) —
    only convergence scalars cross to the host, instead of a full-f64
    host loop of einsums."""
    from .parallel import ShardedGeno, ShardedGeno2D
    from .streamed import StreamedGeno

    if isinstance(g, StreamedGeno):
        return _multi_v_solver_streamed(g, t, dG, cg_tol, cg_maxiter)
    n = g.indiv
    sigma2 = float(g.sigma2)
    dgj = jnp.asarray(dG, jnp.float32)

    # meshes resolve OUTSIDE jit (tracers carry no .sharding — the
    # sharded_cg_solve lesson) and ride in as statics
    if isinstance(g, ShardedGeno):
        from .parallel.sharded import _mesh_of
        kind, mesh = "sharded", _mesh_of(g)
    elif isinstance(g, ShardedGeno2D):
        from .parallel.sharded2d import _mesh_of as _mesh2_of
        kind, mesh = "sharded2d", _mesh2_of(g)
    else:
        kind, mesh = "geno", None

    def solve(b3, sg, se):
        m = int(b3.shape[2])
        x3, iters = _multi_v_cg(
            g, jnp.asarray(b3, jnp.float32).reshape(n * t, m),
            jnp.asarray(sg, jnp.float32), jnp.asarray(se, jnp.float32),
            dgj, kind=kind, n=n, t=t, m=m, sigma2=sigma2, cg_tol=cg_tol,
            cg_maxiter=cg_maxiter, mesh=mesh)
        return np.asarray(x3, np.float64), int(iters)

    return solve


def _multi_v_solver_streamed(g, t: int, dG: np.ndarray, cg_tol: float,
                             cg_maxiter: int):
    """Streamed-panel inner V-solve, two regimes:

    - every chunk pinned in HBM (``cache_to_device`` cached all of them):
      the WHOLE CG compiles to one XLA program (:func:`_multi_v_cg_cached`
      — chunks ride through jit as a pytree tuple, the chunk loop unrolls
      inside the trace, one dispatch per solve).  This is the common
      mid-size case, where a host-f64 loop would pay per-op dispatch and
      host einsums.
    - genuinely out-of-core (chunks overflow HBM): a device-vector CG
      whose G matvec streams chunks through the packed kernels eagerly
      (H2D per chunk per pass dominates there anyway); only convergence
      scalars cross to the host."""
    import jax.numpy as jnp

    from .ops.dgemm import dgemm as _sdgemm

    n = g.indiv
    sigma2 = float(g.sigma2)

    def _all_cached():
        return all(not isinstance(c.zq_n, np.ndarray)
                   and not isinstance(c.zq_t, np.ndarray)
                   for c in g.chunks)

    if not _all_cached():
        g.cache_to_device()        # pins what fits; overflow chunks stream
    dgj = jnp.asarray(dG, jnp.float32)

    if _all_cached():
        chunks = tuple(g.chunks)

        def solve(b3, sg, se):
            m = int(b3.shape[2])
            x3, iters = _multi_v_cg_cached(
                chunks, jnp.asarray(b3, jnp.float32),
                jnp.asarray(sg, jnp.float32), jnp.asarray(se, jnp.float32),
                dgj, n=n, t=t, m=m, sigma2=sigma2, cg_tol=cg_tol,
                cg_maxiter=cg_maxiter)
            return np.asarray(x3, np.float64), int(iters)

        return solve

    def raw(flat):                               # [n, k] device -> G·flat
        acc = jnp.zeros((n, flat.shape[1]), jnp.float32)
        for gck in g.chunks:
            u = _sdgemm(gck, flat, trans="t", center=True)
            acc = acc + _sdgemm(gck, u, trans="n", center=True)
        return acc

    def solve(b3, sg, se):
        m = int(b3.shape[2])
        sgj = jnp.asarray(sg, jnp.float32)
        sej = jnp.asarray(se, jnp.float32)

        def vop(v3):                             # [n, t, m] device
            flat = v3.transpose(0, 2, 1).reshape(n, t * m)
            gw = (raw(flat) / sigma2).reshape(n, m, t).transpose(0, 2, 1)
            return (jnp.einsum("ab,nbm->nam", sgj, gw, precision=_HIGHEST)
                    + jnp.einsum("ab,nbm->nam", sej, v3,
                                 precision=_HIGHEST))

        d = dgj[:, None] * jnp.diag(sgj)[None, :] + jnp.diag(sej)[None, :]
        minv = (1.0 / jnp.maximum(d, 1e-12))[:, :, None]
        b = jnp.asarray(b3, jnp.float32)
        x = jnp.zeros_like(b)
        r = b
        z = minv * r
        p = z
        rz = jnp.einsum("ntm,ntm->m", r, z, precision=_HIGHEST)
        bn = jnp.sqrt(jnp.einsum("ntm,ntm->m", b, b, precision=_HIGHEST))
        bn = jnp.where(bn == 0, 1.0, bn)
        it = 0
        for it in range(1, cg_maxiter + 1):
            vp = vop(p)
            pvp = jnp.einsum("ntm,ntm->m", p, vp, precision=_HIGHEST)
            alpha = jnp.where(pvp > 0, rz / jnp.maximum(pvp, 1e-30), 0.0)
            x = x + alpha[None, None, :] * p
            r = r - alpha[None, None, :] * vp
            rn = jnp.sqrt(jnp.einsum("ntm,ntm->m", r, r, precision=_HIGHEST))
            if float(jnp.max(rn / bn)) < cg_tol:   # the one host sync
                break
            z = minv * r
            rz_new = jnp.einsum("ntm,ntm->m", r, z, precision=_HIGHEST)
            beta = jnp.where(rz > 0, rz_new / jnp.maximum(rz, 1e-30), 0.0)
            p = z + beta[None, None, :] * p
            rz = rz_new
        return np.asarray(x, np.float64), it

    return solve


@_functools.partial(
    _jax.jit,
    static_argnames=("n", "t", "m", "sigma2", "cg_tol", "cg_maxiter"))
def _multi_v_cg_cached(chunks, b3, sgj, sej, dgj, *, n, t, m, sigma2,
                       cg_tol, cg_maxiter):
    """Fully-compiled streamed inner CG for HBM-cached chunk tuples: the
    chunk loop unrolls inside the trace (static chunk count), so the whole
    nested solve is one XLA program — the _multi_v_cg counterpart for a
    StreamedGeno whose packings all fit device memory."""
    import jax.numpy as jnp

    from .ops.dgemm import dgemm as _sdgemm
    from .solve.cg import cg as _cg

    b = b3.reshape(n * t, m)

    def raw(flat):
        acc = jnp.zeros((n, flat.shape[1]), jnp.float32)
        for gck in chunks:
            u = _sdgemm(gck, flat, trans="t", center=True)
            acc = acc + _sdgemm(gck, u, trans="n", center=True)
        return acc

    def op(v):                                    # v [n*t, m]
        pages = v.reshape(n, t, m)
        flat = pages.transpose(0, 2, 1).reshape(n, t * m)
        gw = (raw(flat) / sigma2).reshape(n, m, t).transpose(0, 2, 1)
        out = (jnp.einsum("ab,nbm->nam", sgj, gw, precision=_HIGHEST)
               + jnp.einsum("ab,nbm->nam", sej, pages, precision=_HIGHEST))
        return out.reshape(n * t, m)

    d = (dgj[:, None] * jnp.diag(sgj)[None, :]
         + jnp.diag(sej)[None, :])                # [n, t]
    minv = 1.0 / jnp.maximum(d, 1e-12)
    norm = jnp.linalg.norm(b, axis=0, keepdims=True)
    safe = jnp.where(norm > 0, norm, 1.0)
    r = _cg(op, b / safe, tol=cg_tol, maxiter=cg_maxiter,
            minv=minv.reshape(n * t))
    return (r.x * safe).reshape(n, t, m), r.iterations


@_functools.partial(
    _jax.jit,
    static_argnames=("kind", "n", "t", "m", "sigma2", "cg_tol",
                     "cg_maxiter", "mesh"))
def _multi_v_cg(gm, b, sgj, sej, dgj, *, kind, n, t, m, sigma2, cg_tol,
                cg_maxiter, mesh):
    """The jitted body of :func:`_multi_v_solver` — MODULE-level so the
    executable persists across estimate_multi_reml invocations (a fresh
    per-call closure would recompile on every REML call)."""
    from .parallel import pad_indiv_vec, sharded_dgemm_2d, sharded_grm_matvec
    from .solve.cg import cg as _cg

    if kind == "sharded":
        def raw(flat):
            return sharded_grm_matvec(gm, flat, mesh=mesh)
    elif kind == "sharded2d":
        def raw(flat):
            vp = pad_indiv_vec(gm, flat, mesh=mesh)
            zv = sharded_dgemm_2d(gm, vp, trans="t", mesh=mesh)
            snpmask = (jnp.arange(zv.shape[0]) < gm.snps).astype(zv.dtype)
            gv = sharded_dgemm_2d(gm, zv * snpmask[:, None], trans="n",
                                  mesh=mesh)
            return gv[: gm.indiv]
    else:
        def raw(flat):
            return grm_matvec(gm, flat)

    def op(v):                                    # v [n*t, m], vec(n, t)
        pages = v.reshape(n, t, m)
        flat = pages.transpose(0, 2, 1).reshape(n, t * m)
        gw = (raw(flat) / sigma2).reshape(n, m, t).transpose(0, 2, 1)
        out = (jnp.einsum("ab,nbm->nam", sgj, gw, precision=_HIGHEST)
               + jnp.einsum("ab,nbm->nam", sej, pages, precision=_HIGHEST))
        return out.reshape(n * t, m)

    # diag(V) = diag(G_s) ⊗ diag(Sg) + 1 ⊗ diag(Se), traced with Sg/Se
    d = (dgj[:, None] * jnp.diag(sgj)[None, :]
         + jnp.diag(sej)[None, :])                # [n, t]
    minv = 1.0 / jnp.maximum(d, 1e-12)
    # per-column RHS normalization: the generic cg's tol is ABSOLUTE,
    # the REML contract (host loop) is relative rn/||b||
    norm = jnp.linalg.norm(b, axis=0, keepdims=True)
    safe = jnp.where(norm > 0, norm, 1.0)
    r = _cg(op, b / safe, tol=cg_tol, maxiter=cg_maxiter,
            minv=minv.reshape(n * t))
    return (r.x * safe).reshape(n, t, m), r.iterations


def estimate_multi_reml(
    g,
    ys: np.ndarray,
    covariates=None,
    n_probes: int = 8,
    probes=None,
    max_iter: int = 40,
    tol: float = 5e-4,
    cg_tol: float = 1e-5,
    cg_maxiter: int = 2000,
    seed: int = 0,
    verbose: bool = False,
    device_cg: bool = True,
):
    """Multivariate (t-trait) REML on the implicit Kronecker operator —
    the generalization of gcta64's --reml-bivar to ANY number of traits
    (GCTA itself stops at two; WOMBAT-class capability), from matvec
    primitives only so G is never materialized and every container
    (single-chip / sharded / streamed) serves.

    Model (traits standardized to unit variance internally):

        vec(Y) = X β + u + e,  u ~ N(0, Sg ⊗ G_s),  e ~ N(0, Se ⊗ I)

    with Sg, Se the t x t genetic / residual covariance matrices —
    t·(t+1) components.  V·W for W [n, t, m] is G_s W Sgᵀ + W Seᵀ: ONE
    batched packed matvec over [n, t·m] columns per operator application,
    so every V⁻¹ block is a Jacobi block-CG.  Machinery mirrors
    :func:`estimate_h2_reml`: Hutchinson traces with common random
    numbers (``probes=np.eye(t·n)`` = exact traces, vec order
    trait-major per individual), EXACT average-information quadratic
    forms, AI⁻¹·score updates with step-halving and eigenvalue-clipped
    projection into the PSD cone.

    This closes the loop for :func:`multi_trait_gblup`, which takes
    Su/Se as INPUT — estimate them here first.

    Returns ``(Sg, Se, details)``: the standardized-scale covariance
    matrices plus per-trait h², pairwise genetic correlations ``rg``
    [t, t], delta-method SEs, and convergence/CG counters.

    ``device_cg=True`` (default) runs every inner V⁻¹ as one jitted
    on-device block-CG with traced Sg/Se (:func:`_multi_v_solver`;
    StreamedGeno panels get the device-vector streamed CG,
    :func:`_multi_v_solver_streamed`); ``False`` forces the host-numpy
    f64 loop (the oracle for both device paths).
    """
    n = g.indiv
    ys = np.asarray(ys, np.float64)
    if ys.ndim != 2 or ys.shape[0] != n:
        raise ValueError(f"ys must be [n_indiv, n_traits]; got {ys.shape}")
    t = ys.shape[1]
    if t < 2:
        raise ValueError("need >= 2 traits (univariate: estimate_h2_reml)")
    if not np.isfinite(ys).all():
        raise ValueError("estimate_multi_reml needs complete records on "
                         "every trait (no NaN)")
    yt = (ys - ys.mean(axis=0)) / np.maximum(ys.std(axis=0), 1e-12)

    gs_mv = _scaled_matvec_of(g)
    dG = _grm_diag_of(g) / float(g.sigma2)   # exact diag(G_s), for Jacobi

    # components: (kind, a, b) for kind in (g, e), pairs a <= b row-major
    pairs = [(a, b) for a in range(t) for b in range(a, t)]
    ncomp = 2 * len(pairs)

    # fixed effects: per-trait intercept (+ shared covariate columns)
    cols = [np.ones((n, 1))]
    if covariates is not None:
        cov = np.asarray(covariates, np.float64)
        cols.append(cov[:, None] if cov.ndim == 1 else cov)
    xc = np.concatenate(cols, axis=1)
    p = xc.shape[1]
    x3 = np.zeros((n, t, t * p))
    for a in range(t):
        x3[:, a, a * p:(a + 1) * p] = xc

    if probes is None:
        rng = np.random.default_rng(seed)
        z3 = rng.choice((-1.0, 1.0), size=(n, t, n_probes))
        exact_traces = False
    else:
        z = np.asarray(probes, np.float64)
        if z.shape[0] != t * n:
            raise ValueError(f"probes must have {t * n} rows (vec order: "
                             "trait-major per individual)")
        n_probes = z.shape[1]
        z3 = z.reshape(n, t, n_probes)
        exact_traces = (n_probes == t * n and np.array_equal(z, np.eye(t * n)))

    def batched_g(w3):
        """G_s over every trait slice: [n, t, m] -> [n, t, m], ONE pass."""
        m = w3.shape[2]
        flat = w3.transpose(0, 2, 1).reshape(n, t * m)  # no copy semantics
        gflat = gs_mv(np.ascontiguousarray(flat))
        return gflat.reshape(n, m, t).transpose(0, 2, 1)

    def v_op(w3, sg, se):
        gw = batched_g(w3)
        return (np.einsum("ab,nbm->nam", sg, gw)
                + np.einsum("ab,nbm->nam", se, w3))

    def v_solve_host(b3, sg, se):
        """Host-numpy f64 Jacobi block-CG — the oracle for the device path
        and the StreamedGeno route (host-callback matvec can't trace)."""
        d = (np.outer(dG, np.diag(sg)) + np.diag(se)[None, :])  # [n, t]
        minv = (1.0 / np.maximum(d, 1e-12))[:, :, None]
        x = np.zeros_like(b3)
        r = b3.copy()
        zv = minv * r
        pv = zv.copy()
        rz = np.einsum("ntm,ntm->m", r, zv)
        bnorm = np.sqrt(np.einsum("ntm,ntm->m", b3, b3))
        bnorm[bnorm == 0] = 1.0
        it = 0
        for it in range(1, cg_maxiter + 1):
            vp = v_op(pv, sg, se)
            pvp = np.einsum("ntm,ntm->m", pv, vp)
            alpha = np.where(pvp > 0, rz / np.maximum(pvp, 1e-300), 0.0)
            x += alpha[None, None, :] * pv
            r -= alpha[None, None, :] * vp
            rn = np.sqrt(np.einsum("ntm,ntm->m", r, r))
            if (rn / bnorm < cg_tol).all():
                break
            znew = minv * r
            rz_new = np.einsum("ntm,ntm->m", r, znew)
            beta = np.where(rz > 0, rz_new / np.maximum(rz, 1e-300), 0.0)
            pv = znew + beta[None, None, :] * pv
            rz = rz_new
        return x, it

    # inner V⁻¹: one compiled on-device CG per RHS width, Sg/Se traced
    # (a host loop would pay one D2H/H2D per iteration)
    v_solve = (_multi_v_solver(g, t, dG, cg_tol, cg_maxiter)
               if device_cg else None) or v_solve_host

    def vi_apply(w3, gw=None):
        """[V_i w] for every component, order: g-pairs then e-pairs."""
        if gw is None:
            gw = batched_g(w3)
        out = []
        for src in (gw, w3):
            for a, b in pairs:
                o = np.zeros_like(w3)
                o[:, a, :] += src[:, b, :]
                if a != b:
                    o[:, b, :] += src[:, a, :]
                out.append(o)
        return out

    # --- init: per-trait HE diagonals + cross-trait HE covariances --------
    rngd = np.random.default_rng(seed)
    zh = rngd.choice((-1.0, 1.0), size=(n, max(n_probes, 8)))
    gzh = gs_mv(zh)
    den = float(np.mean(np.sum(gzh * gzh, axis=0)) - (dG * dG).sum())
    gy = gs_mv(yt)                                    # G_s Y, one pass
    sg0 = np.empty((t, t))
    for a in range(t):
        for b in range(a, t):
            num = float(yt[:, a] @ gy[:, b] - (dG * yt[:, a] * yt[:, b]).sum())
            sg0[a, b] = sg0[b, a] = num / den if den > 0 else (0.5 if a == b
                                                               else 0.0)
    sg = _project_psd(sg0, floor=0.05, cap=0.95)
    se = _project_psd(np.corrcoef(yt.T) - sg, floor=0.05, cap=None)

    theta = np.concatenate([[sg[a, b] for a, b in pairs],
                            [se[a, b] for a, b in pairs]])

    def unpack(th):
        sgm = np.zeros((t, t))
        sem = np.zeros((t, t))
        for k, (a, b) in enumerate(pairs):
            sgm[a, b] = sgm[b, a] = th[k]
            sem[a, b] = sem[b, a] = th[len(pairs) + k]
        return sgm, sem

    floor = 1e-6

    def valid_magnitude(th):
        if not np.all(np.isfinite(th)):
            return False
        sgm, sem = unpack(th)
        return np.diag(sgm).max() + np.diag(sem).max() < 10.0

    def valid(th):
        if not valid_magnitude(th):
            return False
        sgm, sem = unpack(th)
        return (np.linalg.eigvalsh(sgm)[0] >= -1e-9
                and np.linalg.eigvalsh(sem)[0] >= floor / 2)

    y3 = yt.reshape(n, t, 1)
    gz3 = None
    cg_total = 0
    converged = False
    ai = np.eye(ncomp)
    it_outer = 0
    for it_outer in range(1, max_iter + 1):
        sg, se = unpack(theta)
        block = np.concatenate([x3, y3, z3], axis=2)
        sol, iters = v_solve(block, sg, se)
        cg_total += iters
        vinv_x = sol[:, :, : t * p]
        vinv_y = sol[:, :, t * p: t * p + 1]
        vinv_z = sol[:, :, t * p + 1:]

        xtvx = np.einsum("ntp,ntq->pq", x3, vinv_x)
        xtvx = 0.5 * (xtvx + xtvx.T)
        cmat = np.linalg.inv(xtvx)

        def proj(vw):
            return vw - np.einsum(
                "ntp,pm->ntm", vinv_x,
                cmat @ np.einsum("ntp,ntm->pm", x3, vw))

        py3 = proj(vinv_y)
        pz3 = proj(vinv_z)

        u_list = vi_apply(py3)
        quad = np.array([float(np.einsum("ntm,ntm->", py3, u))
                         for u in u_list])

        if gz3 is None:
            gz3 = batched_g(z3)
        viz = vi_apply(z3, gw=gz3)
        red = np.sum if exact_traces else (lambda a: np.mean(a))
        tr = np.array([float(red(np.einsum("ntm,ntm->m", pz3, vz)))
                       for vz in viz])
        score = -0.5 * (tr - quad)

        u3 = np.concatenate(u_list, axis=2)
        solu, iters2 = v_solve(u3, sg, se)
        cg_total += iters2
        pu3 = proj(solu)
        ai = 0.5 * np.einsum("nti,ntj->ij", u3, pu3)
        ai = 0.5 * (ai + ai.T)

        try:
            delta = np.linalg.solve(ai, score)
        except np.linalg.LinAlgError:
            delta = score / max(n, 1)
        new = theta + delta
        halvings = 0
        # step-halve into the PSD cone.  NB: at a BOUNDARY optimum (rank-
        # deficient Sg-hat — generic at small n) halving converges to a
        # point slightly short of the constrained optimum (measured ~0.1
        # nll on a 72x3 panel; projection-based alternatives destabilized
        # V when Sg and Se share a near-null direction and were discarded)
        while not valid(new) and halvings < 12:
            delta *= 0.5
            new = theta + delta
            halvings += 1
        if not valid(new):
            sgm, sem = unpack(theta + delta)
            sgm = _project_psd(sgm, floor=0.0, cap=None)
            sem = _project_psd(sem, floor=floor, cap=None)
            new = np.concatenate([[sgm[a, b] for a, b in pairs],
                                  [sem[a, b] for a, b in pairs]])
        step = float(np.abs(new - theta).max()
                     / max(float(np.abs(new).sum()), 1e-12))
        theta = new
        if verbose:
            sgm, sem = unpack(theta)
            print(f"  multi-reml iter {it_outer}: diag(Sg)="
                  f"{np.round(np.diag(sgm), 3)} diag(Se)="
                  f"{np.round(np.diag(sem), 3)} step={step:.2e} "
                  f"halvings={halvings}", flush=True)
        if step < tol:
            converged = True
            break

    sg, se = unpack(theta)
    dg_, de_ = np.diag(sg), np.diag(se)
    h2 = dg_ / np.maximum(dg_ + de_, 1e-24)
    denom = np.sqrt(np.maximum(np.outer(dg_, dg_), 1e-24))
    rg = sg / denom
    np.fill_diagonal(rg, 1.0)

    se_h2 = np.full(t, np.nan)
    se_rg = np.full((t, t), np.nan)
    try:
        cov_t = np.linalg.inv(ai)
        gidx = {pr: k for k, pr in enumerate(pairs)}
        for a in range(t):
            gr = np.zeros(ncomp)
            tot = dg_[a] + de_[a]
            gr[gidx[(a, a)]] = de_[a] / tot ** 2
            gr[len(pairs) + gidx[(a, a)]] = -dg_[a] / tot ** 2
            v = float(gr @ cov_t @ gr)
            se_h2[a] = np.sqrt(v) if v > 0 else np.nan
        for a in range(t):
            for b in range(a + 1, t):
                sq = np.sqrt(dg_[a] * dg_[b])
                gr = np.zeros(ncomp)
                gr[gidx[(a, a)]] = -0.5 * sg[a, b] / (dg_[a] * sq)
                gr[gidx[(b, b)]] = -0.5 * sg[a, b] / (dg_[b] * sq)
                gr[gidx[(a, b)]] = 1.0 / sq
                v = float(gr @ cov_t @ gr)
                se_rg[a, b] = se_rg[b, a] = np.sqrt(v) if v > 0 else np.nan
    except np.linalg.LinAlgError:
        pass
    return sg, se, {
        "h2": h2, "rg": rg, "se_h2": se_h2, "se_rg": se_rg,
        "iterations": it_outer, "converged": converged,
        "cg_iterations": cg_total, "n_probes": n_probes,
        "exact_traces": exact_traces, "n_traits": t,
    }


def _project_psd(m, floor=0.0, cap=None):
    """Nearest (Frobenius) symmetric PSD matrix with eigenvalues clipped
    to [floor, cap]."""
    m = 0.5 * (m + m.T)
    w, v = np.linalg.eigh(m)
    w = np.clip(w, floor, cap)
    return (v * w) @ v.T


def estimate_bivar_reml(
    g,
    y1: np.ndarray,
    y2: np.ndarray,
    covariates=None,
    n_probes: int = 8,
    probes=None,
    max_iter: int = 40,
    tol: float = 5e-4,
    cg_tol: float = 1e-5,
    cg_maxiter: int = 2000,
    seed: int = 0,
    verbose: bool = False,
):
    """Bivariate REML — genetic correlation between two traits (the
    gcta64 ``--reml-bivar`` role).  Thin wrapper over the t-trait
    :func:`estimate_multi_reml` (see there for the model and machinery);
    kept for the two-trait API: returns ``(rg, details)`` with the six
    named components g11/g22/g12/e11/e22/e12 and scalar SEs.
    """
    ys = np.stack([np.asarray(y1, np.float64).reshape(-1),
                   np.asarray(y2, np.float64).reshape(-1)], axis=1)
    sg, se, det = estimate_multi_reml(
        g, ys, covariates=covariates, n_probes=n_probes, probes=probes,
        max_iter=max_iter, tol=tol, cg_tol=cg_tol, cg_maxiter=cg_maxiter,
        seed=seed, verbose=verbose)
    rg = float(det["rg"][0, 1])
    return rg, {
        "g11": float(sg[0, 0]), "g22": float(sg[1, 1]),
        "g12": float(sg[0, 1]),
        "e11": float(se[0, 0]), "e22": float(se[1, 1]),
        "e12": float(se[0, 1]),
        "h2_1": float(det["h2"][0]), "h2_2": float(det["h2"][1]),
        "se_rg": float(det["se_rg"][0, 1]),
        "se_h2_1": float(det["se_h2"][0]),
        "se_h2_2": float(det["se_h2"][1]),
        "iterations": det["iterations"], "converged": det["converged"],
        "cg_iterations": det["cg_iterations"],
        "n_probes": det["n_probes"], "exact_traces": det["exact_traces"],
    }


@dataclasses.dataclass
class MTGBLUPResult:
    beta: np.ndarray        # fixed effects [p, t]
    g_hat: np.ndarray       # breeding values [n, t]
    fitted: np.ndarray      # [n, t]
    cg_iterations: int = 0


def multi_trait_gblup(
    g,
    y: np.ndarray,
    su: np.ndarray,
    se: np.ndarray,
    covariates: Optional[np.ndarray] = None,
    tol: float = 1e-5,
    maxiter: int = 2000,
) -> MTGBLUPResult:
    """Multi-trait GBLUP with KNOWN (co)variance matrices: t traits on the
    same animals,

        vec(U) ~ N(0, Su ⊗ G_s),   vec(E) ~ N(0, Se ⊗ I)

    (Su/Se [t, t]: genetic and residual covariances, e.g. from univariate
    REML h2's + literature genetic correlations).  Beyond-parity: the
    reference pipeline is single-trait (calculate_gblup.jl).

    Device shape: the Kronecker operator never materializes —
    (Su ⊗ G) vec(V) = vec(G V Su'), so one V-matvec is ONE batched packed
    G-pass over all traits plus two [t, t] mixes; the GLS normal equations
    and the BLUP are solved by a single block CG over the t*p + 1
    stacked pages.  Jacobi preconditioning from diag(V) =
    Su_jj * diag(G_s) + Se_jj.
    """
    import jax

    from .solve.cg import cg

    from .streamed import StreamedGeno

    if isinstance(g, StreamedGeno):
        raise TypeError(
            "multi_trait_gblup needs a jittable matvec (the whole solve "
            "is one XLA program); StreamedGeno's host-callback matvec "
            "cannot trace — materialize or shard the panel instead")
    n = g.indiv
    y = np.asarray(y, np.float64)
    if y.ndim != 2 or y.shape[0] != n:
        raise ValueError(f"y must be [indiv, traits], got {y.shape}")
    t = y.shape[1]
    su = np.asarray(su, np.float64)
    se = np.asarray(se, np.float64)
    if su.shape != (t, t) or se.shape != (t, t):
        raise ValueError("su/se must be [t, t]")
    # NaN = missing (animal, trait) cell: the solve restricts V to the
    # observed cells (op masks in/out, i.e. S' V_obs S on the padded
    # grid) while the BLUP below still predicts EVERY cell — the
    # borrow-across-traits case that motivates multi-trait models
    mask = ~np.isnan(y)
    if not mask.any():
        raise ValueError("y has no observed cells")
    mf = mask.astype(np.float64)
    y0 = np.where(mask, y, 0.0)
    maskj = jnp.asarray(mf, jnp.float32)[:, :, None]

    cols = [np.ones((n, 1))]
    if covariates is not None:
        cov = np.asarray(covariates, np.float64)
        cols.append(cov[:, None] if cov.ndim == 1 else cov)
    x = np.concatenate(cols, axis=1)
    p = x.shape[1]

    gmv = _grm_matvec_of(g)
    sigma2 = float(g.sigma2)
    suj = jnp.asarray(su, jnp.float32)
    sej = jnp.asarray(se, jnp.float32)

    def vmat(pages):
        """V @ pages for pages [n, t, k]: G P Su + P Se per page."""
        flat = pages.reshape(n, -1)
        gp = (gmv(flat) / sigma2).reshape(n, t, -1)
        return (jnp.einsum("ntk,ts->nsk", gp, suj, precision=_HIGHEST)
                + jnp.einsum("ntk,ts->nsk", pages, sej, precision=_HIGHEST))

    def op(v):  # cg wants [n*t, k]; zero-padded at unobserved cells
        pages = v.reshape(n, t, -1) * maskj
        return (vmat(pages) * maskj).reshape(n * t, -1)

    gdiag = _grm_diag_of(g) / sigma2
    dv = (gdiag[:, None] * np.diag(su)[None, :]
          + np.diag(se)[None, :])                  # [n, t]
    minv = jnp.asarray(1.0 / dv.reshape(n * t), jnp.float32)

    # RHS pages: t*p fixed-effect columns (X col j in trait q, 0 elsewhere)
    # + the observation page Y
    k = t * p + 1
    rhs = np.zeros((n, t, k))
    for q in range(t):
        for j in range(p):
            rhs[:, q, q * p + j] = x[:, j] * mf[:, q]
    rhs[:, :, -1] = y0
    norms = np.linalg.norm(rhs.reshape(n * t, k), axis=0)
    norms = np.where(norms > 0, norms, 1.0)
    res = jax.jit(lambda b: cg(op, b, tol=tol, maxiter=maxiter,
                               minv=minv))(
        jnp.asarray(rhs.reshape(n * t, k) / norms, jnp.float32))
    sol = (np.asarray(res.x, np.float64) * norms).reshape(n, t, k)

    vix = sol[:, :, :-1]                           # V^-1 (I⊗X) pages
    viy = sol[:, :, -1]                            # V^-1 Y
    # GLS: (X~' V^-1 X~) beta = X~' V^-1 y, with X~ = I_t ⊗ X
    xtvx = np.empty((t * p, t * p))
    xtvy = np.empty(t * p)
    for q in range(t):
        for j in range(p):
            c = q * p + j
            # row c of X~'V^-1X~: trait-q page of each V^-1(I⊗X) column
            # dotted with X col j
            xtvx[c] = vix[:, q, :].T @ x[:, j]
            xtvy[c] = float(x[:, j] @ viy[:, q])
    xtvx = 0.5 * (xtvx + xtvx.T)
    beta = np.linalg.solve(xtvx, xtvy).reshape(t, p).T   # [p, t]

    resid = mf * (y0 - x @ beta)
    res2 = jax.jit(lambda b: cg(op, b, tol=tol, maxiter=maxiter,
                                minv=minv))(
        jnp.asarray(resid.reshape(n * t, 1)
                    / max(np.linalg.norm(resid), 1e-30), jnp.float32))
    w = (np.asarray(res2.x, np.float64)
         * max(np.linalg.norm(resid), 1e-30)).reshape(n, t)
    gw = np.asarray(gmv(jnp.asarray(w, jnp.float32)),
                    np.float64) / sigma2
    g_hat = gw @ su                                 # (Su ⊗ G) V^-1 resid
    fitted = x @ beta + g_hat
    return MTGBLUPResult(beta=beta, g_hat=g_hat, fitted=fitted,
                         cg_iterations=int(res.iterations)
                         + int(res2.iterations))


def gblup_from_grm(
    grm_matrix: np.ndarray,
    y: np.ndarray,
    h2: float = 0.5,
    covariates: Optional[np.ndarray] = None,
    tol: float = 1e-6,
    maxiter: int = 2000,
) -> GBLUPResult:
    """GBLUP from a PRECOMPUTED relationship matrix (e.g. a GCTA
    .grm.bin fileset read back with :func:`io.grm_io.read_gcta_grm`, or
    an H-matrix from another tool) — the reverse interop direction: the
    packed-panel pipeline exports GRMs, this consumes them.  Same BLUE /
    BLUP estimates as :func:`gblup`, via Jacobi-preconditioned block CG
    on the dense operator."""
    import jax

    from .solve.cg import cg, jacobi_minv

    g = np.asarray(grm_matrix, np.float64)
    n = g.shape[0]
    if g.shape != (n, n):
        raise ValueError(f"grm must be square, got {g.shape}")
    y = np.asarray(y, np.float64).reshape(n)
    lam = (1.0 - h2) / h2

    cols = [np.ones((n, 1))]
    if covariates is not None:
        cov = np.asarray(covariates, np.float64)
        cols.append(cov[:, None] if cov.ndim == 1 else cov)
    x = np.concatenate(cols, axis=1)
    p = x.shape[1]

    gj = jnp.asarray(g, jnp.float32)
    minv = jacobi_minv(jnp.diag(gj) + lam)
    run = jax.jit(lambda b: cg(
        lambda v: jnp.dot(gj, v, precision=_HIGHEST) + lam * v, b, tol=tol,
        maxiter=maxiter, minv=minv))
    rhs = np.concatenate([x, y[:, None]], axis=1)
    norms = np.linalg.norm(rhs, axis=0)
    res = run(jnp.asarray(rhs / norms, jnp.float32))
    b = np.asarray(res.x, np.float64) * norms
    bx, by = b[:, :p], b[:, p]
    beta = np.linalg.solve(x.T @ bx, x.T @ by)
    res_u = run(jnp.asarray((y - x @ beta)[:, None]
                            / max(np.linalg.norm(y - x @ beta), 1e-30),
                jnp.float32))
    u = np.asarray(res_u.x, np.float64)[:, 0] \
        * max(np.linalg.norm(y - x @ beta), 1e-30)
    g_hat = g @ u
    fitted = x @ beta + g_hat
    return GBLUPResult(beta=beta, g_hat=g_hat, fitted=fitted, pcs=None,
                       cg_iterations=int(res.iterations)
                       + int(res_u.iterations), u=u)
