"""GBLUP pipeline tests (reference examples/gblup/calculate_gblup.jl
semantics): randomized PCA vs direct eigendecomposition, CG vs dense GBLUP
agreement, predictive correlation on simulated phenotypes."""
import numpy as np
import pytest

import miraculix_tpu as mx
from miraculix_tpu import gblup
from miraculix_tpu.io import bed
from miraculix_tpu.ops import ref_impl


@pytest.fixture(scope="module")
def panel():
    g = bed.simulate_genotypes(150, 1200, seed=60)
    return g, mx.from_dense(g)


def test_randomized_pca_matches_direct():
    """Structured panel (two diverged subpopulations) — the regime PCA
    covariates exist for; randomized eigenpairs must match the direct ones."""
    rng = np.random.default_rng(7)
    maf_a = rng.uniform(0.05, 0.5, 800)
    maf_b = np.clip(maf_a + rng.normal(0, 0.2, 800), 0.02, 0.98)
    rows = []
    for maf, n in ((maf_a, 60), (maf_b, 60)):
        u = rng.random((n, 800))
        hom = (1 - maf) ** 2
        het = hom + 2 * maf * (1 - maf)
        rows.append(np.where(u < hom, 0, np.where(u < het, 1, 2)))
    geno = np.concatenate(rows).astype(np.uint8)
    gm = mx.from_dense(geno)
    freq = np.asarray(gm.freq, np.float64)
    gmat = ref_impl.grm_oracle(geno, freq, scale=False)
    w_true, v_true = np.linalg.eigh(gmat)
    w_true = w_true[::-1]
    w, v = gblup.randomized_grm_pca(gm, k=3, power_iters=4, seed=1)
    np.testing.assert_allclose(w[0], w_true[0], rtol=1e-4)
    assert abs(np.dot(v[:, 0], v_true[:, -1])) > 0.999
    np.testing.assert_allclose(w[:3], w_true[:3], rtol=0.05)


def test_gblup_cg_matches_dense(panel):
    geno, gm = panel
    y, bv = gblup.simulate_phenotypes(geno, h2=0.5, seed=2)
    res_cg = gblup.gblup(gm, y, h2=0.5, n_pcs=2, solver="cg",
                         tol=1e-7, maxiter=4000, seed=3)
    res_dn = gblup.gblup(gm, y, h2=0.5, n_pcs=2, solver="dense", seed=3)
    np.testing.assert_allclose(res_cg.beta, res_dn.beta, atol=1e-3)
    assert np.abs(res_cg.g_hat - res_dn.g_hat).max() < 1e-2


def test_gblup_refined_is_f64_grade(panel):
    """solver='refined' must deliver f64-CLASS results end to end — a
    numpy float64 replication of the whole pipeline (same PCs) agrees to
    ~1e-8, far past what any f32 round-trip of the solutions would allow
    (~1e-7); guards the refined path against silent f32 casts."""
    geno, gm = panel
    y, bv = gblup.simulate_phenotypes(geno, h2=0.5, seed=2)
    h2 = 0.5
    res_rf = gblup.gblup(gm, y, h2=h2, n_pcs=2, solver="refined",
                         tol=1e-11, maxiter=4000, seed=3)
    # float64 oracle of the same algebra, reusing the run's own PCs
    f = np.asarray(gm.freq, np.float64)
    zc = geno.astype(np.float64) - 2.0 * f[None, :]
    sigma2 = float(gm.sigma2)
    lam = (1.0 - h2) / h2
    n = geno.shape[0]
    x = np.concatenate([np.ones((n, 1)), res_rf.pcs], axis=1)
    a = zc @ zc.T + lam * sigma2 * np.eye(n)
    b = np.linalg.solve(a, np.concatenate([x, y[:, None]], axis=1)) * sigma2
    bx, by = b[:, :-1], b[:, -1]
    beta = np.linalg.solve(x.T @ bx, x.T @ by)
    u = np.linalg.solve(a, (y - x @ beta)[:, None])[:, 0] * sigma2
    g_hat = (zc @ (zc.T @ u)) / sigma2
    np.testing.assert_allclose(res_rf.beta, beta, rtol=1e-8, atol=1e-10)
    scale = np.abs(g_hat).max()
    assert np.abs(res_rf.g_hat - g_hat).max() / scale < 1e-8


def test_gblup_predicts(panel):
    geno, gm = panel
    y, bv = gblup.simulate_phenotypes(geno, h2=0.8, n_qtl=50, seed=4)
    res = gblup.gblup(gm, y, h2=0.8, n_pcs=0, solver="cg", tol=1e-5)
    cor = np.corrcoef(res.g_hat, bv)[0, 1]
    assert cor > 0.5  # signal recovered
    cor_fit = np.corrcoef(res.fitted, y)[0, 1]
    assert cor_fit > 0.7


def test_run_gblup_cli_path(tmp_path, panel):
    geno, _ = panel
    path = str(tmp_path / "p.bed")
    bed.write_bed(path, geno)
    assert gblup.run_gblup(path, h2=0.5, pcs=2, solver="cg") == 0


@pytest.mark.parametrize("layout", ["1d", "2d"])
def test_gblup_sharded_matches_single_chip(rng, layout):
    """Distributed GBLUP (8-device virtual mesh) must reproduce the
    single-chip estimates — the BASELINE multi-chip pipeline config."""
    from miraculix_tpu import parallel
    from miraculix_tpu.gblup import gblup, simulate_phenotypes

    g = bed.simulate_genotypes(64, 900, seed=21)
    y, _ = simulate_phenotypes(g, h2=0.6, seed=3)
    gm = mx.from_dense(g)
    ref = gblup(gm, y, h2=0.6, n_pcs=2, solver="cg", tol=1e-6, maxiter=500)

    if layout == "1d":
        sg = parallel.shard_genotypes(g, parallel.make_mesh(8))
    else:
        sg = parallel.shard_genotypes_2d(g, parallel.make_mesh_2d(8))
    dist = gblup(sg, y, h2=0.6, n_pcs=2, solver="cg", tol=1e-6, maxiter=500)
    np.testing.assert_allclose(dist.beta, ref.beta, atol=1e-2)
    np.testing.assert_allclose(dist.g_hat, ref.g_hat, atol=5e-2)


def test_gblup_user_covariates(rng):
    """User covariates join the intercept + PCs in the fixed-effect design."""
    from miraculix_tpu.gblup import gblup, simulate_phenotypes

    g = bed.simulate_genotypes(60, 500, seed=5)
    cov = rng.standard_normal(60)
    y, _ = simulate_phenotypes(g, h2=0.5, seed=2)
    y = y + 3.0 * cov  # strong covariate effect
    res = gblup(mx.from_dense(g), y, h2=0.5, n_pcs=2, covariates=cov,
                solver="cg", tol=1e-6, maxiter=400)
    # beta = [intercept, cov, pc1, pc2]; the covariate coefficient ~ 3
    assert abs(res.beta[1] - 3.0) < 0.5


def test_cross_validate_recovers_signal(panel):
    """5-fold CV on a heritable phenotype: positive predictive correlation
    in every fold, and the mean beats a permuted-phenotype null."""
    geno, gm = panel
    y, bv = gblup.simulate_phenotypes(geno, h2=0.8, n_qtl=60, seed=6)
    cors, mean_cor = gblup.cross_validate(gm, y, h2=0.8, k=5, seed=1)
    assert len(cors) == 5
    assert mean_cor > 0.2
    assert (cors > 0).all()
    rng = np.random.default_rng(2)
    _, null_cor = gblup.cross_validate(gm, rng.permutation(y), h2=0.8,
                                       k=5, seed=1)
    assert mean_cor > null_cor + 0.1


def test_estimate_h2_he():
    """HE regression recovers the simulated heritability.  The slope's
    sampling SD scales like sqrt(2 M) / n (M SNPs, n individuals), so the
    test uses a panel where that is ~0.08 and polygenic phenotypes (all
    SNPs causal) so the QTL-GRM equals the fitted GRM."""
    geno = bed.simulate_genotypes(800, 2000, seed=61)
    gm = mx.from_dense(geno)
    y_hi, _ = gblup.simulate_phenotypes(geno, h2=0.8, n_qtl=2000, seed=9)
    y_lo, _ = gblup.simulate_phenotypes(geno, h2=0.1, n_qtl=2000, seed=9)
    h2_hi, _ = gblup.estimate_h2_he(gm, y_hi, n_probes=32, seed=1)
    h2_lo, _ = gblup.estimate_h2_he(gm, y_lo, n_probes=32, seed=1)
    assert abs(h2_hi - 0.8) < 0.25, h2_hi
    assert abs(h2_lo - 0.1) < 0.25, h2_lo
    assert h2_hi > h2_lo + 0.3


def _profiled_reml_logl_argmax(geno, gm, y, grid):
    """Exact dense REML oracle: profiled restricted log-likelihood over an
    h2 grid via the eigendecomposition of the scaled GRM (intercept-only
    fixed effects), total variance profiled out."""
    n = geno.shape[0]
    freq = np.asarray(gm.freq, np.float64)
    gs = ref_impl.grm_oracle(geno, freq, scale=True)
    w, u = np.linalg.eigh(gs)
    yt = (y - y.mean()) / y.std()
    uy = u.T @ yt
    ux = u.T @ np.ones((n, 1))

    def logl(h2):
        d = h2 * w + (1 - h2)
        v0ix = ux / d[:, None]
        xtvx = ux.T @ v0ix
        beta = np.linalg.solve(xtvx, v0ix.T @ uy)
        ypy = uy @ (uy / d) - (v0ix.T @ uy) @ beta
        st = ypy / (n - 1)
        return -0.5 * ((n - 1) * np.log(st) + np.log(d).sum()
                       + np.linalg.slogdet(xtvx)[1])

    ll = np.array([logl(h) for h in grid])
    return float(grid[ll.argmax()])


@pytest.fixture(scope="module")
def reml_panel():
    geno = bed.simulate_genotypes(160, 800, seed=11)
    gm = mx.from_dense(geno)
    y, _ = gblup.simulate_phenotypes(geno, h2=0.6, n_qtl=400, seed=5)
    h2_exact = _profiled_reml_logl_argmax(
        geno, gm, y, np.linspace(0.01, 0.99, 393))
    return geno, gm, y, h2_exact


def test_estimate_h2_reml_exact_probes(reml_panel):
    """Identity probes make every trace exact, so AI-REML must land on the
    dense profiled-likelihood maximizer to CG/grid resolution."""
    geno, gm, y, h2_exact = reml_panel
    n = geno.shape[0]
    h2, det = gblup.estimate_h2_reml(gm, y, probes=np.eye(n), cg_tol=1e-7)
    assert det["exact_traces"] and det["converged"], det
    assert abs(h2 - h2_exact) < 0.01, (h2, h2_exact)
    assert np.isfinite(det["se_h2"]) and det["se_h2"] > 0


def test_estimate_h2_reml_stochastic(reml_panel):
    """Hutchinson traces (16 Rademacher probes) stay within the stochastic
    trace error of the exact optimum and agree with HE on ordering."""
    geno, gm, y, h2_exact = reml_panel
    h2, det = gblup.estimate_h2_reml(gm, y, n_probes=16, seed=3,
                                     cg_tol=1e-6)
    assert det["converged"], det
    assert abs(h2 - h2_exact) < 0.08, (h2, h2_exact)
    # original-scale components recompose to var(y)·(s2g+s2e)
    np.testing.assert_allclose(det["vg"] + det["ve"],
                               y.var() * (det["s2g"] + det["s2e"]),
                               rtol=1e-12)


def test_estimate_h2_reml_streamed_matches_single_chip(tmp_path, reml_panel):
    """Same seed + same probes on the out-of-core container must reproduce
    the single-chip estimate (the solves differ only by CG tolerance)."""
    geno, gm, y, _ = reml_panel
    from miraculix_tpu.streamed import StreamedGeno

    path = str(tmp_path / "reml.bed")
    bed.write_bed(path, geno)
    sg = StreamedGeno.from_bed(path, chunk_snps=256)
    h2_s, _ = gblup.estimate_h2_reml(sg, y, n_probes=8, seed=3, cg_tol=1e-6)
    h2_g, _ = gblup.estimate_h2_reml(gm, y, n_probes=8, seed=3, cg_tol=1e-6)
    assert abs(h2_s - h2_g) < 5e-3, (h2_s, h2_g)


def test_estimate_h2_reml_covariates(reml_panel):
    """A real covariate with a strong fixed effect must be absorbed by X,
    leaving the variance-component estimate unchanged (vs the no-effect
    fit), not inflated into s2e."""
    geno, gm, y, _ = reml_panel
    rng = np.random.default_rng(8)
    cov = rng.standard_normal(len(y))
    y_shift = y + 3.0 * cov
    h2_base, _ = gblup.estimate_h2_reml(gm, y, covariates=cov,
                                        n_probes=16, seed=3)
    h2_shift, _ = gblup.estimate_h2_reml(gm, y_shift, covariates=cov,
                                         n_probes=16, seed=3)
    assert abs(h2_shift - h2_base) < 0.03, (h2_shift, h2_base)


def test_cli_reml_and_grm_dominance(tmp_path, capsys):
    """CLI: standalone reml command (gcta --reml role) and grm --dominance."""
    from miraculix_tpu import cli

    geno = bed.simulate_genotypes(120, 600, seed=19)
    y, _ = gblup.simulate_phenotypes(geno, h2=0.6, n_qtl=300, seed=4)
    p = str(tmp_path / "r.bed")
    bed.write_bed(p, geno)
    fam = open(p[:-4] + ".fam").read().splitlines()
    with open(p[:-4] + ".fam", "w") as fh:
        for k, ln in enumerate(fam):
            parts = ln.split()
            parts[5] = f"{y[k]:.6f}"
            fh.write(" ".join(parts) + "\n")

    assert cli.main(["reml", p, "--method", "he"]) == 0
    out = capsys.readouterr().out
    assert "HE h2 =" in out
    assert cli.main(["reml", p, "--probes", "8"]) == 0
    out = capsys.readouterr().out
    assert "V(G)/Vp" in out and "AI-REML" in out

    assert cli.main(["grm", p, "-o", str(tmp_path / "d.npy"),
                     "--dominance"]) == 0
    d = np.load(str(tmp_path / "d.npy"))
    assert d.shape == (120, 120) and np.isfinite(d).all()


def test_snp_effects_backsolve_and_predict(tmp_path):
    """GBLUP == SNP-BLUP equivalence: backsolved marker effects must
    reproduce g_hat exactly on the training panel, and score held-out
    animals (simulated from the SAME QTL model) with positive accuracy —
    centering with the TRAINING frequencies."""
    rng = np.random.default_rng(23)
    n_all, n_train, snps = 300, 220, 1500
    geno_all = bed.simulate_genotypes(n_all, snps, seed=29)
    # one QTL model over all animals, then split
    y_all, bv_all = gblup.simulate_phenotypes(geno_all, h2=0.7, n_qtl=400,
                                              seed=6)
    tr = rng.permutation(n_all)[:n_train]
    te = np.setdiff1d(np.arange(n_all), tr)
    gm_tr = mx.from_dense(geno_all[tr])
    res = gblup.gblup(gm_tr, y_all[tr], h2=0.6, n_pcs=0, tol=1e-7,
                      maxiter=3000)
    alpha = gblup.snp_effects(gm_tr, res)

    # exact reproduction on the training panel
    back = gblup.predict(gm_tr, alpha, np.asarray(gm_tr.freq))
    assert np.abs(back - res.g_hat).max() < 1e-3 * np.abs(res.g_hat).max()

    # held-out accuracy beats a permuted-effects null
    gm_te = mx.from_dense(geno_all[te])
    pred = gblup.predict(gm_te, alpha, np.asarray(gm_tr.freq))
    acc = np.corrcoef(pred, bv_all[te])[0, 1]
    null = np.corrcoef(gblup.predict(gm_te, rng.permutation(alpha),
                                     np.asarray(gm_tr.freq)),
                       bv_all[te])[0, 1]
    assert acc > 0.3, acc
    assert acc > null + 0.2, (acc, null)


def test_multi_trait_gblup_matches_dense():
    """Bivariate GBLUP vs a dense float64 GLS/BLUP oracle on the full
    Kronecker V; missing-trait-free complete records."""
    n, s, t = 140, 900, 2
    geno = bed.simulate_genotypes(n, s, seed=41)
    gm = mx.from_dense(geno)
    rng = np.random.default_rng(5)
    su = np.array([[1.0, 0.6], [0.6, 0.8]])
    se = np.array([[0.7, 0.1], [0.1, 0.9]])
    f = np.asarray(gm.freq, np.float64)
    gs = ref_impl.grm_oracle(geno, f, scale=True)
    # simulate correlated traits under the model itself
    lu = np.linalg.cholesky(np.kron(su, gs + 1e-6 * np.eye(n)))
    u_true = (lu @ rng.standard_normal(n * t)).reshape(t, n).T
    cov = rng.standard_normal(n)
    y = (np.outer(np.ones(n), [2.0, -1.0]) + np.outer(cov, [0.5, 0.3])
         + u_true + rng.standard_normal((n, t)))

    res = gblup.multi_trait_gblup(gm, y, su, se, covariates=cov,
                                  tol=1e-8, maxiter=4000)

    # dense oracle
    x = np.column_stack([np.ones(n), cov])
    p = x.shape[1]
    v = np.kron(su, gs) + np.kron(se, np.eye(n))
    vi = np.linalg.inv(v)
    xt = np.kron(np.eye(t), x)                 # [n*t, t*p], trait-major
    yv = y.T.reshape(-1)                       # vec with trait as outer
    xtvx = xt.T @ vi @ xt
    beta_vec = np.linalg.solve(xtvx, xt.T @ vi @ yv)
    beta_ref = beta_vec.reshape(t, p).T
    w = vi @ (yv - xt @ beta_vec)
    ghat_ref = (np.kron(su, gs) @ w).reshape(t, n).T

    assert np.abs(res.beta - beta_ref).max() < 5e-3, (res.beta, beta_ref)
    denom = np.abs(ghat_ref).max()
    assert np.abs(res.g_hat - ghat_ref).max() / denom < 5e-3
    # cross-trait information: correlated-trait fit beats independent fits
    r0 = gblup.gblup(gm, y[:, 0], h2=float(su[0, 0] / (su[0, 0] + se[0, 0])),
                     n_pcs=0, tol=1e-8)
    acc_mt = np.corrcoef(res.g_hat[:, 0], u_true[:, 0])[0, 1]
    acc_st = np.corrcoef(r0.g_hat, u_true[:, 0])[0, 1]
    assert acc_mt > acc_st - 0.02  # never materially worse


def test_multi_trait_gblup_missing_cells():
    """NaN trait cells: the solve restricts V to observed cells; the BLUP
    predicts the MISSING cells, borrowing through the genetic correlation
    — verified against a dense observed-cell oracle."""
    n, s, t = 120, 800, 2
    geno = bed.simulate_genotypes(n, s, seed=43)
    gm = mx.from_dense(geno)
    rng = np.random.default_rng(7)
    su = np.array([[1.0, 0.75], [0.75, 0.9]])
    se = np.array([[0.5, 0.0], [0.0, 0.6]])
    f = np.asarray(gm.freq, np.float64)
    gs = ref_impl.grm_oracle(geno, f, scale=True)
    lu = np.linalg.cholesky(np.kron(su, gs + 1e-6 * np.eye(n)))
    u_true = (lu @ rng.standard_normal(n * t)).reshape(t, n).T
    y = 1.0 + u_true + rng.standard_normal((n, t)) * np.sqrt(0.55)
    # trait 2 unobserved on the last 40 animals
    y_missing = y.copy()
    y_missing[-40:, 1] = np.nan

    res = gblup.multi_trait_gblup(gm, y_missing, su, se, tol=1e-8,
                                  maxiter=4000)

    # dense oracle on observed cells (trait-major vec)
    mask = ~np.isnan(y_missing)
    obs = np.flatnonzero(mask.T.reshape(-1))
    v = np.kron(su, gs) + np.kron(se, np.eye(n))
    x1 = np.ones((n, 1))
    xt = np.kron(np.eye(t), x1)
    vo = v[np.ix_(obs, obs)]
    xo = xt[obs]
    yo = y_missing.T.reshape(-1)[obs]
    vio = np.linalg.inv(vo)
    beta_vec = np.linalg.solve(xo.T @ vio @ xo, xo.T @ vio @ yo)
    w = vio @ (yo - xo @ beta_vec)
    ghat_ref = (np.kron(su, gs)[:, obs] @ w).reshape(t, n).T

    assert np.abs(res.beta.T.reshape(-1) - beta_vec).max() < 5e-3
    denom = np.abs(ghat_ref).max()
    assert np.abs(res.g_hat - ghat_ref).max() / denom < 5e-3
    # the missing cells got real (correlated-trait) predictions
    acc = np.corrcoef(res.g_hat[-40:, 1], u_true[-40:, 1])[0, 1]
    assert acc > 0.3, acc


def test_estimate_h2_reml_sharded_matches_single_chip(reml_panel):
    """AI-REML on the 8-device 1D-sharded container must reproduce the
    single-chip estimate (same seed, same probes; solves differ only by
    the distributed CG's reduction order)."""
    from miraculix_tpu import parallel

    geno, gm, y, _ = reml_panel
    mesh = parallel.make_mesh(8)
    sg = parallel.shard_genotypes(geno, mesh)
    h2_s, det_s = gblup.estimate_h2_reml(sg, y, n_probes=8, seed=3,
                                         cg_tol=1e-6)
    h2_g, _ = gblup.estimate_h2_reml(gm, y, n_probes=8, seed=3,
                                     cg_tol=1e-6)
    assert det_s["converged"]
    assert abs(h2_s - h2_g) < 5e-3, (h2_s, h2_g)


def test_multi_trait_gblup_sharded_matches_single_chip():
    """Bivariate GBLUP on the 8-device 1D mesh == single chip (the
    Kronecker matvec rides the sharded packed operator)."""
    from miraculix_tpu import parallel

    geno = bed.simulate_genotypes(64, 700, seed=47)
    rng = np.random.default_rng(3)
    su = np.array([[1.0, 0.5], [0.5, 0.8]])
    se = np.array([[0.6, 0.1], [0.1, 0.7]])
    y = rng.standard_normal((64, 2)) + 1.0
    y[-10:, 1] = np.nan  # missing cells too
    gm = mx.from_dense(geno)
    ref = gblup.multi_trait_gblup(gm, y, su, se, tol=1e-8, maxiter=3000)
    mesh = parallel.make_mesh(8)
    sg = parallel.shard_genotypes(geno, mesh)
    got = gblup.multi_trait_gblup(sg, y, su, se, tol=1e-8, maxiter=3000)
    np.testing.assert_allclose(got.beta, ref.beta, atol=2e-4)
    np.testing.assert_allclose(got.g_hat, ref.g_hat, atol=2e-4)


def test_multi_trait_gblup_sharded2d_matches_single_chip():
    """Bivariate GBLUP on the 2D (indiv x SNP) mesh == single chip —
    the padded-row plumbing through the batched [n, t*k] pages."""
    from miraculix_tpu import parallel

    geno = bed.simulate_genotypes(48, 600, seed=53)
    rng = np.random.default_rng(4)
    su = np.array([[0.9, 0.4], [0.4, 1.1]])
    se = np.array([[0.7, 0.0], [0.0, 0.6]])
    y = rng.standard_normal((48, 2))
    gm = mx.from_dense(geno)
    ref = gblup.multi_trait_gblup(gm, y, su, se, tol=1e-8, maxiter=3000)
    mesh2 = parallel.make_mesh_2d(8)
    sg2 = parallel.shard_genotypes_2d(geno, mesh2)
    got = gblup.multi_trait_gblup(sg2, y, su, se, tol=1e-8, maxiter=3000)
    np.testing.assert_allclose(got.beta, ref.beta, atol=2e-4)
    np.testing.assert_allclose(got.g_hat, ref.g_hat, atol=2e-4)


def test_gblup_from_grm_matches_panel_gblup(panel):
    """Consuming a precomputed GRM (the GCTA fileset round trip) must
    reproduce the packed-panel GBLUP estimates."""
    from miraculix_tpu.io.grm_io import read_gcta_grm, write_gcta_grm

    geno, _ = panel
    gm = mx.from_dense(geno)
    y, _ = gblup.simulate_phenotypes(geno, h2=0.6, seed=9)
    ref = gblup.gblup(gm, y, h2=0.5, n_pcs=0, tol=1e-8, maxiter=4000)

    import tempfile
    with tempfile.TemporaryDirectory() as d:
        write_gcta_grm(d + "/g", np.asarray(mx.grm(gm, scale=True)),
                       gm.snps)
        g2, _, _ = read_gcta_grm(d + "/g")
    got = gblup.gblup_from_grm(g2, y, h2=0.5, tol=1e-8, maxiter=4000)
    assert np.abs(got.beta - ref.beta).max() < 5e-3
    denom = np.abs(ref.g_hat).max()
    assert np.abs(got.g_hat - ref.g_hat).max() / denom < 5e-3


@pytest.mark.gpu
def test_gblup_from_grm_on_card_f32_grade(gpu):
    """The dense-GRM CG compiled for the card against a float64 direct
    solve.  Its matvec is an f32 GEMM: at f32 grade the estimates land
    ~3e-7 from float64 (CPU, same system); with the GRM rounded to TF32's
    10-bit mantissa they land ~2e-4 away.  The 2e-5 limit passes the first
    and fails the second."""
    n = 2000
    geno = bed.simulate_genotypes(n, 8000, seed=61).astype(np.float64)
    zc = geno - geno.mean(0)
    f = geno.mean(0) / 2
    g = zc @ zc.T / (2 * np.sum(f * (1 - f)))
    y = (np.random.default_rng(3).standard_normal(n)
         + 0.1 * zc[:, :50].sum(1))
    v = g + np.eye(n)                               # h2 = 0.5: lam = 1
    x = np.ones((n, 1))
    beta = np.linalg.solve(x.T @ np.linalg.solve(v, x),
                           x.T @ np.linalg.solve(v, y))
    g_hat = g @ np.linalg.solve(v, y - x @ beta)
    got = gblup.gblup_from_grm(g, y, h2=0.5, tol=1e-7, maxiter=2000)
    assert np.abs(got.g_hat - g_hat).max() / np.abs(g_hat).max() < 2e-5


def test_snp_effects_containers_match(panel):
    """Marker backsolve is container-independent: streamed and 1D-sharded
    panels reproduce the single-chip alpha."""
    from miraculix_tpu import parallel
    from miraculix_tpu.streamed import StreamedGeno
    import tempfile

    geno, _ = panel
    gm = mx.from_dense(geno)
    y, _ = gblup.simulate_phenotypes(geno, h2=0.6, seed=9)
    res = gblup.gblup(gm, y, h2=0.5, n_pcs=0, tol=1e-7)
    ref = gblup.snp_effects(gm, res)

    mesh = parallel.make_mesh(8)
    sg = parallel.shard_genotypes(geno, mesh)
    a1 = gblup.snp_effects(sg, res)
    np.testing.assert_allclose(a1, ref, atol=1e-6 * np.abs(ref).max())

    with tempfile.TemporaryDirectory() as d:
        bed.write_bed(d + "/p.bed", geno)
        st = StreamedGeno.from_bed(d + "/p.bed", chunk_snps=256)
        a2 = gblup.snp_effects(st, res)
    np.testing.assert_allclose(a2, ref, atol=1e-6 * np.abs(ref).max())


def test_cli_pca_matches_dense_eigh(tmp_path, capsys):
    """CLI pca (gcta --pca role): eigenvalues/eigenvectors of the
    VanRaden-scaled GRM from the randomized solver must match a dense
    float64 eigendecomposition of the explicitly formed GRM."""
    from miraculix_tpu import cli

    geno = bed.simulate_genotypes(100, 800, seed=23)
    p = str(tmp_path / "p.bed")
    bed.write_bed(p, geno)
    prefix = str(tmp_path / "out")
    assert cli.main(["pca", p, "-o", prefix, "-k", "5",
                     "--oversample", "40", "--power-iters", "8"]) == 0
    assert "top 5 PCs" in capsys.readouterr().out

    w = np.loadtxt(prefix + ".eigenval")
    vec_rows = [ln.split() for ln in open(prefix + ".eigenvec")]
    assert len(vec_rows) == 100 and len(vec_rows[0]) == 2 + 5
    v = np.array([[float(x) for x in r[2:]] for r in vec_rows])

    # dense oracle: scaled centered GRM, top-5 eigenpairs
    freq = np.where(geno == 3, 0, geno).mean(axis=0) / 2.0
    zc = geno.astype(np.float64) - 2 * freq[None, :]
    gmat = zc @ zc.T / (2 * (freq * (1 - freq)).sum())
    wd, vd = np.linalg.eigh(gmat)
    wd, vd = wd[::-1][:5], vd[:, ::-1][:, :5]
    np.testing.assert_allclose(w, wd, rtol=2e-3)
    for j in range(5):          # eigenvectors match up to sign
        dot = abs(float(v[:, j] @ vd[:, j]))
        assert dot > 0.999, (j, dot)


def test_cli_effects_out_and_score(tmp_path, capsys):
    """Deployment loop: gblup --effects-out exports marker effects, score
    reproduces the training fit (indirect prediction == direct GBLUP) and
    rejects variant-misaligned panels."""
    from miraculix_tpu import cli, from_bed

    geno = bed.simulate_genotypes(90, 500, seed=31)
    y, _ = gblup.simulate_phenotypes(geno, h2=0.6, n_qtl=200, seed=5)
    p = str(tmp_path / "t.bed")
    bed.write_bed(p, geno)
    fam = open(p[:-4] + ".fam").read().splitlines()
    with open(p[:-4] + ".fam", "w") as fh:
        for k, ln in enumerate(fam):
            parts = ln.split()
            parts[5] = f"{y[k]:.6f}"
            fh.write(" ".join(parts) + "\n")

    eff = str(tmp_path / "eff.tsv")
    assert cli.main(["gblup", p, "--effects-out", eff]) == 0
    capsys.readouterr()
    rows = [ln.split("\t") for ln in open(eff)]
    assert rows[0] == ["snp", "allele", "effect", "freq_train\n"] \
        or rows[0][0] == "snp"
    assert len(rows) == 1 + 500
    # dosage counts A2 copies (0b00 hom-A1 decodes to 0), so the exported
    # effect allele must be the .bim 6th column (A2 = "B" in write_bed
    # filesets) — plink --score with these rows then reproduces g_hat
    assert all(r[1] == "B" for r in rows[1:])

    out = str(tmp_path / "sc.tsv")
    assert cli.main(["score", p, eff, "-o", out]) == 0
    capsys.readouterr()
    sc = np.loadtxt(out, skiprows=1, usecols=2)
    assert sc.shape == (90,)

    # oracle: predict() with the exported alpha/freq on the same panel
    alpha = np.array([float(r[2]) for r in rows[1:]])
    freq = np.array([float(r[3]) for r in rows[1:]])
    want = gblup.predict(from_bed(p), alpha, freq)
    np.testing.assert_allclose(sc, want, atol=1e-4 * np.abs(want).max())

    # variant misalignment must be refused without --force
    bim = open(p[:-4] + ".bim").read().splitlines()
    parts3 = bim[3].split()
    assert parts3[1] == "snp3"
    parts3[1] = "OTHER"
    bim[3] = " ".join(parts3)
    with open(p[:-4] + ".bim", "w") as fh:
        fh.write("\n".join(bim) + "\n")
    import pytest as _pytest
    with _pytest.raises(SystemExit):
        cli.main(["score", p, eff, "-o", out])
    assert cli.main(["score", p, eff, "-o", out, "--force"]) == 0
    capsys.readouterr()


def _simulate_bivar(geno, rg, h2a, h2b, seed):
    """Correlated-QTL bivariate phenotypes; returns (y1, y2, realized
    genetic correlation of the two breeding-value vectors)."""
    rng = np.random.default_rng(seed)
    n, snps = geno.shape
    f = np.where(geno == 3, 0, geno).mean(axis=0) / 2.0
    zc = geno.astype(np.float64) - 2 * f
    zs = zc / np.sqrt(2 * (f * (1 - f)).sum())
    a = rng.multivariate_normal(np.zeros(2), [[1, rg], [rg, 1]], size=snps)
    u = zs @ a
    u = u / u.std(axis=0)
    rg_real = float(np.corrcoef(u[:, 0], u[:, 1])[0, 1])
    e = rng.standard_normal((n, 2))
    e = e / e.std(axis=0)
    y1 = np.sqrt(h2a) * u[:, 0] + np.sqrt(1 - h2a) * e[:, 0]
    y2 = np.sqrt(h2b) * u[:, 1] + np.sqrt(1 - h2b) * e[:, 1]
    return y1, y2, rg_real


def test_bivar_reml_matches_dense_oracle():
    """estimate_bivar_reml with exact (identity) probes lands on the SAME
    six variance components as a dense Nelder-Mead maximization of the
    exact restricted likelihood — the full bivariate REML criterion."""
    from scipy.optimize import minimize

    n, snps = 120, 600
    geno = bed.simulate_genotypes(n, snps, seed=8)
    gm = mx.from_dense(geno)
    y1, y2, _ = _simulate_bivar(geno, 0.6, 0.5, 0.4, seed=3)
    f = np.where(geno == 3, 0, geno).mean(axis=0) / 2.0
    zc = geno.astype(np.float64) - 2 * f
    gs = zc @ zc.T / (2 * (f * (1 - f)).sum())
    yt = np.stack([(y - y.mean()) / y.std() for y in (y1, y2)],
                  axis=1).reshape(-1)
    x = np.zeros((2 * n, 2))
    x[0::2, 0] = 1.0
    x[1::2, 1] = 1.0

    def nll(th):
        g11, g22, g12, e11, e22, e12 = th
        sg = np.array([[g11, g12], [g12, g22]])
        se = np.array([[e11, e12], [e12, e22]])
        if (np.linalg.eigvalsh(sg)[0] < -1e-9
                or np.linalg.eigvalsh(se)[0] <= 0):
            return 1e10
        v = np.kron(gs, sg) + np.kron(np.eye(n), se)
        sign, logdet = np.linalg.slogdet(v)
        if sign <= 0:
            return 1e10
        vi = np.linalg.inv(v)
        xtvix = x.T @ vi @ x
        s2, ld2 = np.linalg.slogdet(xtvix)
        if s2 <= 0:
            return 1e10
        pmat = vi - vi @ x @ np.linalg.solve(xtvix, x.T @ vi)
        return 0.5 * (logdet + ld2 + yt @ pmat @ yt)

    res = minimize(nll, np.array([.5, .4, .2, .5, .6, .1]),
                   method="Nelder-Mead",
                   options={"maxiter": 4000, "xatol": 1e-6, "fatol": 1e-8})
    rg, det = gblup.estimate_bivar_reml(gm, y1, y2, probes=np.eye(2 * n),
                                        max_iter=60, tol=1e-6, cg_tol=1e-8)
    ours = np.array([det[k] for k in ("g11", "g22", "g12",
                                      "e11", "e22", "e12")])
    assert det["exact_traces"] and det["converged"]
    np.testing.assert_allclose(ours, res.x, atol=2e-3)
    assert abs(rg - res.x[2] / np.sqrt(res.x[0] * res.x[1])) < 1e-2


def test_bivar_reml_recovers_signal():
    """Stochastic-probe run on a larger panel: rg tracks the REALIZED
    genetic correlation, h2s land near truth, and independent traits give
    a near-zero rg."""
    n, snps = 600, 2000
    geno = bed.simulate_genotypes(n, snps, seed=9)
    gm = mx.from_dense(geno)
    y1, y2, rg_real = _simulate_bivar(geno, 0.7, 0.5, 0.4, seed=4)
    rg, det = gblup.estimate_bivar_reml(gm, y1, y2, n_probes=16, seed=0)
    assert det["converged"]
    assert abs(rg - rg_real) < 0.3, (rg, rg_real)
    assert rg > 0.25
    assert abs(det["h2_1"] - 0.5) < 0.3
    assert abs(det["h2_2"] - 0.4) < 0.3

    # independent traits (separate QTL draws): rg must be near zero
    ya, _, _ = _simulate_bivar(geno, 0.0, 0.5, 0.5, seed=11)
    _, yb, _ = _simulate_bivar(geno, 0.0, 0.5, 0.5, seed=12)
    rg0, det0 = gblup.estimate_bivar_reml(gm, ya, yb, n_probes=16, seed=0)
    assert abs(rg0) < 0.35, rg0


def test_cli_reml_bivar(tmp_path, capsys):
    """CLI reml --bivar: rG + per-trait h2 from a second-trait file (both
    the FID/IID and bare-value formats)."""
    from miraculix_tpu import cli

    geno = bed.simulate_genotypes(200, 800, seed=15)
    y1, y2, _ = _simulate_bivar(geno, 0.6, 0.5, 0.5, seed=2)
    p = str(tmp_path / "b.bed")
    bed.write_bed(p, geno)
    fam = open(p[:-4] + ".fam").read().splitlines()
    with open(p[:-4] + ".fam", "w") as fh:
        for k, ln in enumerate(fam):
            parts = ln.split()
            parts[5] = f"{y1[k]:.6f}"
            fh.write(" ".join(parts) + "\n")
    p2 = str(tmp_path / "t2.txt")
    with open(p2, "w") as fh:
        for k, ln in enumerate(fam):
            parts = ln.split()
            fh.write(f"{parts[0]} {parts[1]} {y2[k]:.6f}\n")
    assert cli.main(["reml", p, "--bivar", p2, "--probes", "8"]) == 0
    out = capsys.readouterr().out
    assert "rG\t" in out and "bivariate AI-REML" in out

    p3 = str(tmp_path / "t2b.txt")
    with open(p3, "w") as fh:
        fh.writelines(f"{v:.6f}\n" for v in y2)
    assert cli.main(["reml", p, "--bivar", p3, "--probes", "8"]) == 0
    capsys.readouterr()


def test_bivar_reml_sharded_matches_single_chip():
    """estimate_bivar_reml on a 1D-sharded container reproduces the
    single-chip components (same probes, same fixed point)."""
    from miraculix_tpu import parallel

    n, snps = 64, 300
    geno = bed.simulate_genotypes(n, snps, seed=17)
    y1, y2, _ = _simulate_bivar(geno, 0.5, 0.5, 0.5, seed=6)
    gm = mx.from_dense(geno)
    sg = parallel.shard_genotypes(geno, parallel.make_mesh(8))
    # same probes + same iteration count -> identical trajectories up to
    # matvec rounding; ONE AI step (both block CGs) keeps the virtual-mesh
    # runtime sane — the point is container equality of the operator
    kw = dict(n_probes=2, seed=3, max_iter=1, cg_tol=1e-4, cg_maxiter=200)
    rg1, d1 = gblup.estimate_bivar_reml(gm, y1, y2, **kw)
    rg2, d2 = gblup.estimate_bivar_reml(sg, y1, y2, **kw)
    assert abs(rg1 - rg2) < 5e-3, (rg1, rg2)
    for k in ("g11", "g22", "g12", "e11", "e22", "e12"):
        assert abs(d1[k] - d2[k]) < 5e-3, (k, d1[k], d2[k])


def test_cli_reml_bivar_rejects_bad_inputs(tmp_path, capsys):
    """--bivar: -9 sentinel refused, header tolerated, ragged file refused."""
    import pytest as _pytest

    from miraculix_tpu import cli

    geno = bed.simulate_genotypes(60, 300, seed=25)
    y1, y2, _ = _simulate_bivar(geno, 0.5, 0.5, 0.5, seed=7)
    p = str(tmp_path / "m.bed")
    bed.write_bed(p, geno)
    fam = open(p[:-4] + ".fam").read().splitlines()
    with open(p[:-4] + ".fam", "w") as fh:
        for k, ln in enumerate(fam):
            parts = ln.split()
            parts[5] = f"{y1[k]:.6f}"
            fh.write(" ".join(parts) + "\n")

    bad = str(tmp_path / "bad.txt")
    with open(bad, "w") as fh:
        fh.write("-9\n" * 60)
    with _pytest.raises(SystemExit, match="missing phenotype"):
        cli.main(["reml", p, "--bivar", bad, "--probes", "4"])

    ragged = str(tmp_path / "rag.txt")
    with open(ragged, "w") as fh:
        fh.write("F0 I0 1.0\nF1 I1\n")
    with _pytest.raises(SystemExit, match="ragged"):
        cli.main(["reml", p, "--bivar", ragged, "--probes", "4"])

    headered = str(tmp_path / "hdr.txt")
    with open(headered, "w") as fh:
        fh.write("FID IID pheno\n")
        for k, ln in enumerate(fam):
            parts = ln.split()
            fh.write(f"{parts[0]} {parts[1]} {y2[k]:.6f}\n")
    assert cli.main(["reml", p, "--bivar", headered, "--probes", "4"]) == 0
    capsys.readouterr()


def test_multi_reml_t3_dense_local_optimum():
    """t=3: the exact-probe fixed point is a LOCAL MAXIMUM of the dense
    restricted likelihood (computed with explicit matrices, independent of
    the solver's machinery) — boundary-compatible: small-n multivariate
    REML optima routinely sit on the PSD cone's boundary, where the raw
    score need not vanish, so optimality is asserted directly: no feasible
    perturbation improves the criterion, and a Nelder-Mead polish gains
    only a bounded sliver (the step-halved boundary creep)."""
    from scipy.optimize import minimize

    n, snps, t = 72, 400, 3
    geno = bed.simulate_genotypes(n, snps, seed=13)
    gm = mx.from_dense(geno)
    rng = np.random.default_rng(5)
    f = np.where(geno == 3, 0, geno).mean(axis=0) / 2.0
    zc = geno.astype(np.float64) - 2 * f
    gs_mat = zc @ zc.T / (2 * (f * (1 - f)).sum())
    zs = zc / np.sqrt(2 * (f * (1 - f)).sum())
    a = rng.multivariate_normal(
        np.zeros(t), [[1, .6, .2], [.6, 1, .1], [.2, .1, 1]], size=snps)
    u = zs @ a
    u /= u.std(axis=0)
    e = rng.standard_normal((n, t))
    ys = 0.7 * u + 0.7 * e

    sg, se, det = gblup.estimate_multi_reml(
        gm, ys, probes=np.eye(t * n), max_iter=60, tol=1e-7, cg_tol=1e-8)
    assert det["exact_traces"]

    yt = (ys - ys.mean(axis=0)) / ys.std(axis=0)
    yv = yt.reshape(-1)
    x = np.zeros((t * n, t))
    for k in range(t):
        x[k::t, k] = 1.0
    pairs = [(aa, bb) for aa in range(t) for bb in range(aa, t)]

    def unpack(th):
        sgm = np.zeros((t, t))
        sem = np.zeros((t, t))
        for k, (aa, bb) in enumerate(pairs):
            sgm[aa, bb] = sgm[bb, aa] = th[k]
            sem[aa, bb] = sem[bb, aa] = th[len(pairs) + k]
        return sgm, sem

    def nll(th):
        sgm, sem = unpack(th)
        if (np.linalg.eigvalsh(sgm)[0] < -1e-9
                or np.linalg.eigvalsh(sem)[0] <= 1e-8):
            return 1e10
        v = np.kron(gs_mat, sgm) + np.kron(np.eye(n), sem)
        sign, logdet = np.linalg.slogdet(v)
        if sign <= 0:
            return 1e10
        vi = np.linalg.inv(v)
        xtvix = x.T @ vi @ x
        s2, ld2 = np.linalg.slogdet(xtvix)
        if s2 <= 0:
            return 1e10
        pmat = vi - vi @ x @ np.linalg.solve(xtvix, x.T @ vi)
        return 0.5 * (logdet + ld2 + yv @ pmat @ yv)

    th0 = np.concatenate([[sg[aa, bb] for aa, bb in pairs],
                          [se[aa, bb] for aa, bb in pairs]])
    f0 = nll(th0)
    assert f0 < 1e9  # the estimate itself is feasible

    # (a) random feasible perturbations never improve the criterion
    prng = np.random.default_rng(1)
    for _ in range(24):
        d = prng.standard_normal(len(th0)) * 0.02
        fd = nll(th0 + d)
        assert fd >= f0 - 1e-4, (fd, f0)
    # (b) a Nelder-Mead polish STARTED at the estimate improves the
    # criterion only marginally: step-halved AI updates stop slightly
    # short of a BOUNDARY optimum (rank-deficient Sg-hat is generic at
    # n=72) — the gap is bounded, not a wrong fixed point (documented in
    # estimate_multi_reml)
    res = minimize(nll, th0, method="Nelder-Mead",
                   options={"maxiter": 600, "xatol": 1e-7, "fatol": 1e-10})
    assert f0 - res.fun < 0.25, (f0, res.fun)


def test_multi_reml_t3_block_structure():
    """Three traits, the third genetically independent: rg[0,1] tracks the
    realized correlation, rg[0,2]/rg[1,2] land near zero, per-trait h2
    near truth."""
    n, snps, t = 500, 1500, 3
    geno = bed.simulate_genotypes(n, snps, seed=14)
    gm = mx.from_dense(geno)
    rng = np.random.default_rng(8)
    f = np.where(geno == 3, 0, geno).mean(axis=0) / 2.0
    zs = (geno.astype(np.float64) - 2 * f) / np.sqrt(
        2 * (f * (1 - f)).sum())
    a = rng.multivariate_normal(
        np.zeros(t), [[1, .7, 0], [.7, 1, 0], [0, 0, 1]], size=snps)
    u = zs @ a
    u /= u.std(axis=0)
    rg01 = float(np.corrcoef(u[:, 0], u[:, 1])[0, 1])
    e = rng.standard_normal((n, t))
    e /= e.std(axis=0)
    h2s = np.array([0.5, 0.4, 0.6])
    ys = np.sqrt(h2s) * u + np.sqrt(1 - h2s) * e

    sg, se, det = gblup.estimate_multi_reml(gm, ys, n_probes=16, seed=0)
    assert det["converged"]
    assert abs(det["rg"][0, 1] - rg01) < 0.3, (det["rg"][0, 1], rg01)
    assert abs(det["rg"][0, 2]) < 0.35 and abs(det["rg"][1, 2]) < 0.35
    assert np.all(np.abs(det["h2"] - h2s) < 0.3), det["h2"]
    # the returned covariances are PSD and consistent with rg
    assert np.linalg.eigvalsh(sg)[0] > -1e-8
    assert np.linalg.eigvalsh(se)[0] > 0


def test_cli_reml_multi(tmp_path, capsys):
    """CLI reml --multi: t=3 traits from an FID/IID file."""
    from miraculix_tpu import cli

    geno = bed.simulate_genotypes(150, 600, seed=33)
    rng = np.random.default_rng(3)
    f = np.where(geno == 3, 0, geno).mean(axis=0) / 2.0
    zs = (geno.astype(np.float64) - 2 * f) / np.sqrt(
        2 * (f * (1 - f)).sum())
    u = zs @ rng.standard_normal((600, 3))
    u /= u.std(axis=0)
    ys = 0.7 * u + 0.7 * rng.standard_normal((150, 3))
    p = str(tmp_path / "mt.bed")
    bed.write_bed(p, geno)
    ph = str(tmp_path / "ph.txt")
    fam = open(p[:-4] + ".fam").read().splitlines()
    with open(ph, "w") as fh:
        fh.write("FID IID t1 t2 t3\n")
        for k, ln in enumerate(fam):
            parts = ln.split()
            fh.write(f"{parts[0]} {parts[1]} " +
                     " ".join(f"{v:.6f}" for v in ys[k]) + "\n")
    assert cli.main(["reml", p, "--multi", ph, "--probes", "6"]) == 0
    out = capsys.readouterr().out
    assert "3-trait REML" in out and "2,3\t" in out

    # --multi must not touch the .fam phenotype column (traits live in the
    # --multi file; the typical fileset has NA or no 6th column there)
    with open(p[:-4] + ".fam", "w") as fh:
        for ln in fam:
            parts = ln.split()
            fh.write(" ".join(parts[:5]) + " NA\n")
    assert cli.main(["reml", p, "--multi", ph, "--probes", "6"]) == 0
    capsys.readouterr()


def test_multi_v_solver_matches_dense_kron():
    """The jitted traced-Sg/Se inner CG of estimate_multi_reml
    (_multi_v_solver) vs a dense f64 Kronecker
    solve of V = Sg ⊗ G_s + Se ⊗ I (vec order: individual-major,
    trait-minor — V = kron(G_s, Sg) + kron(I, Se))."""
    n, snps, t, m = 96, 500, 3, 5
    geno = bed.simulate_genotypes(n, snps, seed=23)
    gm = mx.from_dense(geno)
    f = np.asarray(gm.freq, np.float64)
    zc = geno.astype(np.float64) - 2 * f
    sig2 = float(gm.sigma2)
    gs = zc @ zc.T / sig2

    sg = np.array([[1.0, 0.5, 0.2], [0.5, 1.2, 0.1], [0.2, 0.1, 0.8]])
    se = np.array([[1.0, 0.3, 0.0], [0.3, 0.9, 0.2], [0.0, 0.2, 1.1]])
    v = np.kron(gs, sg) + np.kron(np.eye(n), se)

    rng = np.random.default_rng(0)
    b3 = rng.standard_normal((n, t, m))
    solve = gblup._multi_v_solver(gm, t, np.diag(gs), cg_tol=1e-6,
                                  cg_maxiter=4000)
    x3, iters = solve(b3, sg, se)
    x_ref = np.linalg.solve(v, b3.reshape(n * t, m))
    rel = (np.linalg.norm(x3.reshape(n * t, m) - x_ref, axis=0)
           / np.linalg.norm(x_ref, axis=0))
    assert rel.max() < 3e-4, rel
    assert 0 < iters <= 4000
    # traced Sg/Se: a second component pair must NOT recompile (same
    # executable) and must still match the dense solve
    sg2, se2 = 0.6 * sg, 1.3 * se
    x3b, _ = solve(b3, sg2, se2)
    v2 = np.kron(gs, sg2) + np.kron(np.eye(n), se2)
    x_ref2 = np.linalg.solve(v2, b3.reshape(n * t, m))
    rel2 = (np.linalg.norm(x3b.reshape(n * t, m) - x_ref2, axis=0)
            / np.linalg.norm(x_ref2, axis=0))
    assert rel2.max() < 3e-4, rel2


def test_multi_reml_device_cg_matches_host():
    """estimate_multi_reml(device_cg=True) — the on-device inner CG — must
    reproduce the host-f64-loop estimates (the oracle path) on a complete
    bivariate panel."""
    n, snps = 120, 700
    geno = bed.simulate_genotypes(n, snps, seed=41)
    gm = mx.from_dense(geno)
    rng = np.random.default_rng(4)
    f = np.where(geno == 3, 0, geno).mean(axis=0) / 2.0
    zs = (geno.astype(np.float64) - 2 * f) / np.sqrt(
        2 * (f * (1 - f)).sum())
    a = rng.multivariate_normal(np.zeros(2), [[1, .6], [.6, 1]], size=snps)
    u = zs @ a
    u /= u.std(axis=0)
    e = rng.standard_normal((n, 2))
    ys = 0.75 * u + 0.66 * e

    sg_d, se_d, det_d = gblup.estimate_multi_reml(
        gm, ys, n_probes=8, seed=0, device_cg=True)
    sg_h, se_h, det_h = gblup.estimate_multi_reml(
        gm, ys, n_probes=8, seed=0, device_cg=False)
    np.testing.assert_allclose(sg_d, sg_h, atol=5e-3)
    np.testing.assert_allclose(se_d, se_h, atol=5e-3)
    np.testing.assert_allclose(det_d["h2"], det_h["h2"], atol=5e-3)


def test_cli_reml_bivar_rejects_two_column_file(tmp_path, capsys):
    """A 2-column --bivar file is ambiguous (numeric IIDs would silently
    be read as phenotypes) — must exit with a clear message."""
    import pytest

    from miraculix_tpu import cli

    geno = bed.simulate_genotypes(50, 200, seed=9)
    rng = np.random.default_rng(0)
    y = rng.standard_normal(50)
    p = str(tmp_path / "b.bed")
    bed.write_bed(p, geno)
    fam = open(p[:-4] + ".fam").read().splitlines()
    with open(p[:-4] + ".fam", "w") as fh:
        for k, ln in enumerate(fam):
            parts = ln.split()
            parts[5] = f"{y[k]:.5f}"
            fh.write(" ".join(parts) + "\n")
    bv = str(tmp_path / "t2.txt")
    with open(bv, "w") as fh:
        for k in range(50):
            fh.write(f"{k} {y[k]:.5f}\n")   # "IID value" — ambiguous
    with pytest.raises(SystemExit, match="2 columns"):
        cli.main(["reml", p, "--bivar", bv])
    capsys.readouterr()


def test_multi_reml_streamed_device_cg_matches_host(tmp_path):
    """estimate_multi_reml on a StreamedGeno with the device-vector
    streamed inner CG (_multi_v_solver_streamed) must
    reproduce the host-f64-loop estimates on the same streamed panel."""
    n, snps = 120, 700
    geno = bed.simulate_genotypes(n, snps, seed=41)
    path = str(tmp_path / "m.bed")
    bed.write_bed(path, geno)
    from miraculix_tpu.streamed import StreamedGeno

    st = StreamedGeno.from_bed(path, chunk_snps=256)
    assert st.n_chunks == 3
    rng = np.random.default_rng(4)
    f = np.where(geno == 3, 0, geno).mean(axis=0) / 2.0
    zs = (geno.astype(np.float64) - 2 * f) / np.sqrt(
        2 * (f * (1 - f)).sum())
    a = rng.multivariate_normal(np.zeros(2), [[1, .6], [.6, 1]], size=snps)
    u = zs @ a
    u /= u.std(axis=0)
    e = rng.standard_normal((n, 2))
    ys = 0.75 * u + 0.66 * e

    sg_d, se_d, det_d = gblup.estimate_multi_reml(
        st, ys, n_probes=8, seed=0, device_cg=True)
    sg_h, se_h, det_h = gblup.estimate_multi_reml(
        st, ys, n_probes=8, seed=0, device_cg=False)
    np.testing.assert_allclose(sg_d, sg_h, atol=5e-3)
    np.testing.assert_allclose(se_d, se_h, atol=5e-3)
    np.testing.assert_allclose(det_d["h2"], det_h["h2"], atol=5e-3)

    # HBM-cached route: all chunks pinned -> the fully-compiled
    # _multi_v_cg_cached path; must agree with the host loop too
    assert st.cache_to_device(budget_bytes=1 << 40) == st.n_chunks
    sg_c, se_c, det_c = gblup.estimate_multi_reml(
        st, ys, n_probes=8, seed=0, device_cg=True)
    np.testing.assert_allclose(sg_c, sg_h, atol=5e-3)
    np.testing.assert_allclose(det_c["h2"], det_h["h2"], atol=5e-3)
