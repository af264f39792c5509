"""GWAS linear scan: must match per-SNP numpy least-squares exactly."""
import numpy as np
import pytest

import miraculix_tpu as mx
from miraculix_tpu.gwas import gwas_linear
from miraculix_tpu.io import bed


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _oracle(g, y, x):
    """Per-SNP OLS with covariates, direct lstsq."""
    n, snps = g.shape
    beta = np.zeros(snps)
    se = np.zeros(snps)
    t = np.zeros(snps)
    df = n - x.shape[1] - 1
    for s in range(snps):
        xs = np.concatenate([x, g[:, s: s + 1].astype(np.float64)], axis=1)
        coef, _, rank, _ = np.linalg.lstsq(xs, y, rcond=None)
        resid = y - xs @ coef
        sigma2 = (resid @ resid) / df
        cov = sigma2 * np.linalg.inv(xs.T @ xs)
        beta[s] = coef[-1]
        se[s] = np.sqrt(cov[-1, -1])
        t[s] = beta[s] / se[s] if se[s] > 0 else 0.0
    return beta, se, t


def test_gwas_matches_per_snp_ols(rng):
    g = bed.simulate_genotypes(150, 80, seed=7)
    gm = mx.from_dense(g)
    cov = rng.standard_normal((150, 2))
    x = np.concatenate([np.ones((150, 1)), cov], axis=1)
    # phenotype with real signal on a few SNPs
    y = (1.0 * g[:, 3] - 0.8 * g[:, 50] + x @ np.array([1.0, 0.5, -0.2])
         + rng.standard_normal(150))
    res = gwas_linear(gm, y, covariates=cov)
    wb, wse, wt = _oracle(g, y, x)
    np.testing.assert_allclose(res.beta, wb, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(res.se, wse, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(res.t, wt, rtol=3e-4, atol=1e-4)
    assert res.df == 150 - 3 - 1
    # the causal SNPs should surface
    assert res.p[3] < 1e-6 and res.p[50] < 1e-4
    assert np.isfinite(res.p).all()


def test_gwas_no_covariates(rng):
    g = bed.simulate_genotypes(120, 40, seed=8)
    gm = mx.from_dense(g)
    y = 1.0 * g[:, 10] + rng.standard_normal(120)
    res = gwas_linear(gm, y)
    x = np.ones((120, 1))
    wb, wse, wt = _oracle(g, y, x)
    np.testing.assert_allclose(res.beta, wb, rtol=2e-4, atol=1e-6)
    assert res.p[10] < 1e-4


def test_gwas_monomorphic_snp_is_zero(rng):
    g = bed.simulate_genotypes(100, 20, seed=9)
    g[:, 5] = 1  # constant dosage: d_s = 0 after projection
    gm = mx.from_dense(g)
    y = rng.standard_normal(100)
    res = gwas_linear(gm, y)
    assert res.beta[5] == 0.0 and res.t[5] == 0.0


def test_gwas_streamed_matches_in_memory(tmp_path, rng):
    from miraculix_tpu.streamed import StreamedGeno

    g = bed.simulate_genotypes(100, 700, seed=12)
    path = str(tmp_path / "gw.bed")
    bed.write_bed(path, g)
    y = 0.8 * g[:, 99] + rng.standard_normal(100)
    r_mem = gwas_linear(mx.from_dense(g), y)
    r_str = gwas_linear(StreamedGeno.from_bed(path, chunk_snps=256), y)
    np.testing.assert_allclose(r_str.beta, r_mem.beta, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(r_str.t, r_mem.t, rtol=1e-3, atol=1e-4)


def test_gwas_mixed_matches_dense_grammar(rng):
    """GRAMMAR-gamma vs a dense float64 replication: same V^-1 rotation,
    same gamma construction — statistics must agree closely; and on a
    structured panel the mixed scan must deflate the inflation the plain
    linear scan shows (median chi2 closer to its null expectation)."""
    from miraculix_tpu.gwas import gwas_mixed

    # two diverged subpopulations + phenotype shifted by population -> the
    # classic confounding that inflates the unadjusted scan
    r2 = np.random.default_rng(3)
    maf_a = r2.uniform(0.1, 0.5, 500)
    maf_b = np.clip(maf_a + r2.normal(0, 0.18, 500), 0.02, 0.98)
    rows = []
    for maf, k in ((maf_a, 60), (maf_b, 60)):
        u = r2.random((k, 500))
        hom = (1 - maf) ** 2
        het = hom + 2 * maf * (1 - maf)
        rows.append(np.where(u < hom, 0, np.where(u < het, 1, 2)))
    g = np.concatenate(rows).astype(np.uint8)
    pop = np.concatenate([np.zeros(60), np.ones(60)])
    y = 0.8 * pop + r2.standard_normal(120) * 0.5
    gm = mx.from_dense(g)

    h2 = 0.5
    res = gwas_mixed(gm, y, h2=h2, n_gamma_snps=48, tol=1e-8, seed=1)

    # dense float64 replication
    f = np.asarray(gm.freq, np.float64)
    zc = g.astype(np.float64) - 2.0 * f[None, :]
    sigma2 = float(gm.sigma2)
    lam = (1.0 - h2) / h2
    v = zc @ zc.T / sigma2 + lam * np.eye(120)
    x = np.ones((120, 1))
    m_proj = np.eye(120) - x @ np.linalg.inv(x.T @ x) @ x.T
    y_res = (m_proj @ y)
    ystar = np.linalg.solve(v, y_res)
    zf = g.astype(np.float64)
    u_ref = zf.T @ (m_proj @ ystar)
    d_ref = np.einsum("ns,ns->s", zf, m_proj @ zf)
    np.testing.assert_allclose(
        np.asarray(mx.gwas_linear(gm, y).beta) * 0 + d_ref, d_ref)  # shape
    # compare chi2 up to the sampled-gamma (use the dense gamma over the
    # same sampled set is unavailable; instead check correlation + scale)
    chi_ref = u_ref ** 2 / d_ref
    mask = (d_ref > 1e-9) & (chi_ref > 1e-3)  # tiny chi2 amplifies rel err
    ratio = res.chi2[mask] * res.gamma / chi_ref[mask]
    assert np.abs(ratio - 1.0).max() < 2e-2  # U and d agree to f32 grade
    assert 0.2 < res.gamma < 1.0
    # inflation control: mixed median chi2 << linear median chi2
    lin = mx.gwas_linear(gm, y)
    med_lin = np.median(lin.t[mask] ** 2)
    med_mix = np.median(res.chi2[mask])
    assert med_mix < med_lin


def test_gwas_logistic_matches_per_snp_score(rng):
    """Logistic score scan vs a direct per-SNP score-test oracle (same
    null fit): U, V and the z-statistic must agree to f32 grade, and the
    causal SNP must surface."""
    from miraculix_tpu.gwas import gwas_logistic

    r2 = np.random.default_rng(4)
    g = bed.simulate_genotypes(300, 60, seed=10)
    cov = r2.standard_normal(300)
    eta = -0.4 + 0.9 * g[:, 7] - 1.1 * g[:, 40] + 0.5 * cov
    y = (r2.random(300) < 1.0 / (1.0 + np.exp(-eta))).astype(np.float64)
    gm = mx.from_dense(g)
    res = gwas_logistic(gm, y, covariates=cov)

    # oracle: same null IRLS, per-SNP score statistic in float64
    x = np.concatenate([np.ones((300, 1)), cov[:, None]], axis=1)
    b0 = np.zeros(2)
    for _ in range(60):
        mu = 1.0 / (1.0 + np.exp(-(x @ b0)))
        w = np.maximum(mu * (1 - mu), 1e-12)
        wx = x * w[:, None]
        b0 = np.linalg.solve(x.T @ wx, wx.T @ (x @ b0 + (y - mu) / w))
    mu = 1.0 / (1.0 + np.exp(-(x @ b0)))
    w = np.maximum(mu * (1 - mu), 1e-12)
    wx = x * w[:, None]
    xtwx_inv = np.linalg.inv(x.T @ wx)
    zf = g.astype(np.float64)
    u = zf.T @ (y - mu)
    a = zf.T @ wx
    v = np.einsum("ns,n,ns->s", zf, w, zf) - np.einsum(
        "sp,pq,sq->s", a, xtwx_inv, a)
    zref = u / np.sqrt(v)
    np.testing.assert_allclose(res.t, zref, rtol=5e-4, atol=5e-4)
    assert res.p[7] < 1e-6 and res.p[40] < 1e-3
    assert np.isfinite(res.p).all()


def test_gwas_logistic_streamed_matches(tmp_path, rng):
    from miraculix_tpu.gwas import gwas_logistic
    from miraculix_tpu.streamed import StreamedGeno

    r2 = np.random.default_rng(6)
    g = bed.simulate_genotypes(150, 600, seed=14)
    eta = -0.2 + 0.8 * g[:, 10]
    y = (r2.random(150) < 1.0 / (1.0 + np.exp(-eta))).astype(np.float64)
    path = str(tmp_path / "lg.bed")
    bed.write_bed(path, g)
    r_mem = gwas_logistic(mx.from_dense(g), y)
    r_str = gwas_logistic(StreamedGeno.from_bed(path, chunk_snps=256), y)
    np.testing.assert_allclose(r_str.t, r_mem.t, rtol=1e-4, atol=1e-4)


def test_gwas_mixed_loco_matches_dense(rng):
    """LOCO GRAMMAR-gamma vs a dense float64 per-chromosome replication,
    and the proximal-contamination property: a strong causal SNP's own
    statistic is LARGER under LOCO than when the GRM contains it."""
    from miraculix_tpu.gwas import gwas_mixed, gwas_mixed_loco

    r2 = np.random.default_rng(11)
    n, s = 150, 600
    g = bed.simulate_genotypes(n, s, seed=31)
    chrom = np.repeat([1, 2, 3], s // 3)
    causal = 50  # on chromosome 1
    zc_all = g.astype(np.float64)
    y = 1.2 * (zc_all[:, causal] - zc_all[:, causal].mean()) \
        + r2.standard_normal(n)
    gm = mx.from_dense(g)
    h2 = 0.5
    lam = (1 - h2) / h2

    res = gwas_mixed_loco(gm, y, chrom, h2=h2, n_gamma_snps=40,
                          tol=1e-8, seed=2)

    # dense replication for chromosome 1
    f = np.asarray(gm.freq, np.float64)
    zc = g.astype(np.float64) - 2.0 * f[None, :]
    m1 = chrom == 1
    s2_loco = float(gm.sigma2) - float(2 * np.sum(f[m1] * (1 - f[m1])))
    v = zc[:, ~m1] @ zc[:, ~m1].T / s2_loco + lam * np.eye(n)
    x = np.ones((n, 1))
    mp = np.eye(n) - x @ np.linalg.inv(x.T @ x) @ x.T
    ystar = mp @ np.linalg.solve(v, mp @ y)
    zf = g.astype(np.float64)
    u_ref = zf[:, m1].T @ ystar
    d_ref = np.einsum("ns,ns->s", zf[:, m1], mp @ zf[:, m1])
    chi_ref = u_ref ** 2 / d_ref  # up to gamma
    got = res.chi2[m1]
    mask = (chi_ref > 1e-2) & (d_ref > 1e-9)
    # same statistics up to the per-chromosome gamma scale factor
    scale = np.median(got[mask] / chi_ref[mask])
    assert np.abs(got[mask] / chi_ref[mask] / scale - 1).max() < 2e-2

    # proximal contamination: LOCO must recover MORE causal signal
    res_full = gwas_mixed(gm, y, h2=h2, n_gamma_snps=40, tol=1e-8, seed=2)
    assert res.chi2[causal] > res_full.chi2[causal]
    # and the causal SNP is the top hit under LOCO
    assert np.argmax(res.chi2) == causal


def test_cli_gwas_writes_variant_ids(tmp_path, capsys):
    """CLI gwas TSVs carry chr/snp/bp from the .bim (downstream tools key
    on variant ids, not row indices), for all three scan types."""
    import numpy as np

    from miraculix_tpu import cli
    from miraculix_tpu.io import bed as bedio

    geno = bedio.simulate_genotypes(120, 300, seed=3)
    rng = np.random.default_rng(0)
    y = geno[:, 7] * 0.8 + rng.standard_normal(120)
    p = str(tmp_path / "g.bed")
    bedio.write_bed(p, geno)
    fam = open(p[:-4] + ".fam").read().splitlines()
    with open(p[:-4] + ".fam", "w") as fh:
        for k, ln in enumerate(fam):
            parts = ln.split()
            parts[5] = f"{y[k]:.6f}"
            fh.write(" ".join(parts) + "\n")

    out = str(tmp_path / "scan.tsv")
    assert cli.main(["gwas", p, "-o", out]) == 0
    rows = [ln.rstrip("\n").split("\t") for ln in open(out)]
    assert rows[0] == ["chr", "snp", "bp", "beta", "se", "t", "p"]
    assert len(rows) == 1 + 300 and rows[1][1] == "snp0"

    assert cli.main(["gwas", p, "-o", out, "--mixed"]) == 0
    rows = [ln.rstrip("\n").split("\t") for ln in open(out)]
    assert rows[0] == ["chr", "snp", "bp", "beta", "chi2", "p"]
    assert len(rows) == 1 + 300

    yb = (y > np.median(y)).astype(int) + 1   # plink 1/2 coding
    with open(p[:-4] + ".fam", "w") as fh:
        for k, ln in enumerate(fam):
            parts = ln.split()
            parts[5] = str(yb[k])
            fh.write(" ".join(parts) + "\n")
    assert cli.main(["gwas", p, "-o", out, "--logistic"]) == 0
    rows = [ln.rstrip("\n").split("\t") for ln in open(out)]
    assert rows[0] == ["chr", "snp", "bp", "beta", "se", "z", "p"]
    assert len(rows) == 1 + 300
    capsys.readouterr()


def test_gwas_mixed_streamed_matches_materialized(tmp_path):
    """gwas_mixed on a StreamedGeno (host-driven chunked CG) == the
    materialized-panel scan."""
    import miraculix_tpu as mx
    from miraculix_tpu import gwas_mixed
    from miraculix_tpu.io import bed as bedio
    from miraculix_tpu.streamed import StreamedGeno

    n, snps = 200, 600
    geno = bedio.simulate_genotypes(n, snps, seed=61)
    rng = np.random.default_rng(1)
    y = (geno[:, :4] @ rng.standard_normal(4) * 0.4
         + rng.standard_normal(n))
    p = str(tmp_path / "s.bed")
    bedio.write_bed(p, geno)
    gm = mx.from_bed(p)
    sg = StreamedGeno.from_bed(p, chunk_snps=256)  # 3 ragged chunks
    a = gwas_mixed(gm, y, h2=0.5, tol=1e-8, maxiter=3000, seed=3)
    b = gwas_mixed(sg, y, h2=0.5, tol=1e-8, maxiter=3000, seed=3)
    np.testing.assert_allclose(b.chi2, a.chi2, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(b.beta, a.beta, rtol=2e-3, atol=2e-3)


def test_gwas_loco_subset_no_densify(tmp_path, monkeypatch):
    """The LOCO scan never decodes the panel to dense on host: the
    chromosome panels come from geno.subset_snps (device 2-bit gather)."""
    import miraculix_tpu as mx
    from miraculix_tpu import gwas_mixed_loco
    from miraculix_tpu.io import bed as bedio, codec

    def boom(*a, **k):  # the old host decode path must be gone
        raise AssertionError("LOCO densified via unpack_planar16_cols")

    monkeypatch.setattr(codec, "unpack_planar16_cols", boom)
    n, snps = 150, 400
    geno = bedio.simulate_genotypes(n, snps, seed=62)
    rng = np.random.default_rng(2)
    y = geno[:, 5] * 0.5 + rng.standard_normal(n)
    gm = mx.from_dense(geno)
    chrom = np.repeat([1, 2], snps // 2)
    res = gwas_mixed_loco(gm, y, chrom=chrom, h2=0.4, tol=1e-6,
                          maxiter=2000)
    assert np.isfinite(res.chi2).all()
    assert res.chi2[5] > np.median(res.chi2) * 3


def test_cli_gwas_guards(tmp_path, capsys):
    """CLI gwas input guards: -9 phenotypes rejected with remediation
    (PLINK missing code regressed as a real value = silent garbage),
    --stream-chunk without .fam phenotypes refuses to densify, and
    --loco + --stream-chunk is rejected (LOCO subsets the device panel)."""
    import numpy as np
    import pytest

    from miraculix_tpu import cli
    from miraculix_tpu.io import bed as bedio

    geno = bedio.simulate_genotypes(60, 200, seed=5)
    rng = np.random.default_rng(1)
    y = rng.standard_normal(60)
    p = str(tmp_path / "g.bed")
    bedio.write_bed(p, geno)
    fam = open(p[:-4] + ".fam").read().splitlines()

    def write_pheno(vals):
        with open(p[:-4] + ".fam", "w") as fh:
            for k, ln in enumerate(fam):
                parts = ln.split()
                parts[5] = str(vals[k])
                fh.write(" ".join(parts) + "\n")

    out = str(tmp_path / "o.tsv")
    yv = [f"{v:.5f}" for v in y]
    yv[3] = "-9"
    write_pheno(yv)
    with pytest.raises(SystemExit, match="missing phenotype"):
        cli.main(["gwas", p, "-o", out])

    write_pheno(["-9"] * 60)  # ALL missing + streamed: refuse to densify
    with pytest.raises(SystemExit, match="stream-chunk"):
        cli.main(["gwas", p, "-o", out, "--stream-chunk", "128"])

    write_pheno([f"{v:.5f}" for v in y])
    with pytest.raises(SystemExit, match="loco"):
        cli.main(["gwas", p, "-o", out, "--stream-chunk", "128",
                  "--mixed", "--loco"])
    capsys.readouterr()


def test_gwas_mixed_loco_rejects_streamed(tmp_path):
    from miraculix_tpu import gwas
    from miraculix_tpu.io import bed as bedio
    from miraculix_tpu.streamed import StreamedGeno

    import numpy as np
    import pytest

    p = str(tmp_path / "s.bed")
    bedio.write_bed(p, bedio.simulate_genotypes(40, 120, seed=2))
    sg = StreamedGeno.from_bed(p, chunk_snps=64)
    with pytest.raises(TypeError, match="GenoMatrix"):
        gwas.gwas_mixed_loco(sg, np.zeros(40), np.zeros(120, np.int64))


# ---------------------------------------------------------------------------
# Sharded (multi-card) GWAS: the scan must run on the
# distributed container with device-count-independent answers.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sharded_gwas_panel():
    import jax

    from miraculix_tpu import parallel

    assert len(jax.devices()) >= 8
    n, s = 150, 600
    g = bed.simulate_genotypes(n, s, seed=31)
    rng = np.random.default_rng(11)
    y = (1.2 * (g[:, 50].astype(np.float64)
                - g[:, 50].astype(np.float64).mean())
         + rng.standard_normal(n))
    gm = mx.from_dense(g)
    sg8 = parallel.shard_genotypes(g, parallel.make_mesh(8))
    sg1 = parallel.shard_genotypes(g, parallel.make_mesh(1))
    return g, gm, sg8, sg1, y


def test_gwas_linear_sharded_matches(sharded_gwas_panel, rng):
    g, gm, sg8, sg1, y = sharded_gwas_panel
    cov = np.random.default_rng(5).standard_normal((150, 2))
    r_mem = gwas_linear(gm, y, covariates=cov)
    for sg in (sg8, sg1):
        r_sh = gwas_linear(sg, y, covariates=cov)
        np.testing.assert_allclose(r_sh.beta, r_mem.beta, rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(r_sh.t, r_mem.t, rtol=1e-3, atol=1e-4)


def test_gwas_mixed_sharded_matches(sharded_gwas_panel):
    from miraculix_tpu.gwas import gwas_mixed

    g, gm, sg8, _, y = sharded_gwas_panel
    r_mem = gwas_mixed(gm, y, h2=0.5, n_gamma_snps=40, tol=1e-8, seed=2)
    r_sh = gwas_mixed(sg8, y, h2=0.5, n_gamma_snps=40, tol=1e-8, seed=2)
    assert abs(r_sh.gamma - r_mem.gamma) / r_mem.gamma < 1e-3
    mask = r_mem.chi2 > 1e-3
    np.testing.assert_allclose(r_sh.chi2[mask], r_mem.chi2[mask],
                               rtol=5e-3, atol=1e-5)
    assert np.argmax(r_sh.chi2) == np.argmax(r_mem.chi2)


def test_gwas_logistic_sharded_matches(sharded_gwas_panel):
    from miraculix_tpu.gwas import gwas_logistic

    g, gm, sg8, _, y = sharded_gwas_panel
    yb = (y > np.median(y)).astype(np.float64)
    r_mem = gwas_logistic(gm, yb)
    r_sh = gwas_logistic(sg8, yb)
    np.testing.assert_allclose(r_sh.t, r_mem.t, rtol=1e-4, atol=1e-6)


def test_gwas_mixed_loco_sharded_matches(sharded_gwas_panel):
    """Sharded LOCO (masked operator, ONE executable for all chromosomes)
    == the single-chip repacking LOCO."""
    from miraculix_tpu.gwas import gwas_mixed_loco

    g, gm, sg8, _, y = sharded_gwas_panel
    chrom = np.repeat([1, 2, 3], 200)
    r_mem = gwas_mixed_loco(gm, y, chrom, h2=0.5, n_gamma_snps=40,
                            tol=1e-8, seed=2)
    r_sh = gwas_mixed_loco(sg8, y, chrom, h2=0.5, n_gamma_snps=40,
                           tol=1e-8, seed=2)
    mask = r_mem.chi2 > 1e-3
    np.testing.assert_allclose(r_sh.chi2[mask], r_mem.chi2[mask],
                               rtol=5e-3, atol=1e-5)
    assert np.argmax(r_sh.chi2) == np.argmax(r_mem.chi2) == 50


def test_cli_gwas_mesh_matches_single_chip(tmp_path, capsys):
    """cli gwas --mesh N: the distributed scan writes the same statistics
    as the single-chip run on the same fileset."""
    import numpy as np

    from miraculix_tpu import cli
    from miraculix_tpu.io import bed as bedio

    geno = bedio.simulate_genotypes(100, 400, seed=6)
    rng = np.random.default_rng(1)
    y = geno[:, 11] * 0.9 + rng.standard_normal(100)
    p = str(tmp_path / "m.bed")
    bedio.write_bed(p, geno)
    fam = open(p[:-4] + ".fam").read().splitlines()
    with open(p[:-4] + ".fam", "w") as fh:
        for k, ln in enumerate(fam):
            parts = ln.split()
            parts[5] = f"{y[k]:.6f}"
            fh.write(" ".join(parts) + "\n")

    out1 = str(tmp_path / "one.tsv")
    out8 = str(tmp_path / "mesh.tsv")
    assert cli.main(["gwas", p, "-o", out1]) == 0
    assert cli.main(["gwas", p, "-o", out8, "--mesh", "8"]) == 0
    r1 = np.loadtxt(out1, skiprows=1, usecols=(3, 4, 5))
    r8 = np.loadtxt(out8, skiprows=1, usecols=(3, 4, 5))
    np.testing.assert_allclose(r8, r1, rtol=2e-3, atol=1e-5)

    # mixed + LOCO ride the sharded operators too
    assert cli.main(["gwas", p, "-o", out8, "--mesh", "8", "--mixed",
                     "--loco"]) == 0
    rows = [ln.split("\t") for ln in open(out8)]
    assert rows[0][0] == "chr" and len(rows) == 1 + 400
    # --mesh and --stream-chunk are mutually exclusive
    import pytest

    with pytest.raises(SystemExit):
        cli.main(["gwas", p, "--mesh", "2", "--stream-chunk", "128"])
    capsys.readouterr()
