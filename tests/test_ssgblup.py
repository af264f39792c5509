"""Single-step GBLUP: the matrix-free H^-1 operator and the full MME
solve against dense float64 oracles."""
import numpy as np
import pytest

import miraculix_tpu as mx
from miraculix_tpu import pedigree as ped
from miraculix_tpu import ssgblup as ss
from miraculix_tpu.io import bed
from miraculix_tpu.ops import ref_impl

N_ANIM, N_GENO, N_SNPS = 120, 48, 600
BLEND, TAU, OMEGA = 0.05, 1.0, 1.0


@pytest.fixture(scope="module")
def panel():
    sire, dam = ped.simulate_pedigree(N_ANIM, n_founders=15, seed=4,
                                      unknown_rate=0.1)
    rng = np.random.default_rng(9)
    geno_ids = np.sort(rng.choice(N_ANIM, size=N_GENO, replace=False)) + 1
    geno = bed.simulate_genotypes(N_GENO, N_SNPS, seed=11)
    gm = mx.from_dense(geno)
    hinv = ss.SingleStepHInv(sire, dam, gm, geno_ids, blend=BLEND,
                             tau=TAU, omega=OMEGA, inner_tol=1e-7,
                             inner_maxiter=4000)

    # dense oracle pieces
    a = ped.a_matrix(sire, dam)
    ainv_d = np.linalg.inv(a)
    a22 = a[np.ix_(geno_ids - 1, geno_ids - 1)]
    freq = np.asarray(gm.freq, np.float64)
    gs = ref_impl.grm_oracle(geno, freq, scale=True)
    gw = (1 - BLEND) * gs + BLEND * np.eye(N_GENO)
    hinv_d = ainv_d.copy()
    blk = TAU * np.linalg.inv(gw) - OMEGA * np.linalg.inv(a22)
    hinv_d[np.ix_(geno_ids - 1, geno_ids - 1)] += blk
    return sire, dam, geno_ids, geno, gm, hinv, hinv_d


def test_hinv_matvec_matches_dense(panel):
    _, _, _, _, _, hinv, hinv_d = panel
    rng = np.random.default_rng(0)
    v = rng.standard_normal((N_ANIM, 3)).astype(np.float32)
    got = np.asarray(hinv.matvec(v), np.float64)
    want = hinv_d @ v
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-4, (
        np.abs(got - want).max())


def test_a22_inv_block_identity(panel):
    """A22^-1 from the blocks of sparse A^-1 must equal inv(A[geno,geno])."""
    sire, dam, geno_ids, _, _, hinv, _ = panel
    a = ped.a_matrix(sire, dam)
    a22 = a[np.ix_(geno_ids - 1, geno_ids - 1)]
    rng = np.random.default_rng(1)
    v = rng.standard_normal((N_GENO, 2)).astype(np.float32)
    got = np.asarray(hinv.a22_inv(v), np.float64)
    want = np.linalg.solve(a22, v)
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-4


def test_gw_inv(panel):
    _, _, _, geno, gm, hinv, _ = panel
    freq = np.asarray(gm.freq, np.float64)
    gw = ((1 - BLEND) * ref_impl.grm_oracle(geno, freq, scale=True)
          + BLEND * np.eye(N_GENO))
    rng = np.random.default_rng(2)
    v = rng.standard_normal((N_GENO, 2)).astype(np.float32)
    got = np.asarray(hinv.gw_inv(v), np.float64)
    want = np.linalg.solve(gw, v)
    assert np.abs(got - want).max() / np.abs(want).max() < 5e-4


def test_ssgblup_matches_dense_mme(panel):
    """Full single-step solve == dense MME solve (phenotypes on a subset
    of animals, some genotyped, some not; intercept + one covariate)."""
    sire, dam, geno_ids, _, _, hinv, hinv_d = panel
    rng = np.random.default_rng(3)
    obs_ids = np.sort(rng.choice(N_ANIM, size=90, replace=False)) + 1
    xmat = np.column_stack([np.ones(90), rng.standard_normal(90)])
    h2 = 0.4
    lam = (1 - h2) / h2
    u_true = rng.standard_normal(N_ANIM)
    y = xmat @ [1.0, 0.5] + u_true[obs_ids - 1] \
        + 0.7 * rng.standard_normal(90)

    res = ss.ssgblup(y, hinv, obs_ids=obs_ids, x=xmat, h2=h2, tol=1e-7,
                     maxiter=5000)

    w = np.zeros((90, N_ANIM))
    w[np.arange(90), obs_ids - 1] = 1.0
    top = np.column_stack([xmat.T @ xmat, xmat.T @ w])
    bottom = np.column_stack([w.T @ xmat, w.T @ w + lam * hinv_d])
    mme = np.vstack([top, bottom])
    rhs = np.concatenate([xmat.T @ y, w.T @ y])
    z = np.linalg.solve(mme, rhs)

    assert np.abs(res.beta - z[:2]).max() < 5e-3, (res.beta, z[:2])
    denom = np.abs(z[2:]).max()
    assert np.abs(res.u - z[2:]).max() / denom < 5e-3
    # genomic information must actually move genotyped predictions:
    # compare against a pedigree-only (plain A^-1) fit
    res_a = _pedigree_only(sire, dam, y, obs_ids, xmat, lam)
    moved = np.abs(res.u[geno_ids - 1] - res_a[geno_ids - 1]).max()
    assert moved > 1e-3


def _pedigree_only(sire, dam, y, obs_ids, xmat, lam):
    a = ped.a_matrix(sire, dam)
    n = len(sire)
    n_obs = len(y)
    w = np.zeros((n_obs, n))
    w[np.arange(n_obs), obs_ids - 1] = 1.0
    mme = np.vstack([
        np.column_stack([xmat.T @ xmat, xmat.T @ w]),
        np.column_stack([w.T @ xmat, w.T @ w + lam * np.linalg.inv(a)]),
    ])
    rhs = np.concatenate([xmat.T @ y, w.T @ y])
    return np.linalg.solve(mme, rhs)[xmat.shape[1]:]


def test_ssgblup_repeated_records(panel):
    """Animals with multiple records: W'W counts > 1 must be handled."""
    _, _, _, _, _, hinv, hinv_d = panel
    rng = np.random.default_rng(5)
    obs_ids = np.concatenate([np.arange(1, 61), np.arange(1, 31)])
    y = rng.standard_normal(len(obs_ids))
    res = ss.ssgblup(y, hinv, obs_ids=obs_ids, h2=0.5, tol=1e-7,
                     maxiter=5000)
    n_obs = len(y)
    w = np.zeros((n_obs, N_ANIM))
    w[np.arange(n_obs), obs_ids - 1] = 1.0
    x = np.ones((n_obs, 1))
    mme = np.vstack([
        np.column_stack([x.T @ x, x.T @ w]),
        np.column_stack([w.T @ x, w.T @ w + 1.0 * hinv_d]),
    ])
    z = np.linalg.solve(mme, np.concatenate([x.T @ y, w.T @ y]))
    assert np.abs(res.u - z[1:]).max() / np.abs(z[1:]).max() < 5e-3


def test_run_ssgblup_cli_path(tmp_path):
    """File-driven single-step: pedigree file with string labels, .bed of
    the genotyped subset, separate phenotype file covering non-genotyped
    animals too."""
    from miraculix_tpu.ssgblup import run_ssgblup

    rng = np.random.default_rng(7)
    sire, dam = ped.simulate_pedigree(80, n_founders=12, seed=6)
    labels = [f"an{i+1}" for i in range(80)]
    pedf = tmp_path / "ped.txt"
    with open(pedf, "w") as fh:
        for i in range(80):
            fh.write(f"{labels[i]} "
                     f"{labels[sire[i]-1] if sire[i] else 'NA'} "
                     f"{labels[dam[i]-1] if dam[i] else 'NA'}\n")

    geno_idx = np.arange(40, 80)  # 0-based pedigree positions genotyped
    geno = bed.simulate_genotypes(40, 300, seed=2)
    bedp = str(tmp_path / "g.bed")
    bed.write_bed(bedp, geno)
    # rewrite .fam IIDs to the pedigree labels
    fam = open(bedp[:-4] + ".fam").read().splitlines()
    with open(bedp[:-4] + ".fam", "w") as fh:
        for k, ln in enumerate(fam):
            parts = ln.split()
            parts[1] = labels[geno_idx[k]]
            fh.write(" ".join(parts) + "\n")

    phenf = tmp_path / "pheno.txt"
    with open(phenf, "w") as fh:
        for i in range(60):  # records on animals 1..60 (mostly ungenotyped)
            fh.write(f"{labels[i]} {rng.standard_normal():.5f}\n")

    out = str(tmp_path / "ebv.tsv")
    rc = run_ssgblup(bedp, str(pedf), pheno_path=str(phenf), out=out,
                     h2=0.4, tol=1e-6)
    assert rc == 0
    lines = open(out).read().splitlines()
    assert len(lines) == 81  # header + every pedigree animal
    got = {ln.split("\t")[0]: ln.split("\t") for ln in lines[1:]}
    assert sum(int(v[2]) for v in got.values()) == 40  # genotyped flags
    assert all(np.isfinite(float(v[1])) for v in got.values())


def _oracle_mme(hinv_d, y, obs_ids, x, h2):
    n_anim = hinv_d.shape[0]
    n_obs = len(y)
    lam = (1 - h2) / h2
    w = np.zeros((n_obs, n_anim))
    w[np.arange(n_obs), obs_ids - 1] = 1.0
    mme = np.vstack([
        np.column_stack([x.T @ x, x.T @ w]),
        np.column_stack([w.T @ x, w.T @ w + lam * hinv_d]),
    ])
    rhs = np.concatenate([x.T @ y, w.T @ y])
    return np.linalg.solve(mme, rhs)


@pytest.fixture(scope="module")
def containers(panel, tmp_path_factory):
    """The SAME panel as StreamedGeno (3 chunks, out-of-core path) and as
    ShardedGeno on the 8-device virtual mesh (distributed path): ssGBLUP
    must reach both."""
    import jax

    from miraculix_tpu import parallel
    from miraculix_tpu.streamed import StreamedGeno

    _, _, _, geno, _, _, _ = panel
    d = tmp_path_factory.mktemp("ssg")
    bedp = str(d / "p.bed")
    bed.write_bed(bedp, geno)
    sgeno = StreamedGeno.from_bed(bedp, chunk_snps=256)
    assert sgeno.n_chunks == 3
    mesh = parallel.make_mesh(8)
    shgeno = parallel.shard_genotypes(geno, mesh)
    return sgeno, shgeno


@pytest.mark.parametrize("kind", ["streamed", "sharded"])
def test_hinv_matvec_containers(panel, containers, kind):
    sire, dam, geno_ids, _, _, _, hinv_d = panel
    g = containers[0] if kind == "streamed" else containers[1]
    hinv = ss.SingleStepHInv(sire, dam, g, geno_ids, blend=BLEND,
                             tau=TAU, omega=OMEGA, inner_tol=1e-7,
                             inner_maxiter=4000)
    assert hinv._kind == kind
    rng = np.random.default_rng(0)
    v = rng.standard_normal((N_ANIM, 3)).astype(np.float32)
    got = np.asarray(hinv.matvec(v), np.float64)
    want = hinv_d @ v
    assert np.abs(got - want).max() / np.abs(want).max() < 5e-4


@pytest.mark.parametrize("kind", ["streamed", "sharded"])
def test_ssgblup_containers_match_dense_mme(panel, containers, kind):
    """Full single-step solve on the streamed / sharded container == the
    dense-f64 H-matrix MME oracle (5e-3, the GenoMatrix tolerance)."""
    sire, dam, geno_ids, _, _, _, hinv_d = panel
    g = containers[0] if kind == "streamed" else containers[1]
    hinv = ss.SingleStepHInv(sire, dam, g, geno_ids, blend=BLEND,
                             tau=TAU, omega=OMEGA, inner_tol=1e-7,
                             inner_maxiter=4000)
    rng = np.random.default_rng(3)
    obs_ids = np.sort(rng.choice(N_ANIM, size=90, replace=False)) + 1
    xmat = np.column_stack([np.ones(90), rng.standard_normal(90)])
    h2 = 0.4
    u_true = rng.standard_normal(N_ANIM)
    y = xmat @ [1.0, 0.5] + u_true[obs_ids - 1] \
        + 0.7 * rng.standard_normal(90)

    res = ss.ssgblup(y, hinv, obs_ids=obs_ids, x=xmat, h2=h2, tol=1e-7,
                     maxiter=5000)
    z = _oracle_mme(hinv_d, y, obs_ids, xmat, h2)
    assert np.abs(res.beta - z[:2]).max() < 5e-3, (res.beta, z[:2])
    denom = np.abs(z[2:]).max()
    assert np.abs(res.u - z[2:]).max() / denom < 5e-3


def test_run_ssgblup_stream_chunk(tmp_path):
    """CLI path with --stream-chunk: the streamed ingest + host outer CG
    must agree with the in-core run on the same files."""
    from miraculix_tpu.ssgblup import run_ssgblup

    rng = np.random.default_rng(23)
    sire, dam = ped.simulate_pedigree(60, n_founders=10, seed=14)
    labels = [f"s{i+1}" for i in range(60)]
    pedf = tmp_path / "ped.txt"
    with open(pedf, "w") as fh:
        for i in range(60):
            fh.write(f"{labels[i]} "
                     f"{labels[sire[i]-1] if sire[i] else '0'} "
                     f"{labels[dam[i]-1] if dam[i] else '0'}\n")
    geno = bed.simulate_genotypes(25, 300, seed=5)
    bedp = str(tmp_path / "g.bed")
    bed.write_bed(bedp, geno)
    fam = open(bedp[:-4] + ".fam").read().splitlines()
    with open(bedp[:-4] + ".fam", "w") as fh:
        for k, ln in enumerate(fam):
            parts = ln.split()
            parts[1] = labels[30 + k]
            fh.write(" ".join(parts) + "\n")
    phenf = tmp_path / "y.txt"
    with open(phenf, "w") as fh:
        for i in range(40):
            fh.write(f"{labels[i]} {rng.standard_normal():.5f}\n")

    out_s = str(tmp_path / "ebv_stream.tsv")
    out_m = str(tmp_path / "ebv_mem.tsv")
    assert run_ssgblup(bedp, str(pedf), pheno_path=str(phenf), out=out_s,
                       h2=0.4, tol=1e-6, stream_chunk=128) == 0
    assert run_ssgblup(bedp, str(pedf), pheno_path=str(phenf), out=out_m,
                       h2=0.4, tol=1e-6) == 0

    def read(p):
        return {ln.split("\t")[0]: float(ln.split("\t")[1])
                for ln in open(p).read().splitlines()[1:]}

    es, em = read(out_s), read(out_m)
    scale = max(abs(v) for v in em.values())
    assert max(abs(es[k] - em[k]) for k in em) / scale < 5e-3


def _ss_profiled_reml_argmax(hinv_pieces, y, obs_ids, grid):
    """Dense REML oracle for the single-step model: restricted profiled
    log-likelihood of V(h2) = h2*W H W' + (1-h2)*I over a grid (intercept
    fixed effect, total variance profiled out)."""
    h_dense, n_anim = hinv_pieces
    n_obs = len(y)
    w = np.zeros((n_obs, n_anim))
    w[np.arange(n_obs), obs_ids - 1] = 1.0
    whw = w @ h_dense @ w.T
    yt = (y - y.mean()) / y.std()
    xo = np.ones((n_obs, 1))

    def logl(h2):
        v = h2 * whw + (1 - h2) * np.eye(n_obs)
        vi = np.linalg.inv(v)
        xtvx = xo.T @ vi @ xo
        beta = np.linalg.solve(xtvx, xo.T @ vi @ yt)
        r = yt - xo @ beta
        ypy = float(r @ vi @ yt)
        st = ypy / (n_obs - 1)
        return -0.5 * ((n_obs - 1) * np.log(st)
                       + np.linalg.slogdet(v)[1]
                       + np.linalg.slogdet(xtvx)[1])

    ll = np.array([logl(h) for h in grid])
    return float(grid[ll.argmax()])


@pytest.fixture(scope="module")
def ss_reml_panel(panel):
    """Phenotypes simulated under the single-step model itself (u drawn
    with cov H) so the REML optimum is interior."""
    sire, dam, geno_ids, geno, gm, hinv, hinv_d = panel
    h_dense = np.linalg.inv(hinv_d)
    rng = np.random.default_rng(17)
    # u ~ N(0, 0.6 H): exact draw from the dense H (test scale only)
    lch = np.linalg.cholesky(h_dense + 1e-8 * np.eye(N_ANIM))
    u = np.sqrt(0.6) * (lch @ rng.standard_normal(N_ANIM))
    obs_ids = np.arange(1, 101)
    y = 1.5 + u[obs_ids - 1] + np.sqrt(0.4) * rng.standard_normal(100)
    h2_exact = _ss_profiled_reml_argmax(
        (h_dense, N_ANIM), y, obs_ids, np.linspace(0.02, 0.98, 481))
    return hinv, h_dense, y, obs_ids, h2_exact


def test_ss_reml_exact_probes(ss_reml_panel):
    """Identity probes: the stochastic trace becomes exact, so the AI-REML
    fixed point must land on the dense profiled-likelihood argmax."""
    hinv, _, y, obs_ids, h2_exact = ss_reml_panel
    h2, det = ss.estimate_h2_reml_ss(y, hinv, obs_ids=obs_ids,
                                     probes=np.eye(N_ANIM), cg_tol=1e-7)
    assert det["exact_traces"] and det["converged"], det
    assert abs(h2 - h2_exact) < 0.015, (h2, h2_exact)
    assert np.isfinite(det["se_h2"]) and det["se_h2"] > 0


def test_ss_reml_stochastic(ss_reml_panel):
    hinv, _, y, obs_ids, h2_exact = ss_reml_panel
    h2, det = ss.estimate_h2_reml_ss(y, hinv, obs_ids=obs_ids, n_probes=16,
                                     seed=5, cg_tol=1e-6)
    assert det["converged"], det
    assert abs(h2 - h2_exact) < 0.10, (h2, h2_exact)
    np.testing.assert_allclose(det["vu"] + det["ve"],
                               y.var() * (det["s2u"] + det["s2e"]),
                               rtol=1e-12)


def test_run_ssgblup_estimate_h2(tmp_path, capsys):
    """CLI path with --estimate-h2: ss-AI-REML feeds the solve."""
    from miraculix_tpu.ssgblup import run_ssgblup

    rng = np.random.default_rng(13)
    sire, dam = ped.simulate_pedigree(70, n_founders=10, seed=8)
    labels = [f"a{i+1}" for i in range(70)]
    pedf = tmp_path / "p.txt"
    with open(pedf, "w") as fh:
        for i in range(70):
            fh.write(f"{labels[i]} "
                     f"{labels[sire[i]-1] if sire[i] else '0'} "
                     f"{labels[dam[i]-1] if dam[i] else '0'}\n")
    geno = bed.simulate_genotypes(30, 200, seed=3)
    bedp = str(tmp_path / "g.bed")
    bed.write_bed(bedp, geno)
    fam = open(bedp[:-4] + ".fam").read().splitlines()
    with open(bedp[:-4] + ".fam", "w") as fh:
        for k, ln in enumerate(fam):
            parts = ln.split()
            parts[1] = labels[40 + k]
            fh.write(" ".join(parts) + "\n")
    phenf = tmp_path / "y.txt"
    with open(phenf, "w") as fh:
        for i in range(40):
            fh.write(f"{labels[i]} {rng.standard_normal():.5f}\n")
    rc = run_ssgblup(bedp, str(pedf), pheno_path=str(phenf),
                     out=str(tmp_path / "e.tsv"), estimate_h2=True,
                     tol=1e-5)
    assert rc == 0
    assert "ss-AI-REML h2 =" in capsys.readouterr().out
