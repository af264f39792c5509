"""Solver-layer tests.

Mirrors reference tests/solve/test.jl: simulated diagonally-dominant sparse
triangular + dense PD systems, correctness ||A X - B||/||B|| small, logdet vs
direct computation, repeated-solve resilience; plus the CG GBLUP loop of
examples/iterative_solver/grm_solve_cg.jl and solveRelMat semantics
(Vector.matrix.R.cc:135-251).
"""
import jax.numpy as jnp
import numpy as np
import pytest

import miraculix_tpu as mx
from miraculix_tpu import solve
from miraculix_tpu.io import bed
from miraculix_tpu.ops import ref_impl


def _spd(rng, n):
    a = rng.standard_normal((n, n))
    return a @ a.T + n * np.eye(n)


def test_dense_solve_and_logdet(rng):
    a = _spd(rng, 60)
    b = rng.standard_normal((60, 5))
    res = solve.dense_solve(np.asarray(a), np.asarray(b), calc_logdet=True)
    x = np.asarray(res.x)
    assert np.linalg.norm(a @ x - b) / np.linalg.norm(b) < 1e-8
    want_logdet = np.linalg.slogdet(a)[1]
    assert abs(float(res.logdet) - want_logdet) < 1e-6


def test_dense_solve_vector(rng):
    a = _spd(rng, 20)
    b = rng.standard_normal(20)
    x = np.asarray(solve.dense_solve(a, b).x)
    assert x.shape == (20,)
    assert np.linalg.norm(a @ x - b) < 1e-8


def test_dense_solve_resilience(rng):
    """100 repeated solves (reference leak test, tests/solve/test.jl:146-174)."""
    a = _spd(rng, 30)
    b = rng.standard_normal((30, 2))
    for _ in range(100):
        x = solve.dense_solve(a, b).x
    assert np.linalg.norm(a @ np.asarray(x) - b) < 1e-6


def test_chol2inv(rng):
    a = _spd(rng, 25)
    inv = np.asarray(solve.chol2inv(a))
    np.testing.assert_allclose(a @ inv, np.eye(25), atol=1e-8)


def test_x_cinv_y_logdet(rng):
    c = _spd(rng, 30)
    x = rng.standard_normal((30, 3))
    y = rng.standard_normal((30, 2))
    got, ld = solve.x_cinv_y_logdet(x, c, y)
    np.testing.assert_allclose(np.asarray(got), x.T @ np.linalg.solve(c, y),
                               atol=1e-8)
    assert abs(float(ld) - np.linalg.slogdet(c)[1]) < 1e-6


def test_solve_relmat(rng):
    """(A + tau I) x = v; yhat = A x + beta (reference solveRelMat)."""
    a = _spd(rng, 40)
    v = rng.standard_normal(40)
    tau, beta = 2.5, 0.7
    res = solve.solve_relmat(a, tau, v, beta)
    x = np.asarray(res.x)
    np.testing.assert_allclose((a + tau * np.eye(40)) @ x, v, atol=1e-7)
    np.testing.assert_allclose(np.asarray(res.yhat), a @ x + beta, atol=1e-8)


@pytest.mark.gpu
def test_solve_relmat_on_card_f32_grade(gpu, rng):
    """yhat = A x as the card computes it in f32: within 1e-5 of float64
    (f32 grade reads ~6e-7 on the CPU; TF32 operands read ~5e-4)."""
    a = _spd(rng, 1500) / 1500
    v = rng.standard_normal(1500)
    res = solve.solve_relmat(jnp.asarray(a, jnp.float32), 1.0,
                             jnp.asarray(v, jnp.float32))
    x = np.asarray(res.x, np.float64)
    want = a.astype(np.float32).astype(np.float64) @ x
    assert np.abs(np.asarray(res.yhat, np.float64) - want).max() \
        / np.abs(want).max() < 1e-5


def test_sqrt_posdef(rng):
    a = _spd(rng, 15)
    s = np.asarray(solve.sqrt_posdef(a))
    np.testing.assert_allclose(s @ s, a, atol=1e-7)


# ---------------------------------------------------------------------------
# Sparse triangular (MiXBLUP path)
# ---------------------------------------------------------------------------

def _random_lower_coo(rng, n, density=0.1):
    """Diagonally dominant sparse lower-triangular factor (reference
    tests/solve/test.jl:67-97)."""
    mask = rng.random((n, n)) < density
    mask = np.tril(mask, -1)
    vals = rng.standard_normal((n, n)) * mask
    diag = np.abs(vals).sum(axis=1) + 1.0
    dense = vals + np.diag(diag)
    r, c = np.nonzero(dense)
    return r + 1, c + 1, dense[r, c], dense  # 1-based like the Fortran callers


@pytest.mark.parametrize("trans", ["n", "t"])
def test_sparse_triangular_solve(rng, trans):
    r, c, v, dense = _random_lower_coo(rng, 50)
    slv = solve.SparseTriangularSolver(r, c, v, 50)
    b = rng.standard_normal((50, 3))
    x = np.asarray(slv.solve(b, trans=trans))
    a = dense if trans == "n" else dense.T
    assert np.linalg.norm(a @ x - b) / np.linalg.norm(b) < 1e-10


def test_sparse_llt_solve_with_permutation(rng):
    r, c, v, dense = _random_lower_coo(rng, 40)
    slv = solve.SparseTriangularSolver(r, c, v, 40)
    b = rng.standard_normal(40)
    perm = rng.permutation(40) + 1
    x = np.asarray(slv.solve_lltx(b, perm=perm))
    # c_solve_gpu_perm semantics: solve (L L^T) x_p = b_p on permuted system
    a = dense @ dense.T
    bp = b[perm - 1]
    xp = np.linalg.solve(a, bp)
    want = np.zeros(40)
    want[perm - 1] = xp
    np.testing.assert_allclose(x, want, atol=1e-8)


def test_sparse_rejects_nontriangular():
    with pytest.raises(ValueError, match="triangle"):
        solve.SparseTriangularSolver([1, 1], [1, 2], [1.0, 2.0], 2)


# ---------------------------------------------------------------------------
# CG / GBLUP
# ---------------------------------------------------------------------------

def test_cg_generic(rng):
    a = _spd(rng, 64)
    b = rng.standard_normal((64, 2))
    res = solve.cg(lambda v: a @ v, b, tol=1e-8, maxiter=500)
    assert np.linalg.norm(a @ np.asarray(res.x) - b) < 1e-6


def test_grm_cg_solve_matches_dense(rng):
    """CG on (G + lam I) vs dense solve on the materialized GRM operator.

    G = Z_c Z_cᵀ (centered, unscaled) exactly as the reference CG example
    builds it from two dgemm passes (grm_solve_cg.jl:74-84).
    """
    g = bed.simulate_genotypes(96, 600, seed=12)
    gm = mx.from_dense(g)
    freq = np.asarray(gm.freq, np.float64)
    zc = g.astype(np.float64) - 2.0 * freq[None, :]
    gmat = zc @ zc.T
    lam = 50.0
    b = rng.standard_normal(96)
    res = solve.grm_cg_solve(gm, b, lam=lam, tol=1e-8, maxiter=2000)
    want = np.linalg.solve(gmat + lam * np.eye(96), b)
    assert np.abs(np.asarray(res.x) - want).max() < 1e-4
    assert int(res.iterations) < 2000


def test_grm_matvec_matches_dense(rng):
    g = bed.simulate_genotypes(50, 300, seed=13)
    gm = mx.from_dense(g)
    freq = np.asarray(gm.freq, np.float64)
    zc = g.astype(np.float64) - 2.0 * freq[None, :]
    v = rng.standard_normal((50, 2))
    got = np.asarray(solve.grm_matvec(gm, v))
    want = zc @ (zc.T @ v)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4


def test_solve_posdef_fallbacks(rng):
    """SolvePosDef-style degradation (reference solve_rfu.cc:102-2223):
    Cholesky on SPD, eigh pseudo-solve on singular, LU on general."""
    from miraculix_tpu.solve.dense import solve_posdef
    import jax.numpy as jnp

    n = 40
    m = rng.standard_normal((n, n))
    a = m @ m.T + n * np.eye(n)
    b = rng.standard_normal(n)
    x = np.asarray(solve_posdef(jnp.asarray(a), jnp.asarray(b)).x)
    np.testing.assert_allclose(a @ x, b, atol=1e-8)

    # singular PSD: rank n-5
    u = rng.standard_normal((n, n - 5))
    a_sing = u @ u.T
    res = solve_posdef(jnp.asarray(a_sing), jnp.asarray(b), method="auto",
                       eigen_floor=1e-8)
    x = np.asarray(res.x)
    # pseudo-solve: A x should reproduce the projection of b onto range(A)
    w, q = np.linalg.eigh(a_sing)
    proj = q[:, w > 1e-8] @ (q[:, w > 1e-8].T @ b)
    np.testing.assert_allclose(a_sing @ x, proj, atol=1e-6)

    # LU path on a general (non-symmetric) matrix
    g = rng.standard_normal((n, n)) + n * np.eye(n)
    res = solve_posdef(jnp.asarray(g), jnp.asarray(b), method="lu",
                       calc_logdet=True)
    np.testing.assert_allclose(g @ np.asarray(res.x), b, atol=1e-8)
    assert np.isfinite(float(res.logdet))


def test_sqrt_rhs(rng):
    from miraculix_tpu.solve.dense import sqrt_posdef, sqrt_rhs
    import jax.numpy as jnp

    m = rng.standard_normal((20, 20))
    a = jnp.asarray(m @ m.T + 20 * np.eye(20))
    b = jnp.asarray(rng.standard_normal((20, 3)))
    np.testing.assert_allclose(np.asarray(sqrt_rhs(a, b)),
                               np.asarray(sqrt_posdef(a) @ b), atol=1e-6)


def test_grm_matvec_f64_true_double(rng):
    """Host-f64 G·v matches the dense float64 oracle to ~1e-12 relative —
    far past f32 (the fast path sits at ~1e-6)."""
    g = bed.simulate_genotypes(64, 400, seed=21)
    gm = mx.from_dense(g)
    freq = np.asarray(gm.freq, np.float64)
    zc = g.astype(np.float64) - 2.0 * freq[None, :]
    v = rng.standard_normal((64, 3))
    got = solve.grm_matvec_f64(gm, v)
    want = zc @ (zc.T @ v)
    assert got.dtype == np.float64
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 1e-11, rel


def test_grm_cg_solve_refined_f64_grade(rng):
    """Iterative refinement reaches float64-class accuracy (~1e-10) that
    the plain f32 CG cannot: the inner solves run on device, the outer
    residuals in true f64."""
    g = bed.simulate_genotypes(80, 500, seed=22)
    gm = mx.from_dense(g)
    freq = np.asarray(gm.freq, np.float64)
    zc = g.astype(np.float64) - 2.0 * freq[None, :]
    lam = 25.0
    b = rng.standard_normal((80, 2))
    x, outer, inner, rel = solve.grm_cg_solve_refined(
        gm, b, lam=lam, tol=1e-10, outer=6)
    want = np.linalg.solve(zc @ zc.T + lam * np.eye(80), b)
    err = np.abs(x - want).max() / np.abs(want).max()
    assert err < 1e-9, (err, outer, inner, rel)
    assert rel.max() < 1e-10
    assert outer >= 2  # plain f32 CG alone cannot reach this tolerance


def test_grm_diag_exact(rng):
    """grm_diag matches the dense oracle's diagonal, including missing
    genotypes (packed as 0, centered like the matvec's)."""
    g = bed.simulate_genotypes(70, 450, seed=24, missing_rate=0.05)
    gm = mx.from_dense(g)
    f = np.asarray(gm.freq, np.float64)
    gz = np.where(g == 3, 0, g).astype(np.float64)
    zc = gz - 2.0 * f[None, :]
    for center in (True, False):
        want = np.sum((zc if center else gz) ** 2, axis=1)
        got = np.asarray(solve.grm_diag(gm, center=center))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_grm_cg_preconditioned(rng):
    """Jacobi PCG on the GRM: identical solution, no iteration penalty
    (VanRaden GRM conditioning is low-rank-driven, so Jacobi is ~neutral
    there — the win case is heterogeneous-diagonal operators, below)."""
    r2 = np.random.default_rng(42)
    g = bed.simulate_genotypes(96, 600, seed=25)
    gm = mx.from_dense(g)
    b = jnp.asarray(r2.standard_normal((96, 2)), jnp.float32)
    lam = 5.0
    plain = solve.grm_cg_solve(gm, b, lam=lam, tol=1e-5, maxiter=3000)
    pcg = solve.grm_cg_solve(gm, b, lam=lam, tol=1e-5, maxiter=3000,
                             precondition=True)
    f = np.asarray(gm.freq, np.float64)
    zc = g.astype(np.float64) - 2.0 * f[None, :]
    want = np.linalg.solve(zc @ zc.T + lam * np.eye(96), np.asarray(b))
    scale = np.abs(want).max()
    assert np.abs(np.asarray(plain.x) - want).max() / scale < 1e-4
    assert np.abs(np.asarray(pcg.x) - want).max() / scale < 1e-4
    assert int(pcg.iterations) <= int(plain.iterations) + 2


def test_cg_jacobi_wins_on_heterogeneous_diagonal(rng):
    """The preconditioner's target case: A = D + small off-diagonal with D
    spread over 4 orders of magnitude — Jacobi PCG converges in a handful
    of iterations where plain CG needs dozens."""
    n = 256
    r2 = np.random.default_rng(7)
    d = 10.0 ** r2.uniform(-2, 2, n)
    c = r2.standard_normal((n, n)) * 0.02
    a = np.diag(d) + c @ c.T
    b = r2.standard_normal(n)
    amat = jnp.asarray(a, jnp.float32)

    def op(v):
        return amat @ v

    bj = jnp.asarray(b, jnp.float32)
    plain = solve.cg(op, bj, tol=1e-5, maxiter=2000)
    pcg = solve.cg(op, bj, tol=1e-5, maxiter=2000,
                   minv=jnp.asarray(1.0 / np.diag(a), jnp.float32))
    want = np.linalg.solve(a, b)
    scale = np.abs(want).max()
    assert np.abs(np.asarray(plain.x) - want).max() / scale < 1e-3
    assert np.abs(np.asarray(pcg.x) - want).max() / scale < 1e-3
    assert int(pcg.iterations) < int(plain.iterations) // 2, (
        int(pcg.iterations), int(plain.iterations))
