"""Blocked O(nnz) sparse triangular solver.

Oracle = dense numpy solves in float64; shapes/scales mirror the reference's
solver tests (tests/solve/test.jl: simulated diagonally-dominant factors,
resilience loop of 100 repeated solves, sizes into the 1e4-1e6 range)."""
import jax.numpy as jnp
import numpy as np
import pytest

from miraculix_tpu import solve
from miraculix_tpu.solve.sparse import (SparseTriangularSolver,
                                        simulate_pedigree_factor)


@pytest.fixture()
def rng():
    return np.random.default_rng(7)


def _coo_to_dense(r, c, v, n):
    d = np.zeros((n, n))
    np.add.at(d, (np.asarray(r) - 1, np.asarray(c) - 1), v)
    return d


@pytest.mark.parametrize("bs", [1, 7, 64, 256])
@pytest.mark.parametrize("trans", ["n", "t"])
def test_blocked_solve_matches_dense(rng, bs, trans):
    n = 173  # deliberately not a multiple of any block size
    r, c, v = simulate_pedigree_factor(n, avg_offdiag=5, seed=1)
    dense = _coo_to_dense(r, c, v, n)
    slv = SparseTriangularSolver(r, c, v, n, bs=bs)
    b = rng.standard_normal((n, 3))
    x = np.asarray(slv.solve(b, trans=trans))
    a = dense if trans == "n" else dense.T
    assert np.linalg.norm(a @ x - b) / np.linalg.norm(b) < 1e-10


@pytest.mark.parametrize("trans", ["n", "t"])
def test_upper_triangular(rng, trans):
    n = 90
    r, c, v = simulate_pedigree_factor(n, avg_offdiag=4, seed=2)
    dense = _coo_to_dense(r, c, v, n).T  # upper factor
    ru, cu = np.nonzero(dense)
    slv = SparseTriangularSolver(ru + 1, cu + 1, dense[ru, cu], n,
                                 lower=False, bs=32)
    b = rng.standard_normal(n)
    x = np.asarray(slv.solve(b, trans=trans))
    a = dense if trans == "n" else dense.T
    assert np.linalg.norm(a @ x - b) / np.linalg.norm(b) < 1e-10


def test_duplicate_coo_entries_coalesce(rng):
    n = 20
    r = np.array([1, 5, 5, 5] + list(range(1, n + 1)))
    c = np.array([1, 2, 2, 3] + list(range(1, n + 1)))
    v = np.array([0.0, 0.3, 0.4, -0.2] + [2.0] * n)
    dense = _coo_to_dense(r, c, v, n)
    slv = SparseTriangularSolver(r, c, v, n, bs=8)
    b = rng.standard_normal(n)
    x = np.asarray(slv.solve(b))
    np.testing.assert_allclose(dense @ x, b, atol=1e-10)


def test_matvec_matches_dense(rng):
    n = 64
    r, c, v = simulate_pedigree_factor(n, avg_offdiag=3, seed=3)
    dense = _coo_to_dense(r, c, v, n)
    slv = SparseTriangularSolver(r, c, v, n, bs=16)
    x = rng.standard_normal((n, 2))
    np.testing.assert_allclose(np.asarray(slv.matvec(x)), dense @ x,
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(slv.matvec(x, trans="t")),
                               dense.T @ x, atol=1e-10)


def test_refinement_tightens_f32(rng):
    """On an f32 solver (the GPU configuration) one refinement sweep must
    reduce the residual."""
    import jax.numpy as jnp

    n = 2000
    r, c, v = simulate_pedigree_factor(n, avg_offdiag=8, seed=4)
    slv = SparseTriangularSolver(r, c, v, n, bs=128, dtype=jnp.float32)
    b = rng.standard_normal(n).astype(np.float32)
    dense = _coo_to_dense(r, c, v, n)
    x0 = np.asarray(slv.solve(b), np.float64)
    x1 = np.asarray(slv.solve(b, refine=1), np.float64)
    r0 = np.linalg.norm(dense @ x0 - b)
    r1 = np.linalg.norm(dense @ x1 - b)
    assert r1 <= r0
    assert r1 / np.linalg.norm(b) < 1e-5


def test_midsize_pedigree_scale(rng):
    """n = 2e4, nnz ~ 2e5: far beyond the old dense-materialized ceiling in
    test time, still oracle-checkable via the O(nnz) residual."""
    n = 20000
    r, c, v = simulate_pedigree_factor(n, avg_offdiag=9, seed=5)
    slv = SparseTriangularSolver(r, c, v, n)
    assert slv.nnz > 9 * n
    b = rng.standard_normal((n, 4))
    x = slv.solve(b)
    resid = np.asarray(slv.matvec(x)) - b
    assert np.linalg.norm(resid) / np.linalg.norm(b) < 1e-9
    y = slv.solve_lltx(b[:, 0])
    resid2 = np.asarray(slv.matvec(slv.matvec(y, trans="t"))) - b[:, 0]
    assert np.linalg.norm(resid2) / np.linalg.norm(b[:, 0]) < 1e-8


def test_resilience_100_repeats(rng):
    """Reference resilience loop (tests/solve/test.jl:146-174): repeated
    solves on one handle must neither leak nor drift."""
    n = 500
    r, c, v = simulate_pedigree_factor(n, avg_offdiag=6, seed=6)
    slv = SparseTriangularSolver(r, c, v, n, bs=64)
    b = rng.standard_normal(n)
    first = np.asarray(slv.solve_lltx(b))
    for _ in range(99):
        again = np.asarray(slv.solve_lltx(b))
    np.testing.assert_array_equal(first, again)


def test_rejects_zero_diagonal():
    with pytest.raises(ValueError, match="diagonal"):
        SparseTriangularSolver([1, 2], [1, 1], [1.0, 0.5], 2)


def test_free_releases():
    r, c, v = simulate_pedigree_factor(10, seed=0)
    slv = SparseTriangularSolver(r, c, v, 10)
    slv.free()
    assert slv._dinv is None


@pytest.mark.parametrize("bs", [96, 128])   # non-power-of-two exercises pad
def test_device_analysis_matches_host(rng, bs):
    """The device-side f32 analysis (matmul block-doubling inversion of the
    diagonal blocks) must agree with the host f64 analysis to f32 grade,
    and both with the scipy oracle."""
    import scipy.sparse as sp

    n = 3000
    r, c, v = simulate_pedigree_factor(n, avg_offdiag=5, seed=9)
    b = rng.standard_normal((n, 3)).astype(np.float32)
    s_dev = SparseTriangularSolver(r, c, v, n, bs=bs, dtype=jnp.float32)
    s_host = SparseTriangularSolver(r, c, v, n, bs=bs, dtype=jnp.float32,
                                    device_analysis=False)
    x_dev = np.asarray(s_dev.solve_lltx(b, refine=1), np.float64)
    x_host = np.asarray(s_host.solve_lltx(b, refine=1), np.float64)
    ll = sp.coo_matrix((v, (r - 1, c - 1)), shape=(n, n)).tocsr()
    want = sp.linalg.spsolve_triangular(
        sp.csr_matrix(ll.T),
        sp.linalg.spsolve_triangular(ll, b.astype(np.float64), lower=True),
        lower=False)
    scale = np.abs(want).max()
    assert np.abs(x_dev - want).max() / scale < 1e-4
    assert np.abs(x_dev - x_host).max() / scale < 1e-4


def test_solve_f64_refinement_reaches_1e12():
    """Mixed-precision refinement (f32 device substitution + exact host
    f64 residuals) drives the n=1e5 LLᵀ relative residual to <= 1e-10
    where the plain f32 solve floors ~1e-5."""
    import jax.numpy as jnp

    from miraculix_tpu.solve.sparse import (SparseTriangularSolver,
                                            simulate_pedigree_factor)

    n = 100_000
    r, c, v = simulate_pedigree_factor(n, avg_offdiag=9, seed=3)
    # force the f32 device path even on the x64 CPU test backend
    s = SparseTriangularSolver(r, c, v, n, bs=256, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(n)

    x32 = np.asarray(s.solve_lltx(b), np.float64)
    from scipy import sparse as sp

    a = sp.csr_matrix((v, (r - 1, c - 1)), shape=(n, n))
    rel32 = np.linalg.norm(b - a @ (a.T @ x32)) / np.linalg.norm(b)
    assert rel32 > 1e-8  # the f32 floor the refinement must beat

    x, rel = s.solve_lltx_f64(b, tol=1e-12, max_sweeps=10)
    check = np.linalg.norm(b - a @ (a.T @ x)) / np.linalg.norm(b)
    assert check <= 1e-10, check
    assert rel <= 1e-10

    # single-triangle variant + multi-RHS
    bm = rng.standard_normal((n, 3))
    xm, relm = s.solve_f64(bm, trans="n", tol=1e-12)
    checkn = np.linalg.norm(bm - a @ xm) / np.linalg.norm(bm)
    assert checkn <= 1e-10 and xm.shape == (n, 3)


def test_solve_f64_with_permutation():
    from miraculix_tpu.solve.sparse import (SparseTriangularSolver,
                                            simulate_pedigree_factor)
    import jax.numpy as jnp
    from scipy import sparse as sp

    n = 3000
    r, c, v = simulate_pedigree_factor(n, avg_offdiag=5, seed=4)
    s = SparseTriangularSolver(r, c, v, n, bs=128, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    b = rng.standard_normal(n)
    perm = rng.permutation(n) + 1
    x, rel = s.solve_lltx_f64(b, perm=perm, tol=1e-12)
    a = sp.csr_matrix((v, (r - 1, c - 1)), shape=(n, n))
    p = perm - 1
    want = np.zeros(n)
    want[p] = np.linalg.solve((a @ a.T).toarray(), b[p])
    np.testing.assert_allclose(x, want, rtol=1e-8, atol=1e-8)
