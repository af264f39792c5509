"""Dense positive-definite solvers: Cholesky solve, log-determinant,
relationship-matrix solve, inverse helpers.

Equivalents of the reference's cuSOLVER path
(``potrs_solve_gpu``: Xpotrf/Xpotrs + trace_kernel logdet,
src/cuda/solve_cuda.cu:70-279,884-909) and of the vendored
RandomFieldsUtils dense suite (``SolvePosDef``/``doPosDefIntern``,
``chol2inv``, ``xCinvYdet``, src/miraculix/solve_rfu.cc:102-2223).
XLA's Cholesky (cuSOLVER on the GPU); float64 is supported when
jax_enable_x64 is on, matching the reference's double semantics.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

# f32 products at f32 grade: a GPU would take them in TF32 (~1e-3) at the
# default precision
_HIGHEST = jax.lax.Precision.HIGHEST


class DenseSolveResult(NamedTuple):
    x: jax.Array
    logdet: Optional[jax.Array] = None


def dense_solve(
    a: jax.Array,
    b: jax.Array,
    calc_logdet: bool = False,
    jitter: float = 0.0,
) -> DenseSolveResult:
    """Solve A X = B for symmetric positive-definite A via Cholesky.

    Mirrors ``potrs_solve_gpu(A, n, B, ncols, X, logdet, ...)``
    (src/cuda/solve_cuda.h:75-88): lower-triangular factorization, optional
    log-determinant = 2*sum(log diag L) (the trace_kernel,
    solve_cuda.cu:884-909).  ``jitter`` adds eps*I before factoring (the
    RFU pivot/regularization escape hatch, solve_rfu.cc).
    """
    if jitter:
        a = a + jitter * jnp.eye(a.shape[0], dtype=a.dtype)
    chol = jnp.linalg.cholesky(a)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    x = jsl.cho_solve((chol, True), b.astype(chol.dtype))
    if squeeze:
        x = x[:, 0]
    logdet = None
    if calc_logdet:
        logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol)))
    return DenseSolveResult(x, logdet)


def chol2inv(a: jax.Array) -> jax.Array:
    """Inverse of an SPD matrix from its Cholesky factorization
    (reference RFU ``chol2inv``, solve_rfu.cc)."""
    chol = jnp.linalg.cholesky(a)
    eye = jnp.eye(a.shape[0], dtype=a.dtype)
    return jsl.cho_solve((chol, True), eye)


def x_cinv_y_logdet(
    x: jax.Array, c: jax.Array, y: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Compute Xᵀ C⁻¹ Y and log det C in one factorization (reference RFU
    ``xCinvYdet``, solve_rfu.cc)."""
    chol = jnp.linalg.cholesky(c)
    ciy = jsl.cho_solve((chol, True), y)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol)))
    return jnp.matmul(x.T, ciy, precision=_HIGHEST), logdet


class RelMatResult(NamedTuple):
    x: jax.Array
    yhat: Optional[jax.Array] = None


def solve_relmat(
    a: jax.Array,
    tau: jax.Array | float,
    v: jax.Array,
    beta: Optional[jax.Array | float] = None,
    compute_yhat: bool = True,
) -> RelMatResult:
    """GBLUP helper: solve (A + tau·I) x = v and return yhat = A·x + beta.

    Semantics of the reference's ``IsolveRelMat``/``solveRelMat``
    (src/miraculix/Vector.matrix.R.cc:135-251).
    """
    n = a.shape[0]
    am = a + jnp.asarray(tau, a.dtype) * jnp.eye(n, dtype=a.dtype)
    x = dense_solve(am, v).x
    yhat = None
    if compute_yhat:
        yhat = jnp.matmul(a, x, precision=_HIGHEST)
        if beta is not None:
            yhat = yhat + jnp.asarray(beta, yhat.dtype)
    return RelMatResult(x, yhat)


def sqrt_posdef(a: jax.Array) -> jax.Array:
    """Symmetric square root of an SPD matrix via eigendecomposition
    (reference RFU ``SqrtPosDefFree``, solve_rfu.cc)."""
    w, q = jnp.linalg.eigh(a)
    w = jnp.maximum(w, 0.0)
    return jnp.matmul(q * jnp.sqrt(w)[None, :], q.T, precision=_HIGHEST)


def sqrt_rhs(a: jax.Array, b: jax.Array) -> jax.Array:
    """A^(1/2) @ B without materializing the square root twice
    (reference RFU ``sqrtRHS``, solve_rfu.cc)."""
    w, q = jnp.linalg.eigh(a)
    w = jnp.maximum(w, 0.0)
    return jnp.matmul(q, jnp.sqrt(w)[:, None]
                      * jnp.matmul(q.T, b, precision=_HIGHEST),
                      precision=_HIGHEST)


def solve_posdef(
    a: jax.Array,
    b: jax.Array,
    method: str = "auto",
    calc_logdet: bool = False,
    jitter: float = 0.0,
    eigen_floor: float = 0.0,
) -> DenseSolveResult:
    """General positive-(semi)definite solve with graceful degradation —
    the role of the reference RFU's ``SolvePosDef``/``doPosDefIntern``
    (solve_rfu.cc:102-2223): Cholesky first, then pivoted/regularized
    escapes for near-singular systems.

    methods:
      - "cholesky": straight Cholesky (fails with NaNs if not SPD)
      - "eigh": eigendecomposition pseudo-solve, eigenvalues clamped at
        ``eigen_floor`` (the pivoted-Cholesky/rank-deficient path)
      - "lu": plain LU (the reference's non-PD fallback)
      - "auto" (not jittable): try Cholesky, fall back to eigh when the
        factorization produces non-finite values
    """
    if jitter:
        a = a + jitter * jnp.eye(a.shape[0], dtype=a.dtype)
    squeeze = b.ndim == 1
    bb = b[:, None] if squeeze else b

    def _eigh():
        w, q = jnp.linalg.eigh(a)
        w_inv = jnp.where(w > eigen_floor, 1.0 / jnp.maximum(w, 1e-300), 0.0)
        x = jnp.matmul(q, w_inv[:, None] * jnp.matmul(
            q.T, bb.astype(a.dtype), precision=_HIGHEST), precision=_HIGHEST)
        ld = jnp.sum(jnp.where(w > eigen_floor, jnp.log(jnp.maximum(w, 1e-300)),
                               0.0)) if calc_logdet else None
        return x, ld

    if method == "eigh":
        x, ld = _eigh()
    elif method == "lu":
        x = jnp.linalg.solve(a, bb.astype(a.dtype))
        ld = (jnp.linalg.slogdet(a)[1] if calc_logdet else None)
    elif method == "cholesky":
        res = dense_solve(a, bb, calc_logdet=calc_logdet)
        x, ld = res.x, res.logdet
    elif method == "auto":
        res = dense_solve(a, bb, calc_logdet=calc_logdet)
        x, ld = res.x, res.logdet
        if not bool(jnp.isfinite(x).all()):  # host check: not jittable
            x, ld = _eigh()
    else:
        raise ValueError(f"unknown method {method!r}")
    return DenseSolveResult(x[:, 0] if squeeze else x, ld)
