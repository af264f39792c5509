"""Conjugate-gradient solvers, fully on-device.

The reference's GBLUP iterative path (examples/iterative_solver/
grm_solve_cg.jl:109-134) runs CG in host Julia, crossing host<->device twice
per iteration — an overhead its own authors flag ("A further boost ... if
the whole PCG is transferred to the GPU", src/cuda/dgemm_compressed_cuda.cu:
251-253).  Here the entire loop is a jitted ``lax.while_loop``: the operator
G·v = Z_c (Z_cᵀ v) is two packed Pallas matmuls, the dot products are XLA
reductions (and become psum collectives under shard_map in
miraculix_tpu.parallel), and nothing leaves the device until convergence.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..geno import GenoMatrix
from ..ops.dgemm import dgemm


class CGResult(NamedTuple):
    x: jax.Array          # solution [n, k]
    iterations: jax.Array  # scalar int32
    residual_norm: jax.Array  # [k] final residual 2-norms


def cg(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    tol: float = 1e-2,
    maxiter: int = 1000,
    minv: Optional[jax.Array] = None,
) -> CGResult:
    """Block conjugate gradient for SPD operators; each RHS column iterates
    with its own alpha/beta (mathematically identical to k independent CG
    runs, reference grm_solve_cg.jl:109-134, but batched in one product).

    ``b`` may be [n] or [n, k]. Stops when every column's residual norm is
    below ``tol`` or after ``maxiter`` iterations.

    ``minv`` [n] enables Jacobi-preconditioned CG: z = minv * r replaces r
    in the direction updates (one elementwise multiply per iteration;
    convergence is still judged on the TRUE residual norm).  Pass e.g.
    ``1 / (grm_diag(g) + lam)`` — heterogeneous-diagonal systems converge
    in substantially fewer matvecs; the reference has no preconditioner.
    """
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    x = jnp.zeros_like(b) if x0 is None else (x0[:, None] if squeeze else x0)

    def precond(r):
        return r if minv is None else minv[:, None] * r

    r = b - matvec(x)
    z = precond(r)
    p = z
    rs = jnp.sum(r * r, axis=0)   # true residual (stopping test)
    rz = jnp.sum(r * z, axis=0)   # preconditioned inner product

    def cond(state):
        _, _, _, rs, _, it = state
        return jnp.logical_and(it < maxiter,
                               jnp.any(jnp.sqrt(rs) > tol))

    def body(state):
        x, r, p, rs, rz, it = state
        ap = matvec(p)
        denom = jnp.sum(p * ap, axis=0)
        alpha = jnp.where(denom > 0, rz / denom, 0.0)
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * ap
        z = precond(r)
        rs_new = jnp.sum(r * r, axis=0)
        rz_new = jnp.sum(r * z, axis=0)
        beta = jnp.where(rz > 0, rz_new / rz, 0.0)
        p = z + beta[None, :] * p
        return x, r, p, rs_new, rz_new, it + 1

    x, r, p, rs, rz, it = jax.lax.while_loop(
        cond, body, (x, r, p, rs, rz, jnp.int32(0))
    )
    x_out = x[:, 0] if squeeze else x
    return CGResult(x_out, it, jnp.sqrt(rs))


@functools.partial(jax.jit, static_argnames=("center", "scale"))
def grm_diag(g: GenoMatrix, center: bool = True,
             scale: bool = False) -> jax.Array:
    """diag(Z_c Z_cᵀ) EXACTLY, without materializing G — one bandwidth
    pass over the packed rows plus one skinny dgemm:

        diag[i] = Σ_s (z_is - 2 f_s)²
                = Σ_s z²  - 4 Σ_s f_s z_is + 4 Σ_s f_s²

    with Σ z² = Σ z + 2·#{z = 2} (z ∈ {0,1,2} — both terms integer-exact
    from the planar16 words) and Σ f z the freqSxI cache pass.  Feeds the
    Jacobi preconditioner of :func:`cg` / :func:`grm_cg_solve`; missing
    genotypes are packed as 0 and contribute their centered term exactly
    like the matvec's, so M matches the operator."""
    from ..ops.common import packed_row_sq_stats

    zsq = packed_row_sq_stats(g.zq_n)[: g.indiv]  # Σ z², exact
    if center:
        f = g.freq.astype(jnp.float32)
        fz = dgemm(g, f[:, None], trans="n", center=False)[:, 0]
        d = zsq - 4.0 * fz + 4.0 * jnp.sum(f * f)
    else:
        d = zsq
    if scale:
        d = d / g.sigma2.astype(d.dtype)
    return d


def jacobi_minv(d: jax.Array) -> jax.Array:
    """Elementwise inverse of a (strictly positive) operator diagonal, with
    non-positive entries — padding or degenerate rows — mapped to 1 so the
    preconditioner is a no-op there."""
    return jnp.where(d > 0, 1.0 / d, 1.0)


def grm_matvec(
    g: GenoMatrix,
    v: jax.Array,
    center: bool = True,
    scale: bool = False,
    precision: str = "fast",
) -> jax.Array:
    """G·v with G the (optionally VanRaden-scaled) relationship matrix,
    WITHOUT materializing G: two dgemm passes over the packed genotypes
    (the reference's GRM_vec, grm_solve_cg.jl:74-84)."""
    zv = dgemm(g, v, trans="t", center=center, precision=precision)
    gv = dgemm(g, zv, trans="n", center=center, precision=precision)
    if scale:
        gv = gv / g.sigma2.astype(gv.dtype)
    return gv


@functools.partial(
    jax.jit,
    static_argnames=("center", "scale", "tol", "maxiter", "precision",
                     "precondition"),
)
def grm_cg_solve(
    g: GenoMatrix,
    b: jax.Array,
    lam=0.0,
    center: bool = True,
    scale: bool = False,
    tol: float = 1e-2,
    maxiter: int = 1000,
    precision: str = "fast",
    precondition: bool = False,
) -> CGResult:
    """Solve (G + lam·I) x = b on-device, G = Z_c Z_cᵀ (optionally /sigma^2).

    The GBLUP work-horse: with lam = sigma_e^2/sigma_u^2 this is the mixed-
    model equation solve of examples/gblup/calculate_gblup.jl:163-185.

    ``lam`` is a TRACED argument: callers that sweep the ridge (REML
    variance-component iterations, regularization paths) reuse one compiled
    executable instead of recompiling the Pallas CG per value.

    ``precondition=True`` runs Jacobi-preconditioned CG with the exact GRM
    diagonal (:func:`grm_diag`) — one extra bandwidth pass at setup and one
    elementwise multiply per iteration; heterogeneous-relatedness panels
    converge in substantially fewer matvecs (the reference's CG has no
    preconditioner, grm_solve_cg.jl:109-134).
    """
    lam = jnp.asarray(lam, jnp.float32)

    def op(v):
        gv = grm_matvec(g, v, center=center, scale=scale, precision=precision)
        return gv + lam * v

    minv = jacobi_minv(grm_diag(g, center=center, scale=scale) + lam) \
        if precondition else None
    return cg(op, b, tol=tol, maxiter=maxiter, minv=minv)


def grm_matvec_f64(g: GenoMatrix, v, center: bool = True,
                   scale: bool = False):
    """G·v in TRUE float64: the packed products run on device through the
    EXACT integer-digit kernel (``packed_matmul_f64`` -> packed_matmul_exact,
    int8 passes with int32 accumulation) and the centering epilogue is
    applied in numpy f64.  Result accurate to ~1e-15 relative — the
    counterpart of the reference's double-precision gV path
    (Vector.matrix.D.cc:42-229).  Host-orchestrated: not jittable; returns
    numpy float64."""
    import numpy as np

    from ..ops.dgemm import packed_matmul_f64

    v = np.asarray(v, np.float64)
    squeeze = v.ndim == 1
    if squeeze:
        v = v[:, None]
    f = 2.0 * np.asarray(g.freq, np.float64)

    zv = packed_matmul_f64(g.zq_t, v, as_numpy=True)[: g.snps]
    if center:
        zv -= f[:, None] * v.sum(axis=0)[None, :]      # (Z-M)ᵀ v
    gv = packed_matmul_f64(g.zq_n, zv, as_numpy=True)[: g.indiv]
    if center:
        gv -= (f @ zv)[None, :]                        # (Z-M) (·)
    if scale:
        gv /= float(g.sigma2)
    return gv[:, 0] if squeeze else gv


def grm_cg_solve_refined(
    g: GenoMatrix,
    b,
    lam: float = 0.0,
    center: bool = True,
    scale: bool = False,
    tol: float = 1e-10,
    outer: int = 5,
    inner_tol_factor: float = 1e-4,
    inner_maxiter: int = 2000,
    precision: str = "fast",
):
    """Float64-GRADE solve of (G + lam I) x = b by iterative refinement:
    the inner CG runs entirely on device in fast-f32 (bf16-split), the
    outer loop computes true-f64 residuals via ``grm_matvec_f64`` and
    re-solves for the correction.  Each outer pass multiplies the error by
    the inner solver's relative accuracy (~1e-5), so 2-3 passes reach
    ~1e-12 — the accuracy class of the reference's double-precision
    solvers (solve_cuda.cu potrs path), delivered at device speed.

    Returns ``(x, outer_iters, inner_iters_total, rel_residual)`` with
    ``x`` numpy float64.  Host-orchestrated (not jittable).
    """
    import numpy as np

    b = np.asarray(b, np.float64)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    n, k = b.shape
    if n != g.indiv:
        raise ValueError(f"b has {n} rows, expected indiv={g.indiv}")

    def residual(x):
        ax = grm_matvec_f64(g, x, center=center, scale=scale)
        if lam:
            ax = ax + lam * x
        return b - ax

    bnorm = np.maximum(np.linalg.norm(b, axis=0), 1e-300)
    x = np.zeros_like(b)
    r = b.copy()
    inner_total = 0
    it = 0
    rel = np.linalg.norm(r, axis=0) / bnorm
    while it < outer and rel.max() > tol:
        # solve the NORMALIZED correction system A dx = r / rnorm with a
        # CONSTANT inner tolerance, then scale dx back: the inner solver's
        # `tol` is a jit-static argument, so a residual-dependent value
        # would retrace + recompile the whole Pallas CG every outer pass;
        # normalization keeps one compiled executable across passes AND
        # iterations
        rnorm = float(np.linalg.norm(r, axis=0).max())
        if rnorm == 0.0:
            break
        res = grm_cg_solve(
            g, jnp.asarray(r / rnorm, jnp.float32), lam=lam, center=center,
            scale=scale, tol=float(inner_tol_factor),
            maxiter=inner_maxiter, precision=precision)
        x = x + rnorm * np.asarray(res.x, np.float64)
        inner_total += int(res.iterations)
        r = residual(x)
        rel = np.linalg.norm(r, axis=0) / bnorm
        it += 1
    return (x[:, 0] if squeeze else x), it, inner_total, rel
