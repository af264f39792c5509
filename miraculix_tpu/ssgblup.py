"""Single-step GBLUP (ssGBLUP): the H-matrix mixed-model equations that
combine pedigree and genomic information, solved matrix-free on device.

This is the evaluation MiXBLUP actually runs with the reference's two
engines — the sparse pedigree solves (src/cuda/solve_cuda.cu:281-882 via
modmiraculix_gpu.f90:80-157) and the packed-genotype GEMM
(src/bindings/Fortran/mod5codesapi.f90) — composed here into one
framework-native application.  Following Aguilar et al. (2010) /
Christensen & Lund (2010):

    H^-1 = A^-1 + [ 0   0                              ]
                  [ 0   tau * Gw^-1  -  omega * A22^-1 ]

with A^-1 the sparse pedigree inverse (Henderson's rules,
:mod:`miraculix_tpu.pedigree`), Gw = (1-blend) * G_VanRaden + blend * I
the blended genomic relationship of the genotyped subset, and A22 the
pedigree relationship among genotyped animals.  Nothing is densified:

- A^-1 v      : one COO segment-sum SpMV;
- Gw^-1 v2    : Jacobi-preconditioned CG whose matvec is two packed
                Pallas passes over the SNP panel (G never formed);
- A22^-1 v2   : the sparse-block identity A22^-1 = A22blk - A21blk *
                (A11blk)^-1 * A12blk on the BLOCKS OF A^-1 (all sparse),
                with the inner (A11)^-1 again a Jacobi CG;
- the MME     : one outer block CG over [beta; u].

The entire solve compiles to a single XLA program (nested
``lax.while_loop`` CGs inside the outer CG's matvec).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .geno import GenoMatrix
from .pedigree import SparseCOO, a_inverse, check_pedigree
from .solve.cg import cg, grm_diag, grm_matvec

# f32 device products at f32 grade (a GPU's default would be TF32)
_HIGHEST = jax.lax.Precision.HIGHEST


def _host_pcg(op, b, tol, maxiter, minv=None):
    """Host-driven Jacobi-PCG on an SPD numpy operator — the outer loop for
    out-of-core panels, where the operator itself streams chunks through
    the device and cannot live inside a single XLA program (the reference's
    GBLUP CG is the same shape: a host loop over dgemm_compressed calls,
    examples/iterative_solver/grm_solve_cg.jl:109-134).  ``tol`` is
    ABSOLUTE on the residual 2-norm, matching :func:`solve.cg.cg` so the
    streamed and compiled paths are interchangeable behind a normalized
    RHS.  Returns ``(x, iterations, residual_norms)``."""
    b = np.asarray(b, np.float64)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    x = np.zeros_like(b)
    r = b.copy()                      # x = 0 exactly: skip op(0)
    z = r if minv is None else minv[:, None] * r
    p = z.copy()
    rs = (r * r).sum(axis=0)
    rz = (r * z).sum(axis=0)
    it = 0
    while it < maxiter and (np.sqrt(rs) > tol).any():
        ap = op(p)
        denom = (p * ap).sum(axis=0)
        alpha = np.where(denom > 0, rz / np.maximum(denom, 1e-300), 0.0)
        x += alpha * p
        r -= alpha * ap
        z = r if minv is None else minv[:, None] * r
        rs = (r * r).sum(axis=0)
        rz_new = (r * z).sum(axis=0)
        p = z + np.where(rz > 0, rz_new / np.maximum(rz, 1e-300), 0.0) * p
        rz = rz_new
        it += 1
    return (x[:, 0] if squeeze else x), it, np.sqrt(rs)


def _normalized_cg(matvec, b, tol, maxiter, minv=None):
    """CG with a per-column normalized RHS so the ABSOLUTE tolerance of
    :func:`solve.cg.cg` behaves relatively — the inner solves of a nested
    operator must not change character with the outer iterate's scale."""
    norm = jnp.linalg.norm(b, axis=0, keepdims=True)
    safe = jnp.where(norm > 0, norm, 1.0)
    r = cg(matvec, b / safe, tol=tol, maxiter=maxiter, minv=minv)
    return r.x * safe


@functools.partial(jax.jit, static_argnames=("tol", "maxiter"))
def _a22_inv_impl(a11, a12, a22, a11_minv, v2, *, tol, maxiter):
    t = a12.matvec(v2)                            # A12blk v2   [n1, k]
    w = _normalized_cg(a11.matvec, t, tol, maxiter, minv=a11_minv)
    return a22.matvec(v2) - a12.matvec(w, trans="t")


def _split_coo(rows, cols, vals, group, pos):
    """Split symmetric COO by the (group[row], group[col]) block."""
    gr, gc = group[rows], group[cols]
    out = {}
    for name, mr, mc in (("11", 0, 0), ("12", 0, 1), ("22", 1, 1)):
        m = (gr == mr) & (gc == mc)
        out[name] = (pos[rows[m]], pos[cols[m]], vals[m])
    return out


@jax.tree_util.register_pytree_node_class
class SingleStepHInv:
    """Matrix-free H^-1 over all pedigree animals.

    ``geno_ids``: 1-based pedigree ids of the SNP panel's rows (so
    ``geno_ids[i]`` is the animal whose genotypes are row i of ``g``).
    ``blend`` is the identity fraction mixed into G (VanRaden 2008's
    0.95*G + 0.05*I default guards a singular G); ``tau``/``omega`` are
    the Aguilar scaling knobs (1, 1 = standard ssGBLUP).

    Registered as a pytree (arrays = leaves, config = static aux) so the
    MME jits take it as an argument — closure capture embedded the sparse
    blocks and the packed panel as HLO constants, whose size grows with
    the panel (hundreds of MB at 200K animals).
    """

    _LEAVES = ("g", "ainv", "a11", "a12", "a22", "geno_rows",
               "_gw_diag", "_gw_minv", "_a11_minv")
    _AUX = ("n", "n1", "n2", "tau", "omega", "blend",
            "inner_tol", "inner_maxiter", "_sigma2", "_kind", "_mesh")

    def tree_flatten(self):
        return (tuple(getattr(self, k) for k in self._LEAVES),
                tuple(getattr(self, k) for k in self._AUX))

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        obj = object.__new__(cls)
        for k, v in zip(cls._LEAVES, leaves):
            setattr(obj, k, v)
        for k, v in zip(cls._AUX, aux):
            setattr(obj, k, v)
        return obj

    def __init__(self, sire, dam, g, geno_ids, *,
                 blend: float = 0.05, tau: float = 1.0, omega: float = 1.0,
                 inner_tol: float = 1e-6, inner_maxiter: int = 1000,
                 f: Optional[np.ndarray] = None):
        # container dispatch: the SAME operator runs on a single-chip
        # GenoMatrix (fully compiled nested CGs), an out-of-core
        # StreamedGeno (host-driven inner/outer CGs streaming SNP chunks
        # through the device), or a multi-chip ShardedGeno (shard_map
        # matvecs with one psum each): real single-step evaluations (500K+
        # genotyped x 1M SNPs) exceed one card's memory.
        from .streamed import StreamedGeno

        self._kind, self._mesh = "geno", None
        if isinstance(g, StreamedGeno):
            self._kind = "streamed"
        else:
            from .parallel.sharded import ShardedGeno, _mesh_of

            if isinstance(g, ShardedGeno):
                self._kind = "sharded"
                self._mesh = _mesh_of(g)
        n = check_pedigree(sire, dam)
        geno_ids = np.asarray(geno_ids, np.int64)
        if geno_ids.min() < 1 or geno_ids.max() > n:
            raise ValueError("geno_ids must be 1-based pedigree ids")
        if len(np.unique(geno_ids)) != len(geno_ids):
            raise ValueError("geno_ids must be unique")
        if g.indiv != len(geno_ids):
            raise ValueError(f"panel has {g.indiv} rows, geno_ids has "
                             f"{len(geno_ids)}")
        self.n, self.g = n, g
        self.tau, self.omega, self.blend = tau, omega, blend
        self.inner_tol, self.inner_maxiter = inner_tol, inner_maxiter

        rows, cols, vals = a_inverse(sire, dam, f=f)
        self.ainv = SparseCOO(rows, cols, vals, (n, n))

        # group: 0 = non-genotyped, 1 = genotyped; pos = index within group
        group = np.zeros(n, np.int64)
        group[geno_ids - 1] = 1
        pos = np.zeros(n, np.int64)
        pos[group == 0] = np.arange(n - len(geno_ids))
        # genotyped animals are positioned by PANEL ROW, so block vectors
        # align with the GenoMatrix without any further permutation
        pos[geno_ids - 1] = np.arange(len(geno_ids))
        n2 = len(geno_ids)
        n1 = n - n2
        self.n1, self.n2 = n1, n2
        blocks = _split_coo(rows, cols, vals, group, pos)
        self.a11 = SparseCOO(*blocks["11"], (n1, n1))
        self.a12 = SparseCOO(*blocks["12"], (n1, n2))
        self.a22 = SparseCOO(*blocks["22"], (n2, n2))
        self.geno_rows = jnp.asarray(geno_ids - 1, jnp.int32)

        sigma2 = float(g.sigma2)
        if self._kind == "streamed":
            gd = jnp.asarray(g.grm_diag(center=True), jnp.float32)
        elif self._kind == "sharded":
            from .parallel.sharded import sharded_grm_diag

            gd = sharded_grm_diag(g, center=True, mesh=self._mesh)
        else:
            gd = grm_diag(g, center=True)
        self._gw_diag = (1.0 - blend) * gd / sigma2 + blend
        self._gw_minv = 1.0 / self._gw_diag
        a11d = self.a11.diag()
        self._a11_minv = jnp.where(a11d > 0, 1.0 / a11d, 1.0)
        self._sigma2 = sigma2

    # -- block operators (v2: [n2, k]) ------------------------------------
    def _gw(self, v2):
        if self._kind == "sharded":
            from .parallel.sharded import sharded_grm_matvec

            gv = sharded_grm_matvec(self.g, v2, center=True,
                                    mesh=self._mesh) / self._sigma2
        else:
            gv = grm_matvec(self.g, v2, center=True,
                            scale=False) / self._sigma2
        return (1.0 - self.blend) * gv + self.blend * v2

    def gw_inv(self, v2):
        """Gw^-1 v2 by Jacobi-preconditioned CG on the packed panel.

        Streamed panels solve on the HOST CG (each matvec is one pass over
        the chunks): Gw x = b rewrites to (G/sigma2 + blend/(1-blend) I)
        x = b/(1-blend), exactly StreamedGeno.cg_solve's operator."""
        if self._kind == "streamed":
            b = np.asarray(v2, np.float64)
            if self.blend >= 1.0:              # Gw = I
                return jnp.asarray(b, jnp.float32)
            x, _, _ = self.g.cg_solve(
                b / (1.0 - self.blend),
                lam=self.blend / (1.0 - self.blend), scale=True,
                tol=self.inner_tol, maxiter=self.inner_maxiter,
                precondition=True)
            return jnp.asarray(x, jnp.float32)
        return _normalized_cg(self._gw, v2, self.inner_tol,
                              self.inner_maxiter, minv=self._gw_minv)

    def a22_inv(self, v2):
        """A22^-1 v2 from the blocks of the SPARSE A^-1:
        A22^-1 = A22blk - A21blk (A11blk)^-1 A12blk.  Routed through a
        module-level jit (inlined when called inside the compiled MME;
        cached across the host-driven outer iterations of the streamed
        path, where an eager lax CG would re-trace per call)."""
        if self.n1 == 0:
            return self.a22.matvec(v2)
        return _a22_inv_impl(self.a11, self.a12, self.a22, self._a11_minv,
                             v2, tol=self.inner_tol,
                             maxiter=self.inner_maxiter)

    def matvec(self, v):
        """H^-1 v for v [n] or [n, k]."""
        squeeze = v.ndim == 1
        vv = v[:, None] if squeeze else v
        out = self.ainv.matvec(vv)
        v2 = vv[self.geno_rows]
        corr = self.tau * self.gw_inv(v2) - self.omega * self.a22_inv(v2)
        out = out.at[self.geno_rows].add(corr)
        return out[:, 0] if squeeze else out

    def diag_approx(self):
        """Positive diagonal surrogate for Jacobi preconditioning of the
        MME (diag(A^-1) plus the genotyped blocks' diagonal surrogates —
        not the exact diag(H^-1), which has no cheap closed form)."""
        d = self.ainv.diag()
        # diag(Gw^-1) ~ 1/diag(Gw); diag(A22^-1) ~ 1 (relationship diag
        # ~ 1+F): crude but only steers Jacobi convergence, not the answer
        corr = self.tau * self._gw_minv - self.omega
        d = d.at[self.geno_rows].add(jnp.maximum(corr, 0.0))
        return jnp.maximum(d, 1e-3)


class SSGBLUPResult(NamedTuple):
    beta: np.ndarray          # fixed effects [p]
    u: np.ndarray             # breeding values, ALL animals [n]
    iterations: int           # outer CG iterations
    residual_norm: float


def ssgblup(
    y: np.ndarray,
    hinv: SingleStepHInv,
    obs_ids: Optional[np.ndarray] = None,
    x: Optional[np.ndarray] = None,
    h2: float = 0.5,
    tol: float = 1e-5,
    maxiter: int = 2000,
) -> SSGBLUPResult:
    """Solve Henderson's MME for y = X beta + W u + e with u over ALL
    pedigree animals and var(u) = sigma_u^2 H:

        [ X'X   X'W            ] [beta]   [X'y]
        [ W'X   W'W + lam H^-1 ] [ u  ] = [W'y],   lam = (1-h2)/h2

    ``obs_ids``: 1-based animal of each phenotype record (defaults to
    1..n_obs); repeated records per animal are allowed.  ``x``: fixed
    design [n_obs, p] (default intercept).  One outer Jacobi block-CG;
    every H^-1 application is the nested operator above.
    """
    n = hinv.n
    y = np.asarray(y, np.float64).reshape(-1)
    n_obs = len(y)
    if obs_ids is None:
        obs_ids = np.arange(1, n_obs + 1)
    obs_ids = np.asarray(obs_ids, np.int64)
    if obs_ids.min() < 1 or obs_ids.max() > n:
        raise ValueError("obs_ids must be 1-based pedigree ids")
    if x is None:
        x = np.ones((n_obs, 1))
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    p = x.shape[1]
    lam = (1.0 - h2) / h2

    obs = jnp.asarray(obs_ids - 1, jnp.int32)
    xj = jnp.asarray(x, jnp.float32)
    yj = jnp.asarray(y, jnp.float32)

    def wt_apply(r):                    # W' r: sum records into animals
        return jax.ops.segment_sum(r, obs, num_segments=n)

    rhs = jnp.concatenate([jnp.dot(xj.T, yj, precision=_HIGHEST),
                           wt_apply(yj)])
    counts = jax.ops.segment_sum(jnp.ones_like(yj), obs, num_segments=n)
    dprec = jnp.concatenate([jnp.sum(xj * xj, axis=0),
                             counts + lam * hinv.diag_approx()])
    minv = 1.0 / dprec

    if hinv._kind == "streamed":
        # out-of-core panel: the MME operator streams chunks through the
        # device per H^-1 apply, so the outer CG is the host loop
        minv_h = np.asarray(minv, np.float64)
        obs0 = obs_ids - 1
        xh = x

        def mme_host(z):                       # z: [p + n, k]
            beta, u = z[:p], z[p:]
            fitted = xh @ beta + u[obs0]
            top = xh.T @ fitted
            bottom = np.zeros((n, z.shape[1]))
            np.add.at(bottom, obs0, fitted)
            hu = np.asarray(hinv.matvec(jnp.asarray(u, jnp.float32)),
                            np.float64)
            return np.concatenate([top, bottom + lam * hu])

        b_h = np.asarray(rhs, np.float64)
        scale = float(np.linalg.norm(b_h))
        xsol, iters, resid = _host_pcg(mme_host, b_h / scale, tol, maxiter,
                                       minv=minv_h)
        z = xsol * scale
        return SSGBLUPResult(z[:p], z[p:], int(iters),
                             float(np.max(resid)) * scale)

    # hinv/obs/xj/minv are jit ARGUMENTS (SingleStepHInv is a pytree):
    # closure capture would embed the sparse blocks + packed panel as HLO
    # constants (see class docstring)
    @jax.jit
    def run(hv, ob, x_, mv, b):
        def mme(z):
            beta, u = z[:p], z[p:]
            fitted = jnp.dot(x_, beta, precision=_HIGHEST) + u[ob]
            top = jnp.dot(x_.T, fitted, precision=_HIGHEST)
            bottom = (jax.ops.segment_sum(fitted, ob, num_segments=n)
                      + lam * hv.matvec(u))
            return jnp.concatenate([top, bottom])

        return cg(mme, b, tol=tol, maxiter=maxiter, minv=mv)

    scale = float(jnp.linalg.norm(rhs))
    res = run(hinv, obs, xj, minv, rhs / scale)
    z = np.asarray(res.x, np.float64) * scale
    return SSGBLUPResult(z[:p], z[p:], int(res.iterations),
                         float(jnp.max(res.residual_norm)) * scale)


def _mme_solver(hinv: SingleStepHInv, obs, xj, tol: float, maxiter: int):
    """Jitted MME solve with a TRACED lambda: C(lam) Z = RHS for a block
    RHS, columns normalized so the absolute CG tolerance acts relatively.
    One compiled executable serves every REML iteration."""
    n, p = hinv.n, xj.shape[1]
    counts = jax.ops.segment_sum(jnp.ones(obs.shape[0], jnp.float32), obs,
                                 num_segments=n)
    dapp = hinv.diag_approx()
    xdiag = jnp.sum(xj * xj, axis=0)

    if hinv._kind == "streamed":
        obs0 = np.asarray(obs)
        xh = np.asarray(xj, np.float64)
        counts_h = np.asarray(counts, np.float64)
        dapp_h = np.asarray(dapp, np.float64)
        xdiag_h = np.asarray(xdiag, np.float64)

        def solve_host(lam, rhs):
            lam = float(lam)
            rhs = np.asarray(rhs, np.float64)

            def mme(z):
                beta, u = z[:p], z[p:]
                fitted = xh @ beta + u[obs0]
                top = xh.T @ fitted
                bottom = np.zeros((n, z.shape[1]))
                np.add.at(bottom, obs0, fitted)
                hu = np.asarray(
                    hinv.matvec(jnp.asarray(u, jnp.float32)), np.float64)
                return np.concatenate([top, bottom + lam * hu])

            minv = 1.0 / np.concatenate([xdiag_h, counts_h + lam * dapp_h])
            norm = np.linalg.norm(rhs, axis=0, keepdims=True)
            safe = np.where(norm > 0, norm, 1.0)
            xsol, iters, _ = _host_pcg(mme, rhs / safe, tol, maxiter,
                                       minv=minv)
            return xsol * safe, iters

        return solve_host

    @jax.jit
    def solve_impl(hv, ob, x_, counts_, dapp_, xdiag_, lam, rhs):
        # big operands arrive as pytree arguments, not captured constants
        def mme(z):
            beta, u = z[:p], z[p:]
            fitted = jnp.dot(x_, beta, precision=_HIGHEST) + u[ob]
            top = jnp.dot(x_.T, fitted, precision=_HIGHEST)
            bottom = (jax.ops.segment_sum(fitted, ob, num_segments=n)
                      + lam * hv.matvec(u))
            return jnp.concatenate([top, bottom])

        minv = 1.0 / jnp.concatenate([xdiag_, counts_ + lam * dapp_])
        norm = jnp.linalg.norm(rhs, axis=0, keepdims=True)
        safe = jnp.where(norm > 0, norm, 1.0)
        r = cg(mme, rhs / safe, tol=tol, maxiter=maxiter, minv=minv)
        return r.x * safe, r.iterations

    def solve(lam, rhs):
        return solve_impl(hinv, obs, xj, counts, dapp, xdiag, lam, rhs)

    return solve


def estimate_h2_reml_ss(
    y: np.ndarray,
    hinv: SingleStepHInv,
    obs_ids: Optional[np.ndarray] = None,
    x: Optional[np.ndarray] = None,
    n_probes: int = 8,
    probes: Optional[np.ndarray] = None,
    max_iter: int = 30,
    tol: float = 5e-4,
    cg_tol: float = 1e-6,
    cg_maxiter: int = 3000,
    seed: int = 0,
    init_h2: float = 0.5,
    verbose: bool = False,
):
    """REML variance components for the SINGLE-STEP model — the piece the
    reference ecosystem outsources (MiXBLUP takes variance ratios as
    input; GCTA's --reml cannot use pedigree-only animals): stochastic
    AI-REML on y = X beta + W u + e with var(u) = sigma_u^2 H, entirely
    from MME solves and H^-1 matvecs.  The classical identities make every
    term cheap (verified numerically in tests/test_ssgblup.py):

        P y           = e_hat / s2e           (MME residual)
        y'P V_u P y   = t' u_hat / s2u,  t = W' P y   (no H apply: u_hat
                                                        = s2u * H t)
        tr(P V_u)     = (q - lam * tr(C^uu H^-1)) / s2u
        tr(P)         = (n - p - q + lam * tr(C^uu H^-1)) / s2e

    with tr(C^uu H^-1) the ONE stochastic trace — Hutchinson probes
    [0; z] through the MME, dotted with H^-1 z (a direct matvec, computed
    once and reused: the probes are shared across iterations).  The AI
    matrix is exact (quadratic forms via one extra 2-column MME solve),
    with an EM step as fallback.  ``lam`` is traced, so all REML
    iterations reuse two compiled nested-CG executables.

    ``probes=np.eye(q)`` makes the trace exact (small problems / tests).
    Returns ``(h2, details)`` as :func:`gblup.estimate_h2_reml`.
    """
    n = hinv.n
    q = n
    y = np.asarray(y, np.float64).reshape(-1)
    n_obs = len(y)
    if obs_ids is None:
        obs_ids = np.arange(1, n_obs + 1)
    obs_ids = np.asarray(obs_ids, np.int64)
    if x is None:
        x = np.ones((n_obs, 1))
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    p = x.shape[1]
    yvar = float(y.var())
    yt = (y - y.mean()) / max(y.std(), 1e-12)

    if probes is None:
        rng = np.random.default_rng(seed)
        z = rng.choice((-1.0, 1.0), size=(q, n_probes))
        exact_traces = False
    else:
        z = np.asarray(probes, np.float64)
        n_probes = z.shape[1]
        exact_traces = (z.shape[1] == q and np.array_equal(z, np.eye(q)))

    obs = jnp.asarray(obs_ids - 1, jnp.int32)
    xj = jnp.asarray(x, jnp.float32)
    solve = _mme_solver(hinv, obs, xj, cg_tol, cg_maxiter)

    # H^-1 z: lambda-independent — one batched matvec for all iterations
    hz = np.asarray(hinv.matvec(jnp.asarray(z, jnp.float32)), np.float64)

    wty = np.zeros(q)
    np.add.at(wty, obs_ids - 1, yt)
    rhs_y = np.concatenate([x.T @ yt, wty])
    rhs_z = np.concatenate([np.zeros((p, n_probes)), z], axis=0)
    block_a = jnp.asarray(np.column_stack([rhs_y, rhs_z]), jnp.float32)

    s2u = float(np.clip(init_h2, 0.05, 0.95))
    s2e = 1.0 - s2u
    floor = 1e-6
    converged = False
    cg_total = 0
    ai = np.eye(2)
    for it in range(max_iter):
        lam = s2e / s2u
        sol, iters = solve(jnp.float32(lam), block_a)
        sol = np.asarray(sol, np.float64)
        cg_total += int(iters)
        beta, u = sol[:p, 0], sol[p:, 0]
        su = sol[p:, 1:]                       # (C^-1 [0; z])_u
        if exact_traces:
            # z = I: hz = H^-1, su = C^uu, both symmetric ->
            # tr(H^-1 C^uu) = sum_ij (H^-1)_ij (C^uu)_ij
            tr_ch = float(np.sum(hz * su))
        else:
            tr_ch = float(np.mean(np.sum(hz * su, axis=0)))
        ehat = yt - x @ beta - u[obs_ids - 1]
        py = ehat / s2e
        wtpy = np.zeros(q)
        np.add.at(wtpy, obs_ids - 1, py)
        quad_u = float(wtpy @ u) / s2u
        quad_e = float(py @ py)
        tr_u = (q - lam * tr_ch) / s2u
        tr_e = (n_obs - p - q + lam * tr_ch) / s2e
        score = np.array([-0.5 * (tr_u - quad_u), -0.5 * (tr_e - quad_e)])

        r_u = u[obs_ids - 1] / s2u             # W u_hat / s2u = V_u P y
        r_e = py
        rhs_b = np.zeros((p + q, 2))
        rhs_b[:p, 0] = x.T @ r_u
        np.add.at(rhs_b[p:, 0], obs_ids - 1, r_u)
        rhs_b[:p, 1] = x.T @ r_e
        np.add.at(rhs_b[p:, 1], obs_ids - 1, r_e)
        solb, itb = solve(jnp.float32(lam), jnp.asarray(rhs_b, jnp.float32))
        solb = np.asarray(solb, np.float64)
        cg_total += int(itb)
        pr = np.empty((n_obs, 2))
        for k, r in enumerate((r_u, r_e)):
            pr[:, k] = (r - x @ solb[:p, k]
                        - solb[p:, k][obs_ids - 1]) / s2e
        ai = 0.5 * np.array([
            [r_u @ pr[:, 0], r_u @ pr[:, 1]],
            [r_e @ pr[:, 0], r_e @ pr[:, 1]],
        ])
        ai = 0.5 * (ai + ai.T)

        theta = np.array([s2u, s2e])
        try:
            new = theta + np.linalg.solve(ai, score)
        except np.linalg.LinAlgError:
            new = np.array([np.nan, np.nan])
        if not np.all(np.isfinite(new)) or (new < floor).any() or \
                new.sum() > 10.0:
            # EM step: theta_i += theta_i^2 (quad_i - tr_i) / df_i
            new = theta + theta ** 2 * np.array(
                [(quad_u - tr_u) / q, (quad_e - tr_e) / n_obs])
            new = np.clip(new, floor, 10.0)
        step = float(np.abs(new - theta).max() / max(new.sum(), 1e-12))
        s2u, s2e = float(new[0]), float(new[1])
        if verbose:
            print(f"  ss-reml iter {it + 1}: s2u={s2u:.4f} s2e={s2e:.4f} "
                  f"score=({score[0]:+.3e},{score[1]:+.3e}) "
                  f"step={step:.2e}", flush=True)
        if step < tol:
            converged = True
            break

    h2 = s2u / (s2u + s2e)
    se_h2 = float("nan")
    try:
        cov_theta = np.linalg.inv(ai)
        grad = np.array([s2e, -s2u]) / (s2u + s2e) ** 2
        v = float(grad @ cov_theta @ grad)
        se_h2 = float(np.sqrt(v)) if v > 0 else float("nan")
    except np.linalg.LinAlgError:
        pass
    return float(h2), {
        "s2u": s2u, "s2e": s2e,
        "vu": s2u * yvar, "ve": s2e * yvar,
        "se_h2": se_h2, "iterations": it + 1, "converged": converged,
        "cg_iterations": cg_total, "n_probes": n_probes,
        "exact_traces": exact_traces,
    }


def run_ssgblup(bed_path: str, pedigree_path: str,
                pheno_path: Optional[str] = None, out: str = "ebv.tsv",
                h2: float = 0.5, blend: float = 0.05, tau: float = 1.0,
                omega: float = 1.0, tol: float = 1e-5,
                inner_tol: float = 1e-6, no_inbreeding: bool = False,
                estimate_h2: bool = False, stream_chunk: int = 0) -> int:
    """CLI entry: single-step evaluation from files.

    - ``bed_path``: PLINK fileset of the GENOTYPED animals; the .fam
      within-family id (column 2) must match the pedigree labels.
    - ``pedigree_path``: animal/sire/dam per line, arbitrary labels
      (:func:`pedigree.read_pedigree`); genotyped animals absent from the
      file are appended as founders (warned).
    - ``pheno_path``: two-column file (animal label, value) — phenotypes
      may cover ANY pedigree animal, genotyped or not.  Defaults to the
      .fam 6th column (genotyped animals only; -9 = missing).
    - ``stream_chunk`` > 0: ingest the panel as a StreamedGeno in SNP
      chunks of that size — panels beyond one chip's HBM solve out of
      core (the host-driven outer CG; same oracle-verified answer).

    Writes a TSV of EBVs for every pedigree animal.
    """
    from .geno import from_bed
    from .pedigree import read_pedigree

    sire, dam, labels = read_pedigree(pedigree_path)
    if stream_chunk > 0:
        from .streamed import StreamedGeno

        g = StreamedGeno.from_bed(bed_path, chunk_snps=stream_chunk)
    else:
        g = from_bed(bed_path)
    with open(bed_path[:-4] + ".fam") as fh:
        fam = [ln.split() for ln in fh if ln.strip()]
    iids = [f[1] for f in fam]
    if len(iids) != g.indiv:
        raise SystemExit(f".fam has {len(iids)} animals, panel {g.indiv}")

    code = {lab: i + 1 for i, lab in enumerate(labels)}
    extra = [iid for iid in iids if iid not in code]
    if extra:
        print(f"warning: {len(extra)} genotyped animals missing from the "
              f"pedigree — appended as founders (e.g. {extra[:3]})")
        n0 = len(labels)
        labels = labels + extra
        sire = np.concatenate([sire, np.zeros(len(extra), np.int64)])
        dam = np.concatenate([dam, np.zeros(len(extra), np.int64)])
        code.update({lab: n0 + i + 1 for i, lab in enumerate(extra)})
    geno_ids = np.array([code[iid] for iid in iids], np.int64)

    if pheno_path:
        obs_l, y_l = [], []
        with open(pheno_path) as fh:
            for lineno, ln in enumerate(fh, 1):
                ln = ln.split("#", 1)[0].strip()
                if not ln:
                    continue
                parts = ln.split()
                if len(parts) < 2:
                    raise SystemExit(f"{pheno_path}:{lineno}: need "
                                     "'animal value' (got 1 token)")
                a, v = parts[:2]
                if a not in code:
                    raise SystemExit(f"{pheno_path}:{lineno}: animal {a!r} "
                                     "not in the pedigree")
                obs_l.append(code[a])
                try:
                    y_l.append(float(v))
                except ValueError:
                    raise SystemExit(f"{pheno_path}:{lineno}: non-numeric "
                                     f"phenotype {v!r}")
        obs_ids = np.array(obs_l, np.int64)
        y = np.array(y_l)
    else:
        y_all = np.array([f[5] for f in fam], np.float64)
        keep = y_all != -9
        if not keep.any():
            raise SystemExit("no phenotypes: .fam column 6 is all -9 and "
                             "no --pheno file given")
        obs_ids = geno_ids[keep]
        y = y_all[keep]
    print(f"{len(labels)} pedigree animals, {g.indiv} genotyped, "
          f"{len(y)} records")

    f = np.zeros(len(labels)) if no_inbreeding else None
    hinv = SingleStepHInv(sire, dam, g, geno_ids, blend=blend, tau=tau,
                          omega=omega, inner_tol=inner_tol, f=f)
    if estimate_h2:
        h2_hat, det = estimate_h2_reml_ss(y, hinv, obs_ids=obs_ids)
        print(f"ss-AI-REML h2 = {h2_hat:.3f} (SE {det['se_h2']:.3f}, "
              f"{det['iterations']} AI steps, converged="
              f"{det['converged']}; replacing --h2 {h2})")
        h2 = min(max(h2_hat, 0.01), 0.99)
    res = ssgblup(y, hinv, obs_ids=obs_ids, h2=h2, tol=tol)
    with open(out, "w") as fh:
        fh.write("animal\tebv\tgenotyped\n")
        gset = set(geno_ids.tolist())
        for i, lab in enumerate(labels):
            fh.write(f"{lab}\t{res.u[i]:.6g}\t{int(i + 1 in gset)}\n")
    print(f"wrote {out}: EBVs for {len(labels)} animals "
          f"(outer CG iterations: {res.iterations}, "
          f"residual {res.residual_norm:.2e})")
    print(f"fixed effects: {np.round(res.beta, 4)}")
    return 0
