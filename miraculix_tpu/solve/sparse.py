"""Sparse triangular solves (the MiXBLUP single-step path), O(nnz) storage.

The reference uploads a COO lower-triangular factor once (``sparse2gpu``:
cusparseCreateCoo + SpSM analysis, src/cuda/solve_cuda.cu:281-882), then
serves repeated ``dcsrtrsv_solve_gpu('n'/'t')`` calls; the Fortran layer
composes the two-triangle solve L(Lᵀx)=B with an optional row permutation
(src/bindings/Fortran/modmiraculix_gpu.f90:80-157).  Its factors come from
sparse pedigree/mixed-model equations with millions of rows and ~10 nonzeros
per row (tests/solve/test.jl simulates exactly that shape).

The scalar dependency chain of SpSM is hostile to wide SIMD and to
thousands of parallel threads.  The formulation here is **blocked
substitution**: partition the unknowns into contiguous blocks of ``bs`` rows;
the factor splits into dense ``bs x bs`` diagonal blocks (inverted once at
init — a triangular inverse, so applying it is one small matmul) and the
off-diagonal entries, kept as flat COO grouped per block (O(nnz) storage).
One ``lax.scan`` over blocks then performs the substitution: each step is a
gather + scatter-add (the sparse "apply previous x") and one ``bs x bs``
matmul — everything stays on device, and the init-once / solve-many
lifecycle of the reference is preserved.

Capacity: storage is O(nnz + n·bs); at the reference's resilience scale
(n = 7e4, test.jl:177-191) and far beyond (n = 1e6, nnz = 1e7) the working
set is ~1 GB at bs=256 — comfortably inside a single chip's HBM.  The old
dense-materialized implementation (39 GB at n=7e4) is gone.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def _invert_tri_batched(t: np.ndarray, lower: bool,
                        base: int = 32) -> np.ndarray:
    """Invert a batch of triangular matrices [nb, bs, bs] with batched
    LAPACK at a small ``base`` block size, then bottom-up block doubling
    where every level is ONE stacked BLAS matmul over all sub-blocks of
    all batch members at once.

    For lower-triangular [[A, 0], [C, D]] the inverse is
    [[A⁻¹, 0], [-D⁻¹ C A⁻¹, D⁻¹]]; ``np.linalg.inv`` on the batched
    ``base x base`` diagonal sub-blocks seeds the recursion (a triangular
    inverse is triangular, so the general-LU detour is exact to machine
    precision — measured 6e-16 residual) and log2(bs/base) doubling levels
    build the full inverse.  Replaces a per-block LAPACK ``dtrtri`` loop
    whose f2py + copy overhead dominated at nb ~ 4000 (measured 15.9 s ->
    ~7 s for n = 1e6, bs = 256, f64).  ``bs`` must be a power of two (the
    caller's default 256 is; pads otherwise)."""
    nb, bs, _ = t.shape
    p2 = 1 << (bs - 1).bit_length()
    if p2 != bs:  # pad to the next power of two with identity tails
        tp = np.zeros((nb, p2, p2), t.dtype)
        tp[:, :bs, :bs] = t
        idx = np.arange(bs, p2)
        tp[:, idx, idx] = 1.0
        return _invert_tri_batched(tp, lower, base)[:, :bs, :bs]
    if not lower:
        # upper triangle: invert the transposed-lower batch, transpose back
        return _invert_tri_batched(
            np.ascontiguousarray(t.transpose(0, 2, 1)), True, base
        ).transpose(0, 2, 1)
    base = min(base, bs)
    out = np.zeros_like(t)
    ns0 = bs // base
    tv0 = t.reshape(nb, ns0, base, ns0, base)
    ov0 = out.reshape(nb, ns0, base, ns0, base)
    i0 = np.arange(ns0)
    # advanced indexing moves the sub-block axis first: (ns0, nb, b, b)
    ov0[:, i0, :, i0, :] = np.linalg.inv(tv0[:, i0, :, i0, :])
    h = base
    while h < bs:
        ns = bs // (2 * h)
        # view diagonal 2h x 2h sub-blocks as [nb, ns, 2h, 2h]: rows of
        # sub-block i are i*2h + r — a pure reshape of the last two axes
        tv = t.reshape(nb, ns, 2 * h, ns, 2 * h)
        ov = out.reshape(nb, ns, 2 * h, ns, 2 * h)
        i = np.arange(ns)
        c = tv[:, i, h:, i, :h]
        ai = ov[:, i, :h, i, :h]
        di = ov[:, i, h:, i, h:]
        ov[:, i, h:, i, :h] = -np.matmul(di, np.matmul(c, ai))
        h *= 2
    return out


@functools.partial(jax.jit, static_argnames=("nb", "bs", "lower", "base"))
def _assemble_invert_tri_device(dr, dc, dv, pad_idx, *, nb, bs, lower,
                                base=32):
    """Assemble + invert the diagonal blocks ON DEVICE (f32).

    Ships only the diagonal COO triplets (O(nnz_diag) bytes) instead of the
    dense [nb, bs, bs] inverse computed on host — at n = 1e6, bs = 512 that
    replaces ~100 s of host f64 BLAS plus a 2 GB dinv transfer with a
    device scatter + the same bottom-up block-doubling in batched matmuls
    (f32, HIGHEST precision).  f32 inversion error scales with each block's
    condition number instead of plain rounding — acceptable for the f32
    solver whose recurrence is f32 anyway (``solve(refine=...)`` corrects
    against the EXACT COO matvec); the f64 solver keeps the host path.
    """
    t = (jnp.zeros((nb, bs, bs), jnp.float32)
         .at[dr // bs, dr % bs, dc % bs].add(dv))
    t = t.at[pad_idx // bs, pad_idx % bs, pad_idx % bs].set(1.0)
    if not lower:
        t = jnp.swapaxes(t, 1, 2)
    p2 = 1 << (bs - 1).bit_length()
    if p2 != bs:  # pad to a power of two with identity tails
        tp = jnp.zeros((nb, p2, p2), t.dtype)
        tp = tp.at[:, :bs, :bs].set(t)
        i = jnp.arange(bs, p2)
        t = tp.at[:, i, i].set(1.0)
    with jax.default_matmul_precision("highest"):
        base = min(base, p2)
        ns0 = p2 // base
        tv = t.reshape(nb, ns0, base, ns0, base)
        d0 = jnp.moveaxis(jnp.diagonal(tv, axis1=1, axis2=3), -1, 1)
        x = jnp.linalg.inv(d0.reshape(nb * ns0, base, base)
                           ).reshape(nb, ns0, base, base)
        h = base
        while h < p2:
            ns = p2 // (2 * h)
            tv = t.reshape(nb, ns, 2 * h, ns, 2 * h)
            d2 = jnp.moveaxis(jnp.diagonal(tv, axis1=1, axis2=3), -1, 1)
            cblk = d2[:, :, h:, :h]
            xp = x.reshape(nb, ns, 2, h, h)
            ai, di = xp[:, :, 0], xp[:, :, 1]
            low = -jnp.matmul(di, jnp.matmul(cblk, ai))
            top = jnp.concatenate([ai, jnp.zeros_like(ai)], axis=-1)
            bot = jnp.concatenate([low, di], axis=-1)
            x = jnp.concatenate([top, bot], axis=-2)
            h *= 2
        x = x.reshape(nb, p2, p2)
        # one Newton step X <- X(2I - T X): the doubling's f32 forward
        # error compounds with block condition; Newton squares the residual
        # toward the f32 STORAGE floor (~kappa*u), the same floor the
        # host-f64-then-cast inverse has — so ill-conditioned relationship
        # blocks lose nothing vs the host path (two batched matmuls)
        eye2 = 2.0 * jnp.eye(p2, dtype=x.dtype)
        x = jnp.matmul(x, eye2[None] - jnp.matmul(t, x))
    x = x[:, :bs, :bs]
    return jnp.swapaxes(x, 1, 2) if not lower else x


def _analyze(rows, cols, vals, n, bs, lower, np_dtype, device_invert=False):
    """Host-side init-once analysis (the ``sparse2gpu`` analysis phase):
    dense diagonal-block inverses + per-block padded off-diagonal COO
    groups for both sweep directions."""
    nb = -(-n // bs)
    npad = nb * bs
    rb, cb = rows // bs, cols // bs

    # --- dense diagonal blocks, inverted once ----------------------------
    diag_mask = rb == cb
    dr, dc, dv = rows[diag_mask], cols[diag_mask], vals[diag_mask]
    # singular check on the COALESCED diagonal (duplicates sum, the same
    # semantics the scatter-add assembly gives every entry)
    dsum = np.zeros(n, np.float64)
    np.add.at(dsum, dr[dr == dc], dv[dr == dc])
    if (np.abs(dsum) < np.finfo(np.float64).tiny).any():
        raise np.linalg.LinAlgError("singular diagonal block")
    pad_idx = np.arange(n, npad)
    if device_invert:
        dinv = _assemble_invert_tri_device(
            jnp.asarray(dr.astype(np.int32)), jnp.asarray(dc.astype(np.int32)),
            jnp.asarray(dv.astype(np.float32)),
            jnp.asarray(pad_idx.astype(np.int32)),
            nb=nb, bs=bs, lower=lower)
    else:
        # assemble + invert in FLOAT64 on host, cast once at the end: the
        # stored inverse is then the correctly-rounded one even for
        # ill-conditioned relationship-factor blocks
        dblocks = np.zeros((nb, bs, bs), np.float64)
        np.add.at(dblocks, (dr // bs, dr % bs, dc % bs), dv)
        dblocks[pad_idx // bs, pad_idx % bs, pad_idx % bs] = 1.0
        dinv = np.ascontiguousarray(_invert_tri_batched(dblocks, lower),
                                    dtype=np_dtype)

    # --- off-diagonal entries, grouped per block for each sweep ----------
    off_mask = ~diag_mask
    orows, ocols, ovals = rows[off_mask], cols[off_mask], vals[off_mask]

    def group(block_of_entry, local_axis_idx, gather_idx):
        """Pad per-block entry lists to the max count; padding entries
        gather x[0] with value 0 (harmless)."""
        order = np.argsort(block_of_entry, kind="stable")
        blk = block_of_entry[order]
        counts = np.bincount(blk, minlength=nb)
        mmax = int(counts.max()) if counts.size else 0
        mmax = max(mmax, 1)
        loc = np.zeros((nb, mmax), np.int32)
        gat = np.zeros((nb, mmax), np.int32)
        val = np.zeros((nb, mmax), np_dtype)
        starts = np.concatenate([[0], np.cumsum(counts)])
        within = np.arange(len(blk)) - starts[blk]
        loc[blk, within] = local_axis_idx[order]
        gat[blk, within] = gather_idx[order]
        val[blk, within] = ovals[order]
        return loc, gat, val, mmax

    # trans='n' sweep: block-row i consumes x at column indices
    fwd = group(orows // bs, (orows % bs).astype(np.int64), ocols)
    # trans='t' sweep: block-col i consumes x at row indices
    bwd = group(ocols // bs, (ocols % bs).astype(np.int64), orows)
    return nb, npad, dinv, fwd[:3], bwd[:3]


def _block_sweep(x0, b, dinv, loc, gat, val, starts, *, bs, transpose_diag,
                 reverse):
    """One substitution sweep as a lax.scan over blocks.

    Carry = the full solution [npad, ncol]; step i gathers the
    already-computed entries it depends on, scatter-adds the sparse
    contribution, applies the dense inverted diagonal block, and writes
    block i of x.  ``reverse`` runs blocks last-to-first (the transposed /
    upper sweep); dependencies then point at later blocks, which that
    ordering has already produced.
    """
    def body(x, inp):
        b_i, dinv_i, loc_i, gat_i, val_i, start = inp
        xg = x[gat_i]                                  # [mmax, ncol]
        contrib = jnp.zeros_like(b_i).at[loc_i].add(val_i[:, None] * xg)
        rhs = b_i - contrib
        di = dinv_i.T if transpose_diag else dinv_i
        xi = jnp.matmul(di, rhs, precision=jax.lax.Precision.HIGHEST)
        x = jax.lax.dynamic_update_slice(
            x, xi, (start, jnp.zeros((), start.dtype)))
        return x, None

    nb = dinv.shape[0]
    bblocks = b.reshape(nb, bs, -1)
    xs = (bblocks, dinv, loc, gat, val, starts)
    x, _ = jax.lax.scan(body, x0, xs, reverse=reverse)
    return x


@functools.partial(jax.jit, static_argnames=("bs", "trans", "lower"))
def _solve_jit(b, dinv, floc, fgat, fval, bloc, bgat, bval, starts,
               *, bs, trans, lower):
    x0 = jnp.zeros_like(b)
    # trans='n' consumes entries by block-ROW (fwd grouping), trans='t' by
    # block-COLUMN (bwd grouping, with the diagonal blocks transposed).
    # Direction: 'n' on lower / 't' on upper substitute first-to-last;
    # the other two combinations are upper-triangular systems -> reverse.
    if trans == "n":
        return _block_sweep(x0, b, dinv, floc, fgat, fval, starts,
                            bs=bs, transpose_diag=False, reverse=not lower)
    return _block_sweep(x0, b, dinv, bloc, bgat, bval, starts,
                        bs=bs, transpose_diag=True, reverse=lower)


@jax.tree_util.register_pytree_node_class
class SparseTriangularSolver:
    """Init-once / solve-many triangular solver (lifecycle of ``sparse2gpu``
    / ``dcsrtrsv_solve_gpu`` / ``free_sparse_gpu``, solve_cuda.h:54-74).

    Registered as a pytree so jitted callers take the solver as an
    ARGUMENT (``jit(lambda slv, b: slv.solve_lltx(b))``): closing over it
    embeds the analysis buffers as HLO constants — at n=1e6/bs=512 that is
    a 2.69 GB program per trace.  Host-side state (the f64 triplets
    backing :meth:`solve_f64` and the CSR cache) is NOT a leaf; instances
    reconstructed inside a trace carry ``None`` there, which only the
    host-refinement methods touch.

    Parameters mirror the reference: COO triplets (1-based indices by
    default, as the Fortran callers supply them), matrix size, optional row
    permutation in :meth:`solve_lltx` as in ``c_solve_gpu_perm``
    (modmiraculix_gpu.f90:80-126).  ``bs`` is the substitution block size
    (analysis granularity — any value >= 1 is correct; diagonal-inverse
    storage is 4·n·bs bytes = 2 GB at n=1e6, bs=512; the best value on the
    H100 is not measured).
    """

    def __init__(
        self,
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        n: int,
        index_base: int = 1,
        lower: bool = True,
        bs: int = 512,
        dtype=None,
        device_analysis: Optional[bool] = None,
    ):
        rows = np.asarray(rows, dtype=np.int64).ravel() - index_base
        cols = np.asarray(cols, dtype=np.int64).ravel() - index_base
        vals = np.asarray(vals, dtype=np.float64).ravel()
        if len(rows) == 0:
            raise ValueError("empty factor")
        if rows.min() < 0 or rows.max() >= n or cols.min() < 0 or cols.max() >= n:
            raise ValueError("COO indices out of range")
        outside = (cols > rows) if lower else (cols < rows)
        if (vals[outside] != 0).any():
            raise ValueError(
                f"matrix has entries outside the {'lower' if lower else 'upper'} triangle"
            )
        diag_present = np.zeros(n, bool)
        diag_mask = rows == cols
        diag_present[rows[diag_mask][vals[diag_mask] != 0]] = True
        if not diag_present.all():
            raise ValueError("triangular factor has zero diagonal")

        if dtype is None:
            # f64 end-to-end on the CPU under x64 (the reference's double
            # solves); f32 + optional host refinement on the GPU, whose
            # f64 units are not yet measured against that route
            use64 = (jax.config.jax_enable_x64
                     and jax.default_backend() == "cpu")
            dtype = jnp.float64 if use64 else jnp.float32
        np_dtype = np.dtype(jnp.dtype(dtype).name)
        bs = max(1, min(bs, n))
        self.n = n
        self.lower = lower
        self.bs = bs
        self.nnz = int(len(vals))
        if device_analysis is None:
            # f32 solvers invert on device (matmul doubling; ships only the
            # diagonal COO); the f64 path keeps the host inversion whose
            # result is correctly rounded for ill-conditioned blocks
            device_analysis = np_dtype == np.float32
        nb, npad, dinv, fwd, bwd = _analyze(rows, cols, vals, n, bs, lower,
                                            np_dtype,
                                            device_invert=device_analysis)
        self.nb, self.npad = nb, npad
        self._dinv = jnp.asarray(dinv)
        self._fwd = tuple(jnp.asarray(a) for a in fwd)
        self._bwd = tuple(jnp.asarray(a) for a in bwd)
        self._starts = jnp.arange(nb, dtype=jnp.int32) * bs
        # flat COO for the O(nnz) matvec / residual refinement
        self._rows = jnp.asarray(rows.astype(np.int32))
        self._cols = jnp.asarray(cols.astype(np.int32))
        self._vals = jnp.asarray(vals.astype(np_dtype))
        self._dtype = dtype
        # the ORIGINAL f64 triplets, kept on host for the f64-grade
        # refinement residuals (the device copy may be f32; residuals
        # against a rounded matrix would floor at the rounding, not at
        # f64) — 16 bytes/nnz, lazily assembled into CSR on first use
        self._host64 = (rows.astype(np.int64), cols.astype(np.int64), vals)
        self._csr_cache = {}

    # -- pytree protocol ---------------------------------------------------
    _LEAVES = ("_dinv", "_fwd", "_bwd", "_starts", "_rows", "_cols",
               "_vals")
    _AUX = ("n", "lower", "bs", "nnz", "nb", "npad", "_dtype")

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
        obj._host64 = None          # host-only; trace-side copies lack it
        obj._csr_cache = {}
        return obj

    # -- O(nnz) sparse matvec (for residuals / refinement) ----------------
    def matvec(self, x: jax.Array, trans: str = "n") -> jax.Array:
        """y = L x ('n') or Lᵀ x ('t'), one scatter-add over the COO."""
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        r, c = (self._rows, self._cols) if trans == "n" else (self._cols,
                                                              self._rows)
        y = jnp.zeros((self.n, x.shape[1]), x.dtype)
        y = y.at[r].add(self._vals[:, None] * x[c])
        return y[:, 0] if squeeze else y

    def solve(self, b: jax.Array, trans: str = "n",
              refine: int = 0) -> jax.Array:
        """Solve L x = b ('n') or Lᵀ x = b ('t').

        ``refine`` adds iterative-refinement sweeps (x += solve(b - L x)),
        halving-ish the f32 recurrence error per sweep at one extra
        substitution + one O(nnz) matvec each.
        """
        trans = trans.lower()
        if trans not in ("n", "t"):
            raise ValueError(f"trans must be 'n' or 't', got {trans!r}")
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        b = jnp.asarray(b, self._dtype)
        bpad = b if self.npad == self.n else jnp.zeros(
            (self.npad, b.shape[1]), b.dtype).at[: self.n].set(b)
        x = self._solve_padded(bpad, trans)[: self.n]
        for _ in range(refine):
            r = b - self.matvec(x, trans=trans)
            rpad = r if self.npad == self.n else jnp.zeros(
                (self.npad, r.shape[1]), r.dtype).at[: self.n].set(r)
            x = x + self._solve_padded(rpad, trans)[: self.n]
        return x[:, 0] if squeeze else x

    def _solve_padded(self, bpad: jax.Array, trans: str) -> jax.Array:
        floc, fgat, fval = self._fwd
        bloc, bgat, bval = self._bwd
        return _solve_jit(bpad, self._dinv, floc, fgat, fval,
                          bloc, bgat, bval, self._starts,
                          bs=self.bs, trans=trans, lower=self.lower)

    def solve_lltx(
        self, b: jax.Array, perm: Optional[np.ndarray] = None,
        index_base: int = 1, refine: int = 0,
    ) -> jax.Array:
        """Full normal-equation solve L Lᵀ x = b with optional symmetric row
        permutation, matching ``c_solve_gpu_perm``/``_noperm``
        (modmiraculix_gpu.f90:80-157)."""
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        if perm is not None:
            p = jnp.asarray(np.asarray(perm, dtype=np.int64) - index_base)
            b = b[p]
        y = self.solve(b, trans="n", refine=refine)
        x = self.solve(y, trans="t", refine=refine)
        if perm is not None:
            x = jnp.zeros_like(x).at[p].set(x)
        return x[:, 0] if squeeze else x

    # -- f64-grade solves: mixed-precision iterative refinement -----------
    def _host_csr(self, trans: str):
        if self._host64 is None:
            raise RuntimeError(
                "f64-grade refinement needs the ORIGINAL solver instance "
                "(host f64 triplets are not pytree leaves; a solver "
                "reconstructed inside jit cannot do host residuals)")
        if trans not in self._csr_cache:
            from scipy import sparse

            # lazy per-orientation: solve_f64(trans='n') never needs the
            # transpose (an extra full sort/copy, ~nnz*12 bytes)
            if trans == "n":
                r, c, v = self._host64
                self._csr_cache["n"] = sparse.csr_matrix(
                    (v, (r, c)), shape=(self.n, self.n))
            else:
                self._csr_cache["t"] = self._host_csr("n").T.tocsr()
        return self._csr_cache[trans]

    def solve_f64(self, b, trans: str = "n", tol: float = 1e-12,
                  max_sweeps: int = 20, inner_refine: int = 2):
        """Solve to FLOAT64 grade from an f32 solver: the f32
        blocked substitution is the preconditioner, residuals are computed
        EXACTLY in host f64 against the original COO triplets (classic
        mixed-precision iterative refinement).  ``inner_refine`` device
        (f32) refinement steps sharpen every substitution before the host
        sweep — each outer sweep then contracts by the REFINED inner
        accuracy, so fewer host round trips are needed.  Matches the
        reference's end-to-end f64
        cuSPARSE path (/root/reference/src/cuda/solve_cuda.cu:281-882) in
        accuracy.  Returns (x float64, relative residual)."""
        if jnp.dtype(self._dtype) == jnp.float64:
            inner_refine = 0      # f64-native backend: already exact-grade
        b64 = np.asarray(b, np.float64)
        squeeze = b64.ndim == 1
        if squeeze:
            b64 = b64[:, None]
        a = self._host_csr(trans)
        x = np.asarray(self.solve(jnp.asarray(b64, self._dtype),
                                  trans=trans, refine=inner_refine),
                       np.float64)
        if x.ndim == 1:
            x = x[:, None]
        bnorm = max(float(np.linalg.norm(b64)), np.finfo(np.float64).tiny)
        rel = float("inf")
        for _ in range(max_sweeps):
            r = b64 - a @ x
            rel = float(np.linalg.norm(r)) / bnorm
            if rel <= tol:
                break
            dx = np.asarray(self.solve(jnp.asarray(r, self._dtype),
                                       trans=trans, refine=inner_refine),
                            np.float64)
            x = x + (dx[:, None] if dx.ndim == 1 else dx)
        return (x[:, 0] if squeeze else x), rel

    def solve_lltx_f64(self, b, perm: Optional[np.ndarray] = None,
                       index_base: int = 1, tol: float = 1e-12,
                       max_sweeps: int = 20, inner_refine: int = 2):
        """L Lᵀ x = b to f64 grade (see :meth:`solve_f64`): refinement on
        the COMPOSED operator, residuals r = b − L(Lᵀx) via two exact host
        f64 CSR matvecs per sweep.

        ``inner_refine`` (default 1) adds device-f32 refinement to each
        triangular substitution: each inner step sharpens the
        per-application accuracy by orders of magnitude at the cost of one
        extra substitution + one O(nnz) device COO matvec per triangle, so
        tol=1e-12 needs fewer outer sweeps, each a host round trip of the
        full vector.  Returns (x float64, rel residual)."""
        if jnp.dtype(self._dtype) == jnp.float64:
            inner_refine = 0      # f64-native backend: already exact-grade
        b64 = np.asarray(b, np.float64)
        squeeze = b64.ndim == 1
        if squeeze:
            b64 = b64[:, None]
        if perm is not None:
            p = np.asarray(perm, np.int64) - index_base
            b64 = b64[p]
        ln = self._host_csr("n")
        lt = self._host_csr("t")

        def dev_solve(rhs):
            y = self.solve(jnp.asarray(rhs, self._dtype), trans="n",
                           refine=inner_refine)
            x = self.solve(y, trans="t", refine=inner_refine)
            x = np.asarray(x, np.float64)
            return x[:, None] if x.ndim == 1 else x

        x = dev_solve(b64)
        bnorm = max(float(np.linalg.norm(b64)), np.finfo(np.float64).tiny)
        rel = float("inf")
        for _ in range(max_sweeps):
            r = b64 - ln @ (lt @ x)
            rel = float(np.linalg.norm(r)) / bnorm
            if rel <= tol:
                break
            x = x + dev_solve(r)
        if perm is not None:
            xout = np.zeros_like(x)
            xout[p] = x
            x = xout
        return (x[:, 0] if squeeze else x), rel

    def free(self) -> None:
        """Release device memory (``free_sparse_gpu`` parity)."""
        for name in ("_dinv", "_fwd", "_bwd", "_starts", "_rows", "_cols",
                     "_vals", "_host64"):
            setattr(self, name, None)
        self._csr_cache = {}


def simulate_pedigree_factor(
    n: int,
    avg_offdiag: int = 9,
    bandwidth: Optional[int] = None,
    seed: int = 0,
    index_base: int = 1,
):
    """Simulate a diagonally-dominant sparse lower-triangular factor with the
    shape of a pedigree/mixed-model Cholesky factor (~``avg_offdiag``
    below-diagonal entries per row, reference tests/solve/test.jl:67-97 and
    utils/benchmark/sparse_solve.jl).  Returns 1-based COO (rows, cols,
    vals) including the diagonal."""
    rng = np.random.default_rng(seed)
    counts = np.minimum(rng.poisson(avg_offdiag, n), np.arange(n))
    rows = np.repeat(np.arange(n), counts)
    lo = rows - (bandwidth or n)
    cols = rng.integers(np.maximum(lo, 0), rows)  # in [max(r-bw,0), r)
    vals = rng.standard_normal(len(rows)) * 0.1
    # diagonal dominance: diag = 1 + sum |offdiag| per row
    diag = np.ones(n)
    np.add.at(diag, rows, np.abs(vals))
    r = np.concatenate([rows, np.arange(n)]) + index_base
    c = np.concatenate([cols, np.arange(n)]) + index_base
    v = np.concatenate([vals, diag])
    return r, c, v
