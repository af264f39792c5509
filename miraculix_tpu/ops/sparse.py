"""Sparse matrix x compressed genotype products (MiXBLUP single-step path).

Reference: ``sparse_times_plink`` (src/miraculix/5codesAPI.c:135-157) backed
by the register-blocked CSR kernel ``sparseTGeno`` (src/miraculix/
plinkUint.cc:352-479).  Semantics (tests/sparse_plink/test_sparse_plink.f90):
S is a CSR matrix [n_idx, indiv]; the op returns C [n_idx, snps] = S @ Z.

Strategy, two regimes:

- moderate ``n_idx`` (fits a dense RHS): the contraction S·Z runs over
  individuals, exactly the axis our transposed packed buffer contracts — so
  C = (Zᵀ · Sᵀ)ᵀ is ONE call of the packed matmul kernel with the
  (densified) sparse transpose as the dense RHS.  The tensor cores eat
  structured sparsity for free at these densities.
- MiXBLUP scale (``n_idx`` ~ 1e6, pedigree incidence matrices): densifying S
  explodes; the O(nnz) path gathers the referenced PACKED genotype rows,
  decodes them in-register, and scatter-adds ``v · Z[row]`` into the output
  — a lax.scan over nnz chunks, nothing bigger than one chunk plus the
  [n_idx, snps] result ever resident.  This is the device analogue of the
  reference's register-blocked CSR kernel (plinkUint.cc:352-479), with the
  register blocks replaced by chunk-wide vector gathers.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..geno import GenoMatrix
from .common import decode_planar16
from .dgemm import packed_matmul


def csr_to_dense(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    n_cols: int,
    index_base: int = 1,
) -> np.ndarray:
    """CSR/Yale triplets -> dense [n_rows, n_cols] (1-based by default, as
    the reference's Fortran callers supply them)."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64) - index_base
    col_idx = np.asarray(col_idx, dtype=np.int64) - index_base
    vals = np.asarray(vals, dtype=np.float64)
    if len(row_ptr) != n_rows + 1:
        raise ValueError(f"row_ptr must have {n_rows + 1} entries")
    dense = np.zeros((n_rows, n_cols), dtype=np.float64)
    rows = np.repeat(np.arange(n_rows), np.diff(row_ptr))
    np.add.at(dense, (rows, col_idx), vals)
    return dense


def _csr_flat(row_ptr, col_idx, vals, n_rows, index_base):
    """CSR -> flat (row_ids, col_ids, vals) triplets, 0-based."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64) - index_base
    col_ids = np.asarray(col_idx, dtype=np.int64) - index_base
    vals = np.asarray(vals, dtype=np.float64)
    if len(row_ptr) != n_rows + 1:
        raise ValueError(f"row_ptr must have {n_rows + 1} entries")
    row_ids = np.repeat(np.arange(n_rows), np.diff(row_ptr))
    return row_ids, col_ids, vals


@functools.partial(jax.jit, static_argnames=("n_idx", "chunk"))
def _segsum_apply(zq, out_rows, gather_rows, vals, *, n_idx, chunk):
    """acc[out_rows] += vals * decode(zq[gather_rows]) over nnz chunks.

    One scan step gathers ``chunk`` packed genotype rows, decodes them,
    and scatter-adds the scaled rows — O(nnz · snps) work,
    O(chunk · snps + n_idx · snps) memory.  Padding entries carry val=0 and
    index 0, contributing nothing.
    """
    nsteps = out_rows.shape[0] // chunk
    acc = jnp.zeros((n_idx, 16 * zq.shape[1]), jnp.float32)

    def body(acc, inp):
        orow, grow, v = inp
        d = decode_planar16(zq[grow], jnp.float32)     # [chunk, 16*kw]
        return acc.at[orow].add(v[:, None] * d), None

    xs = (out_rows.reshape(nsteps, chunk), gather_rows.reshape(nsteps, chunk),
          vals.reshape(nsteps, chunk))
    acc, _ = jax.lax.scan(body, acc, xs)
    return acc


def sparse_times_geno_segsum(
    g: GenoMatrix,
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    vals: np.ndarray,
    n_idx: int,
    trans_sparse: str = "n",
    trans_geno: str = "n",
    index_base: int = 1,
    chunk: int = 8192,
) -> jax.Array:
    """O(nnz) gather/segment-sum evaluation of op(S) @ op(Z) — the
    MiXBLUP-scale path (same semantics as :func:`sparse_times_geno`).

    Viable whenever the [n_idx, out_cols] f32 result fits HBM; per-chunk
    temporaries are ~``chunk * out_cols * 8`` bytes.  Matches the
    reference's CSR kernel sparseTGeno (plinkUint.cc:352-479) at the scale
    it was built for (pedigree incidence: n_idx ~ 1e6, few nnz per row).
    """
    tg, ts = trans_geno.lower(), trans_sparse.lower()
    if tg == "n":
        contract, out_cols, zq = g.indiv, g.snps, g.zq_n
    else:
        contract, out_cols, zq = g.snps, g.indiv, g.zq_t

    csr_rows = n_idx if ts == "n" else contract
    r, c, v = _csr_flat(row_ptr, col_idx, vals, csr_rows, index_base)
    out_rows, gather_rows = (r, c) if ts == "n" else (c, r)
    if gather_rows.size and gather_rows.max() >= contract:
        raise ValueError("sparse column index exceeds the contraction axis")
    # the 't' orientation puts the user-supplied col_idx on the OUTPUT
    # axis — JAX's scatter-add silently DROPS out-of-bounds updates, so an
    # unvalidated index (e.g. 0-based CSR with the default index_base=1)
    # would silently lose nonzeros where method='dense' raises
    if out_rows.size and (out_rows.max() >= n_idx or out_rows.min() < 0):
        raise ValueError(
            f"sparse row index out of range for n_idx={n_idx} "
            f"(found {int(out_rows.min())}..{int(out_rows.max())}; "
            f"index_base={index_base} mismatch?)")

    nnz = len(v)
    chunk = max(1, min(chunk, max(nnz, 1)))
    pad = (-nnz) % chunk
    orow = np.concatenate([out_rows, np.zeros(pad, np.int64)]).astype(np.int32)
    grow = np.concatenate([gather_rows, np.zeros(pad, np.int64)]).astype(np.int32)
    val = np.concatenate([v, np.zeros(pad)]).astype(np.float32)
    acc = _segsum_apply(zq, jnp.asarray(orow), jnp.asarray(grow),
                        jnp.asarray(val), n_idx=n_idx, chunk=chunk)
    return acc[:, :out_cols]


def sparse_times_geno(
    g: GenoMatrix,
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    vals: np.ndarray,
    n_idx: int,
    trans_sparse: str = "n",
    trans_geno: str = "n",
    index_base: int = 1,
    precision: str = "f32",
    method: str = "auto",
) -> jax.Array:
    """C = op(S) @ op(Z):

    - trans_geno='n': op(Z) = Z [indiv, snps], S maps individuals,
      C [n_idx, snps].
    - trans_geno='t': op(Z) = Zᵀ [snps, indiv], S maps SNPs,
      C [n_idx, indiv].
    - trans_sparse='t': S is stored transposed ([cols, n_idx] CSR) and used
      as Sᵀ.

    Matches ``sparse_times_plink(transS, transC, ...)``
    (5codesAPI.c:135-157); no centering (the reference path has none).
    ``precision`` defaults to "f32" (all 24 bits of S, ~1e-7 relative)
    because the reference's sparseTGeno kernel accumulates in exact double
    (plinkUint.cc:352-479); "fast" (bf16-split) and "f64" (exact int8
    digits, float64 recombination) are also accepted.

    ``method``: "dense" forces the packed-matmul path (densified S), "segsum" the
    O(nnz) gather path (:func:`sparse_times_geno_segsum`; f32
    accumulation), "auto" picks segsum once densifying S would dominate
    (n_idx beyond a few thousand — pedigree incidence scale) — but only
    at the default precision="f32": an explicit "fast"/"f64" request
    keeps the dense path, and method="segsum" with a non-f32 tier raises.
    """
    tg = trans_geno.lower()
    ts = trans_sparse.lower()
    # the segsum path accumulates in f32 scatter-adds: 'auto' only takes
    # it at the default tier (an explicit f64/fast request stays on the
    # dense path — silently downgrading the tier would betray the
    # precision contract), and an explicit method='segsum' with a
    # different tier is a contradiction worth an error
    if method == "segsum" and precision != "f32":
        raise ValueError(
            f"precision={precision!r} is not available on the segsum path "
            "(f32 scatter-add accumulation only); use method='dense' to "
            "keep the requested tier, or precision='f32'")
    if method == "segsum" or (method == "auto" and n_idx > 4096
                              and precision == "f32"):
        return sparse_times_geno_segsum(
            g, row_ptr, col_idx, vals, n_idx, trans_sparse=ts,
            trans_geno=tg, index_base=index_base)
    if tg == "n":
        contract, out_cols = g.indiv, g.snps
    else:
        contract, out_cols = g.snps, g.indiv

    if ts == "n":
        s = csr_to_dense(row_ptr, col_idx, vals, n_idx, contract, index_base)
        st = s.T  # [contract, n_idx]
    else:
        st = csr_to_dense(row_ptr, col_idx, vals, contract, n_idx, index_base)

    # Cᵀ = op(Z)ᵀ @ Sᵀ: the packed buffer whose ROWS are the product's
    # output axis and whose packed axis is `contract` is exactly the other
    # orientation — one packed matmul, then transpose.
    zq_other = g.zq_t if tg == "n" else g.zq_n
    if precision == "f64":
        from .dgemm import packed_matmul_f64

        out = packed_matmul_f64(zq_other, st)
        return out[:out_cols].T
    out = packed_matmul(zq_other, jnp.asarray(st, jnp.float32),
                        precision=precision)
    return out[:out_cols].T  # [n_idx, out_cols]
