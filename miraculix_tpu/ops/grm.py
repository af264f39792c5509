"""SNP-matrix crossproducts: M = Z Zᵀ (GRM) / M = Zᵀ Z (LD), exact in int32.

Replacement for the reference's popcount SIMD kernels
(src/miraculix/2bitIntern.h:31-160) and its 4-bit tensor-core CUTLASS path
with the custom mma.sync PTX microkernel (src/cuda/snp_multiply_cuda.h:
124-197, .cu:38-382).  Here: plain XLA.  The packing is decoded one K block
at a time to int8 and each block runs as one int8 x int8 -> int32 GEMM, the
block results summed in int32.  A crossproduct does 2·n operations per
decoded genotype (~42,000 at n = 21,000), so it is compute-bound even with
the decoded block passing through device memory, and the card's int8 GEMM
is its fast route.  Every product term is <= 4, so the int32 accumulator is
EXACT while 4*snps < 2^31, i.e. up to ~536M SNPs (the reference's int32
range discussion, docs/grm.md:12).

Finishing steps (all O(m^2), done in XLA):
- GRM (VanRaden, via the Schlather decomposition docs/grm.md:5-10 and
  src/bindings/Julia/crossproduct.jl:83-110):
      M -= (m·1ᵀ + 1·mᵀ)/n;  M += (Σm)/n²;  M /= 2 Σ p(1-p)
  with m = M·1 the column sums of the raw integer crossproduct.
- LD correlation r (crossproduct.jl:128-152; NB the reference's docstring
  claims R² but its computation — and its own test against `plink --r
  square`, tests/crossproduct/test_ld.jl — produce the signed r):
      M -= 4n·ffᵀ;  M /= σσᵀ with σ = sqrt(diag(M)).
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..geno import GenoMatrix
from .common import decode_planar16, pad_words

# Packed words per K block, read when traced: the decoded int8 block of a
# crossproduct holds rows x 16*CROSS_BLOCK_WORDS bytes (~0.7 GB at 21,000
# rows)
CROSS_BLOCK_WORDS = 2048


def _check_int32_exact(kw: int) -> None:
    if 4 * 16 * kw >= 2 ** 31:
        # int32 accumulator capacity (the analogue of the reference's f64
        # exactness guard snps*n^2*4 <= 2^52, haplogeno.cc:742-744)
        raise ValueError(
            f"{16 * kw} packed SNP columns could overflow the exact int32 "
            "accumulator (limit ~536M); chunk the SNP axis and sum partials")


def _blocked_gram(zq_a, zq_b):
    """Σ over K blocks of the int8 x int8 -> int32 product of the decoded
    a-block and b-block, for two packings with the same word axis;
    ``zq_b is zq_a`` decodes each block once."""
    same = zq_b is zq_a
    bw = min(CROSS_BLOCK_WORDS, zq_a.shape[1])
    zq_a = pad_words(zq_a, bw)
    zq_b = zq_a if same else pad_words(zq_b, bw)

    def step(t, acc):
        wa = jax.lax.dynamic_slice_in_dim(zq_a, t * bw, bw, axis=1)
        wb = wa if same else jax.lax.dynamic_slice_in_dim(
            zq_b, t * bw, bw, axis=1)
        return acc + _int8_block(wa, wb)

    return jax.lax.fori_loop(
        0, zq_a.shape[1] // bw, step,
        jnp.zeros((zq_a.shape[0], zq_b.shape[0]), jnp.int32))


def _int8_block(wa, wb):
    da = decode_planar16(wa, jnp.int8)
    db = da if wb is wa else decode_planar16(wb, jnp.int8)
    return jax.lax.dot_general(
        da, db, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32)


@jax.jit
def packed_crossprod(zq: jax.Array) -> jax.Array:
    """Raw integer crossproduct decode(zq) @ decode(zq)ᵀ -> int32
    [rows, rows], exact while 4*snps < 2^31 (see module docstring)."""
    _check_int32_exact(zq.shape[1])
    return _blocked_gram(zq, zq)


@jax.jit
def packed_crossprod_rect(zq_a: jax.Array, zq_b: jax.Array) -> jax.Array:
    """Rectangular integer crossproduct decode(zq_a) @ decode(zq_b)ᵀ ->
    int32 [rows_a, rows_b].  The off-diagonal GRM tile primitive for 2D
    distributed layouts (the reference's individual-pair tile loop,
    snp_multiply_cuda.cu:194-340, with tiles living on different cards) and
    the banded-LD block product."""
    if zq_a.shape[1] != zq_b.shape[1]:
        raise ValueError("packed K widths differ")
    _check_int32_exact(zq_a.shape[1])
    return _blocked_gram(zq_a, zq_b)


@jax.jit
def packed_crossprod_weighted(zq: jax.Array, w: jax.Array) -> jax.Array:
    """Per-SNP-weighted crossproduct decode(zq) @ diag(w) @ decode(zq)ᵀ ->
    f32 [rows, rows], f32 grade: the decoded genotypes are exact in f32 and
    each K block runs as one f32 GEMM at HIGHEST precision (a GPU would
    otherwise take it in TF32, ~1e-3), summed across blocks in f32.

    The engine of grm_yang's GCTA-definition GRM and of per-pair
    denominators: with ``w = 2pq`` on a called-indicator packing it yields
    plink --make-rel's pairwise Σ 2p_sq_s over co-called SNPs.  ``w``:
    [snps] (or up to [16*kw]) weights in natural SNP order; padded SNPs get
    weight 0."""
    rows, kw = zq.shape
    if w.ndim != 1 or w.shape[0] > 16 * kw:
        raise ValueError(f"w must be 1-D with <= {16 * kw} entries")
    bw = min(CROSS_BLOCK_WORDS, kw)
    kwp = -(-kw // bw) * bw
    wmat = jnp.zeros((16, kwp), jnp.float32).at[:, :kw].set(
        jnp.zeros((16 * kw,), jnp.float32).at[: w.shape[0]].set(
            w.astype(jnp.float32)).reshape(16, kw))

    def step(t, acc):
        words = jax.lax.dynamic_slice_in_dim(zqp, t * bw, bw, axis=1)
        wt = jax.lax.dynamic_slice_in_dim(wmat, t * bw, bw, axis=1)
        d = decode_planar16(words, jnp.float32)           # [rows, 16*bw]
        return acc + jax.lax.dot_general(
            d * wt.reshape(1, 16 * bw), d,
            dimension_numbers=(((1,), (1,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)

    zqp = pad_words(zq, bw)
    return jax.lax.fori_loop(0, kwp // bw, step,
                             jnp.zeros((rows, rows), jnp.float32))


def called_indicator_packing(g: GenoMatrix, use=None) -> jax.Array:
    """Planar16 packing of the CALLED indicator: 1 where the genotype was
    observed, 0 at missing entries, row/column padding, and (optionally)
    SNPs excluded by the boolean mask ``use``.  The indicator panel is a
    valid {0,1} genotype packing, so the exact int8 crossproduct machinery
    applies unchanged — ``packed_crossprod`` of it is the pairwise
    non-missing-count matrix (exact int32), the denominator GCTA/PLINK use
    per pair (reference missingness semantics anchor:
    Vector.matrix.D.cc:179-208)."""
    import numpy as np

    ipad, kw = g.zq_n.shape
    n, snps = g.indiv, g.snps
    valid = (np.arange(16)[:, None] * kw + np.arange(kw)[None, :]) < snps
    if use is not None:
        use = np.asarray(use, bool)
        if use.shape[0] != snps:
            raise ValueError(f"use mask has {use.shape[0]} entries for "
                             f"{snps} SNPs")
        upad = np.zeros(16 * kw, bool)
        upad[:snps] = use
        valid = valid & upad.reshape(16, kw)
    word = (valid.astype(np.uint64)
            << (2 * np.arange(16, dtype=np.uint64))[:, None]).sum(
        axis=0).astype(np.uint32)
    arr = np.zeros((ipad, kw), np.uint32)
    arr[:n] = word[None, :]
    if g.miss_rows_n is not None and g.miss_rows_n.shape[0]:
        mi = np.asarray(g.miss_rows_n, np.int64)
        ms = np.asarray(g.miss_cols_n, np.int64)
        masks = (~(np.uint32(1) << (2 * (ms // kw)).astype(np.uint32))
                 ).astype(np.uint32)
        np.bitwise_and.at(arr, (mi, ms % kw), masks)
    return jnp.asarray(arr)


def pairwise_nonmissing(
    g: GenoMatrix,
    use=None,
) -> jax.Array:
    """Pairwise non-missing SNP counts N[i, j] = #{s: called in both i and
    j (and use[s])} as exact int32 [indiv, indiv] — one int8 crossproduct
    of the called-indicator packing."""
    ind = called_indicator_packing(g, use=use)
    return packed_crossprod(ind)[
        : g.indiv, : g.indiv]


def snp_crossprod(
    g: GenoMatrix,
    snpmajor_output: bool = False,
) -> jax.Array:
    """Integer crossproduct (reference snp_multiply_gpu,
    src/cuda/snp_multiply_cuda.cu:38-382).

    snpmajor_output=False -> M = Z Zᵀ, [indiv, indiv] (GRM direction)
    snpmajor_output=True  -> M = Zᵀ Z, [snps, snps]   (LD direction)
    """
    if snpmajor_output:
        m = packed_crossprod(g.zq_t)
        return m[: g.snps, : g.snps]
    m = packed_crossprod(g.zq_n)
    return m[: g.indiv, : g.indiv]


def _missing_d_csr(g):
    """The exact "add-back" matrix D for missing genotypes: D[i, s] = 2f_s
    at each recorded missing coordinate.  A missing entry was packed as 0
    and centering subtracted 2f_s, so its centered value is -2f_s; the
    reference semantics (Missings list corrections,
    src/miraculix/Vector.matrix.D.cc:179-208) make it contribute 0 — i.e.
    the exact centered matrix is Zc + D.  Returns 1-based CSR of D plus
    d2[i] = (D · 2f)[i]."""
    import numpy as np

    mi = np.asarray(g.miss_rows_n, np.int64)
    ms = np.asarray(g.miss_cols_n, np.int64)
    f = np.asarray(g.freq, np.float64)
    order = np.argsort(mi, kind="stable")
    mi, ms = mi[order], ms[order]
    w = 2.0 * f[ms]
    ia = np.concatenate([[0], np.cumsum(np.bincount(mi, minlength=g.indiv))]) + 1
    d2 = np.zeros(g.indiv)
    np.add.at(d2, mi, w * 2.0 * f[ms])
    return ia, ms + 1, w, d2, (mi, ms)


def _ddt_dense(rows, cols, w, n_rows, n_cols):
    """(sparse D) @ (sparse D)ᵀ as a dense [n_rows, n_rows] array (host;
    nnz = #missing entries, so this is cheap at realistic missing rates)."""
    import numpy as np
    from scipy import sparse

    d = sparse.csr_matrix((w, (rows, cols)), shape=(n_rows, n_cols))
    return np.asarray((d @ d.T).todense())


def grm(
    g: GenoMatrix,
    scale: bool = True,
    dtype=jnp.float32,
    correct_missing: Optional[bool] = None,
    pair_denominator: bool = False,
) -> jax.Array:
    """VanRaden genomic relationship matrix via the Schlather decomposition
    (docs/grm.md:5-10; Julia finish crossproduct.jl:91-107).

    ``correct_missing``: apply the exact missing-genotype correction from
    the recorded missing index lists (reference Missings semantics,
    Vector.matrix.D.cc:179-208) — each missing entry then contributes
    exactly 0 to the centered product (mean imputation), instead of the
    -2f_s bias the raw packed 0 leaves behind.  Default: on whenever the
    panel carries missing info (``from_dense(..., keep_missing_info=True)``).

    ``pair_denominator``: plink --make-rel missingness semantics — scale
    each PAIR by its own Σ 2p_sq_s over the SNPs called in BOTH members
    (one weighted crossproduct of the called-indicator packing), instead
    of the global 2Σp(1-p).  Requires missing info (exact numerator);
    implies ``correct_missing`` and ignores ``scale``.  Pairs sharing no
    called SNPs come back 0.
    """
    n = g.indiv
    m = snp_crossprod(g, snpmajor_output=False)
    m = m.astype(dtype)
    if pair_denominator:
        if g.miss_rows_n is None:
            raise ValueError("pair_denominator requires a panel built with "
                             "keep_missing_info=True")
        correct_missing = True
    if correct_missing is None:
        correct_missing = g.miss_rows_n is not None
    if correct_missing and g.miss_rows_n is None:
        raise ValueError("correct_missing requires a panel built with "
                         "keep_missing_info=True")
    if correct_missing:
        from .dgemm import dgemm
        from .sparse import sparse_times_geno

        f = g.freq.astype(dtype)
        # exact centering by 2f (the Schlather colsum identity assumes no
        # missing): Zc Zcᵀ = ZZᵀ - u1ᵀ - 1uᵀ + (4Σf²)11ᵀ, u = Z(2f)
        u = dgemm(g, 2.0 * g.freq[:, None], trans="n", center=False,
                  precision="f32")[:, 0].astype(dtype)
        m = m - u[None, :] - u[:, None] + 4.0 * jnp.sum(f * f)
        ia, ja, w, d2, (mi, ms) = _missing_d_csr(g)
        a = sparse_times_geno(
            g, ia, ja, w, g.indiv, trans_geno="t",
            precision="f32")  # D Zᵀ [indiv, indiv]
        a = a.astype(dtype) - jnp.asarray(d2, dtype)[:, None]  # D Zcᵀ
        ddt = jnp.asarray(_ddt_dense(mi, ms, w, g.indiv, g.snps), dtype)
        m = m + a + a.T + ddt
    else:
        colsum = jnp.sum(m, axis=1)
        total = jnp.sum(colsum)
        m = m - colsum[None, :] / n - colsum[:, None] / n + total / (n * n)
    if pair_denominator:
        f32 = g.freq.astype(jnp.float32)
        denom = packed_crossprod_weighted(
            called_indicator_packing(g), 2.0 * f32 * (1.0 - f32))[:n, :n]
        return jnp.where(denom > 0, m / jnp.maximum(denom, 1e-30).astype(
            dtype), 0.0)
    if scale:
        m = m / g.sigma2.astype(dtype)
    return m


def ld(
    g: GenoMatrix,
    dtype=jnp.float32,
    squared: bool = False,
    correct_missing: Optional[bool] = None,
) -> jax.Array:
    """LD matrix: centered SNP-SNP correlation r of allele counts
    (reference crossproduct.jl:128-152, validated against `plink --r`).
    ``squared=True`` returns r² (the LD-pruning statistic).

    ``correct_missing`` mirrors :func:`grm`: with the recorded missing
    lists, the centered crossproduct becomes exactly (Zc + D)ᵀ(Zc + D)
    (missing entries contribute 0 — mean imputation), which also makes the
    diagonal an exact non-negative variance.  Default: on whenever the
    panel carries missing info.
    """
    n = g.indiv
    m = snp_crossprod(g, snpmajor_output=True)
    m = m.astype(dtype)
    f = g.freq.astype(dtype)
    if correct_missing is None:
        correct_missing = g.miss_rows_n is not None
    if correct_missing and g.miss_rows_n is None:
        raise ValueError("correct_missing requires a panel built with "
                         "keep_missing_info=True")
    if not correct_missing:
        # no-missing identity: column sums of Z equal 2nf
        m = m - (4.0 * n) * f[:, None] * f[None, :]
    else:
        from .sparse import sparse_times_geno

        # exact centering by 2f with missing packed as 0:
        # ZcᵀZc = ZᵀZ - (2f)sᵀ - s(2f)ᵀ + 4n ffᵀ,  s = Zᵀ1 (snp sums)
        s = g.snp_sums().astype(dtype)
        m = (m - (2.0 * f)[:, None] * s[None, :]
             - s[:, None] * (2.0 * f)[None, :]
             + (4.0 * n) * f[:, None] * f[None, :])
        ia, ja, w, _, (mi, ms) = _missing_d_csr(g)
        # Dᵀ Zc = Dᵀ Z - (Dᵀ1)(2f)ᵀ; CSR of Dᵀ grouped by SNP:
        import numpy as np

        order = np.argsort(ms, kind="stable")
        mi_s, ms_s = mi[order], ms[order]
        w_s = 2.0 * np.asarray(g.freq, np.float64)[ms_s]
        ia_t = np.concatenate(
            [[0], np.cumsum(np.bincount(ms_s, minlength=g.snps))]) + 1
        a = sparse_times_geno(
            g, ia_t, mi_s + 1, w_s, g.snps, trans_geno="n",
            precision="f32")  # Dᵀ Z [snps, snps]
        colsum_d = jnp.asarray(
            np.bincount(ms, weights=w, minlength=g.snps), dtype)
        a = a.astype(dtype) - colsum_d[:, None] * (2.0 * f)[None, :]
        dtd = jnp.asarray(_ddt_dense(ms, mi, w, g.snps, g.indiv), dtype)
        m = m + a + a.T + dtd
    # guard degenerate SNPs: monomorphic (zero variance) or, on uncorrected
    # missing-heavy panels, a slightly negative diagonal (freq excludes
    # missing while the crossproduct counted them as 0) — divide by 1
    # there instead of emitting NaN rows.
    diag = jnp.maximum(jnp.diagonal(m), 0.0)
    sigma = jnp.where(diag > 0, jnp.sqrt(diag), 1.0)
    m = m / sigma[:, None] / sigma[None, :]
    return m * m if squared else m


def missing_indicator_packing_t(g: GenoMatrix, row0: int = 0,
                                rows_out: Optional[int] = None
                                ) -> "np.ndarray":
    """Planar16 packing (SNP-major orientation, like ``zq_t``) of the
    MISSING indicator: 1 exactly at recorded missing coordinates.  Rect
    crossproducts of this packing against ``zq_t`` give the per-pair sums
    Σ_{i∈miss(s)} z_ic — every term of the exact banded-LD missing
    correction — as exact int32 on the same crossproduct (host numpy).

    ``row0``/``rows_out`` restrict to SNP rows [row0, row0+rows_out) (zero
    rows past the panel), so blocked callers build only their tile's slice
    instead of a second full-size transposed packing — at 1M SNPs x 100K
    individuals the full array is ~25 GB host RAM for possibly one missing
    call."""
    import numpy as np

    spad, kwi = g.zq_t.shape
    nrows = (spad - row0) if rows_out is None else rows_out
    arr = np.zeros((nrows, kwi), np.uint32)
    if g.miss_rows_n is not None and g.miss_rows_n.shape[0]:
        mi = np.asarray(g.miss_rows_n, np.int64)
        ms = np.asarray(g.miss_cols_n, np.int64)
        sel = (ms >= row0) & (ms < row0 + nrows)
        if sel.any():
            np.bitwise_or.at(
                arr, (ms[sel] - row0, mi[sel] % kwi),
                (np.uint32(1) << (2 * (mi[sel] // kwi)).astype(np.uint32)))
    return arr


@functools.partial(jax.jit, static_argnames=("window", "rb", "n"))
def _ld_band_block(zi, zj, fr, fc_pad, sig_r, sig_pad, *, window, rb, n):
    """One banded-LD row block entirely ON DEVICE (no-missing path): rect
    int8 crossproduct -> rank-1 centering -> diagonal-band gather ->
    sigma normalization, returning just the [rb, window] f32 band.

    A host pipeline would fetch the full [rb, rb+wb] int32 tile and do f64
    centering + a stride-trick gather on the host — ~75 MB of D2H plus
    ~300 MB of host traffic PER BLOCK at rb = 4096.  On device only the
    8 MB band transfers."""
    m = packed_crossprod_rect(zi, zj).astype(
        jnp.float32)
    m = m - (4.0 * n) * fr[:, None] * fc_pad[None, :]
    idx = (jnp.arange(rb)[:, None] + 1
           + jnp.arange(window)[None, :])          # partner offset in block
    band = jnp.take_along_axis(m, idx, axis=1)
    band = band / (sig_r[:, None] * sig_pad[idx])
    return band


@functools.partial(jax.jit, static_argnames=("window", "rb", "n", "snps",
                                             "adjusted"))
def _ld_score_block(zi, zj, fr, fc_pad, sig_r, sig_pad, code_pad, r0, *,
                    window, rb, n, snps, adjusted):
    """One LD-score row block ON DEVICE: banded r (as _ld_band_block),
    square, GCTA adjustment, validity/chromosome masking, and BOTH
    accumulation directions — only two small vectors ([rb] outgoing sums,
    [rb+window] incoming partner contributions) ever leave the chip,
    instead of the whole [rb, window] band."""
    m = packed_crossprod_rect(zi, zj).astype(
        jnp.float32)
    m = m - (4.0 * n) * fr[:, None] * fc_pad[None, :]
    lidx = (jnp.arange(rb)[:, None] + 1
            + jnp.arange(window)[None, :])         # local partner index
    band = jnp.take_along_axis(m, lidx, axis=1)
    band = band / (sig_r[:, None] * sig_pad[lidx])
    r2 = band * band
    if adjusted:
        r2 = r2 - (1.0 - r2) / jnp.float32(n - 2)
    gpartner = r0 + lidx                           # global partner index
    valid = gpartner < snps
    valid &= code_pad[:rb, None] == code_pad[lidx]
    r2 = jnp.where(valid, r2, 0.0)
    row = jnp.sum(r2, axis=1)                      # outgoing, SNP r0+s
    inc = jnp.zeros((rb + window,), jnp.float32).at[lidx.reshape(-1)].add(
        r2.reshape(-1))                            # incoming, SNP r0+j
    return row, inc


@functools.partial(jax.jit, static_argnames=("window", "rb", "n", "snps"))
def _ld_mask_block(zi, zj, fr, fc_pad, sig_r, sig_pad, code_pad, r0, thr, *,
                   window, rb, n, snps):
    """One LD-prune row block ON DEVICE: banded r², thresholded and
    validity/chromosome-masked on chip — only the uint8 offender mask
    transfers (4x less than the float band; see mx_ld_prune_mask)."""
    m = packed_crossprod_rect(zi, zj).astype(
        jnp.float32)
    m = m - (4.0 * n) * fr[:, None] * fc_pad[None, :]
    lidx = (jnp.arange(rb)[:, None] + 1
            + jnp.arange(window)[None, :])
    band = jnp.take_along_axis(m, lidx, axis=1)
    band = band / (sig_r[:, None] * sig_pad[lidx])
    gpartner = r0 + lidx
    valid = gpartner < snps
    valid &= code_pad[:rb, None] == code_pad[lidx]
    return (valid & (band * band > thr)).astype(jnp.uint8)


def ld_windowed(
    g: GenoMatrix,
    window: int,
    row_block: int = 4096,
    squared: bool = False,
    out: Optional["np.ndarray"] = None,
    chrom=None,
    correct_missing: Optional[bool] = None,
):
    """Banded LD: ``out[s, d]`` = r(SNP ``s``, SNP ``s+d+1``) for
    d in [0, window) — the LD-PRUNING shape.  O(snps x window) memory where
    the full r matrix is O(snps²) (4 TB at 1M SNPs vs 4 GB at window=1024);
    entries whose partner runs past the panel are 0.

    ``chrom`` (per-SNP labels, any dtype): entries whose pair spans a
    chromosome boundary are zeroed — plink/gcta window per chromosome, and
    cross-chromosome r is sampling noise that would otherwise leak into LD
    scores and pruning decisions.

    Device work per row block: ONE rectangular int8 crossproduct of the
    block's transposed packing against the block+window row range — the
    same exact-integer kernel as :func:`ld`, with the variance diagonal
    from the one-pass packed row stats (no full crossproduct needed).

    ``correct_missing`` (default: on when the panel carries missing index
    lists) applies the EXACT missing correction of :func:`ld` restricted
    to the band: every correction term is itself a rect crossproduct of
    the missing-indicator packing (Σ_{i∈miss(s)} z_ic etc.), so the
    correction rides the same int8 crossproduct — up to 3 extra rect passes
    per row block, and only over blocks that actually contain missing
    entries.  Without it, missing genotypes contribute the packed-0 bias
    (frequency excludes missing; no correction term).

    Out-of-core: pass a HOST-resident panel (``from_bed(path,
    device_put=False)``) — row blocks transfer H2D per step, so the packed
    panel never needs to fit HBM.
    """
    import numpy as np

    from .common import packed_row_sq_stats

    zq = g.zq_t
    snps, n = g.snps, g.indiv
    if window < 1:
        raise ValueError("window must be >= 1")
    if correct_missing is None:
        correct_missing = (g.miss_rows_n is not None
                           and g.miss_rows_n.shape[0] > 0)
    if correct_missing and g.miss_rows_n is None:
        raise ValueError("correct_missing requires a panel built with "
                         "keep_missing_info=True")
    rb = max(512, (row_block // 512) * 512)
    wb = -(-window // 512) * 512          # padded window for tiling
    nb = -(-snps // rb)
    if chrom is not None:
        chrom = np.asarray(chrom)
        if chrom.shape[0] != snps:
            raise ValueError(f"chrom has {chrom.shape[0]} labels for "
                             f"{snps} SNPs")
    if out is None:
        out = np.zeros((snps, window), dtype=np.float32)
    f = np.asarray(g.freq, dtype=np.float64)
    zsq = np.asarray(jax.jit(packed_row_sq_stats)(zq), np.float64)[:snps]
    if correct_missing:
        # exact corrected variance: Σ_{called} (z - 2f)² =
        # Σz² - 4f·s + 4f²·(n - missing_count)
        ssum = np.asarray(g.snp_sums(), np.float64)[:snps]
        mc = np.bincount(np.asarray(g.miss_cols_n, np.int64),
                         minlength=snps).astype(np.float64)
        var = zsq - 4.0 * f * ssum + 4.0 * f * f * (n - mc)
        # which row blocks contain any missing entry (skip clean blocks);
        # indicator packings are built PER BLOCK below — a full-size
        # second packing doubled host RAM on out-of-core panels
        blk_has_miss = np.bincount(
            np.asarray(g.miss_cols_n, np.int64) // rb, minlength=nb) > 0
    else:
        # no-missing identity: variance = Σz² - 4 n f²
        var = zsq - 4.0 * n * f * f
    sigma = np.where(var > 0, np.sqrt(var), 1.0)

    rows_pad = zq.shape[0]

    def rows(a0, a1, src=None):
        src = zq if src is None else src
        sl = src[a0:min(a1, rows_pad)]
        if sl.shape[0] == a1 - a0:
            return jnp.asarray(sl)
        return jnp.zeros((a1 - a0, src.shape[1]),
                         src.dtype).at[: sl.shape[0]].set(jnp.asarray(sl))

    # sigma padded to the block's partner range, 1.0 past the panel so
    # the device division is a no-op there (validity masks kill those
    # entries); frequencies padded 0 past the panel
    sig_full = np.ones(snps + rb + wb, np.float64)
    sig_full[:snps] = sigma
    f_full = np.zeros(snps + rb + wb, np.float64)
    f_full[:snps] = f

    for i in range(nb):
        r0, r1 = i * rb, min((i + 1) * rb, snps)
        nrow = r1 - r0
        zi = rows(r0, r0 + rb)
        zj = rows(r0, r0 + rb + wb)
        if not correct_missing:
            # whole block on device: only the [rb, window] band transfers
            band = np.asarray(_ld_band_block(
                zi, zj,
                jnp.asarray(f_full[r0: r0 + rb], jnp.float32),
                jnp.asarray(f_full[r0: r0 + rb + wb], jnp.float32),
                jnp.asarray(sig_full[r0: r0 + rb], jnp.float32),
                jnp.asarray(sig_full[r0: r0 + rb + wb], jnp.float32),
                window=window, rb=rb, n=n),
                np.float64)[:nrow]
            partner = np.minimum(r0 + np.arange(nrow)[:, None] + 1
                                 + np.arange(window)[None, :], snps - 1)
            valid = (r0 + np.arange(nrow)[:, None] + 1
                     + np.arange(window)[None, :]) < snps
            if chrom is not None:
                valid &= chrom[partner] == chrom[r0:r1][:, None]
            out[r0:r1] = np.where(valid, band, 0.0).astype(np.float32)
            continue
        # missing-corrected path: host f64 (exactness-critical corrections;
        # rarer post-QC — the common no-missing path above never leaves
        # the device)
        tile = np.asarray(packed_crossprod_rect(
            zi, zj)).astype(np.float64)
        tile = tile[:nrow]
        c1 = min(r0 + rb + window, snps) - r0   # valid partner columns
        tile[:, c1:] = 0.0
        # exact centered band (derivation: Zc = Z - 1(2f)ᵀ + D):
        #   raw - 2f_c·s_s - 2f_s·s_c + 4 f_s f_c (n - mc_s - mc_c + mm)
        #       + 2f_s·Σ_{i∈miss(s)} z_ic + 2f_c·Σ_{i∈miss(c)} z_is
        # (f_s multiplies the miss(s) sum: D's nonzeros are 2f_s at
        # row s's missing entries — matches the code and ld()'s D-CSR)
        fr, fc = f[r0:r1], f[r0: r0 + c1]
        sr, sc = ssum[r0:r1], ssum[r0: r0 + c1]
        mcr, mcc = mc[r0:r1], mc[r0: r0 + c1]
        rmiss = blk_has_miss[i]
        cmiss = (mc[r0: r0 + c1] > 0).any()
        mzr = mzc = mmrc = 0.0
        if rmiss or cmiss:
            mi_j = jnp.asarray(
                missing_indicator_packing_t(g, r0, rb + wb))
            mi_i = mi_j[:rb]    # the row block IS the band's head
        if rmiss:
            mzr = np.asarray(packed_crossprod_rect(
                mi_i, zj))[:nrow, :c1].astype(
                np.float64)
        if cmiss:
            mzc = np.asarray(packed_crossprod_rect(
                zi, mi_j))[:nrow, :c1].astype(
                np.float64)
        if rmiss and cmiss:
            mmrc = np.asarray(packed_crossprod_rect(
                mi_i, mi_j))[:nrow, :c1].astype(
                np.float64)
        tile[:, :c1] = (
            tile[:, :c1]
            - 2.0 * fc[None, :] * sr[:, None]
            - 2.0 * fr[:, None] * sc[None, :]
            + 4.0 * np.outer(fr, fc)
            * (n - mcr[:, None] - mcc[None, :] + mmrc)
            + 2.0 * fr[:, None] * mzr
            + 2.0 * fc[None, :] * mzc
        )
        # band extraction: row k pairs with columns k+1 .. k+window
        sw = np.lib.stride_tricks.sliding_window_view(
            tile, window, axis=1)  # [nrow, width-window+1, window]
        band = sw[np.arange(nrow), np.arange(nrow) + 1]
        partner = np.minimum(r0 + np.arange(nrow)[:, None] + 1
                             + np.arange(window)[None, :], snps - 1)
        band = band / (sigma[r0:r1][:, None] * sigma[partner])
        valid = (r0 + np.arange(nrow)[:, None] + 1
                 + np.arange(window)[None, :]) < snps
        if chrom is not None:
            valid &= chrom[partner] == chrom[r0:r1][:, None]
        out[r0:r1] = np.where(valid, band, 0.0).astype(np.float32)
    if squared:
        np.square(out, out=out)
    return out


def ld_score(
    g: GenoMatrix,
    window: int = 512,
    row_block: int = 4096,
    adjusted: bool = True,
    chrom=None,
    correct_missing: Optional[bool] = None,
):
    """Per-SNP LD score: 1 + Σ r² over all partners within ``window``
    positions (both directions) — the gcta64 ``--ld-score`` statistic the
    reference's benchmark suite runs as a comparator
    (utils/benchmark/benchmark_suite.jl:230-273), the input of LD-score
    regression.  ``adjusted`` applies GCTA's small-sample correction
    r²_adj = r² − (1 − r²)/(n − 2) to every real pair.

    ``chrom`` (per-SNP labels): pairs spanning a chromosome boundary never
    contribute — gcta windows per chromosome, and with ``adjusted=False``
    the raw r² of ~window unlinked cross-chromosome pairs would inflate
    boundary SNPs' scores by about window/(n-2).

    Runs off the banded r of :func:`ld_windowed` (O(snps·window) memory and
    device work), so it streams panels whose full LD matrix never fits.
    Returns float64 [snps].
    """
    import numpy as np

    from .common import packed_row_sq_stats

    snps, n = g.snps, g.indiv
    window = min(window, max(snps - 1, 1))
    if correct_missing is None:
        correct_missing = (g.miss_rows_n is not None
                           and g.miss_rows_n.shape[0] > 0)
    if not correct_missing:
        # fully device-side per block: r, r², adjustment, masking, and
        # BOTH accumulation directions on the device — only [rb] +
        # [rb+window] vectors transfer per block, not the whole band (see
        # _ld_score_block)
        if adjusted and n < 3:
            raise ValueError("adjusted LD scores need >= 3 individuals")
        zq = g.zq_t
        rb = max(512, (row_block // 512) * 512)
        wb = -(-window // 512) * 512
        nb = -(-snps // rb)
        f = np.asarray(g.freq, dtype=np.float64)
        zsq = np.asarray(jax.jit(packed_row_sq_stats)(zq),
                         np.float64)[:snps]
        var = zsq - 4.0 * n * f * f
        sigma = np.where(var > 0, np.sqrt(var), 1.0)
        sig_full = np.ones(snps + rb + wb, np.float64)
        sig_full[:snps] = sigma
        f_full = np.zeros(snps + rb + wb, np.float64)
        f_full[:snps] = f
        if chrom is None:
            codes = np.zeros(snps, np.int32)
        else:
            ch = np.asarray(chrom)
            if ch.shape[0] != snps:
                raise ValueError(f"chrom has {ch.shape[0]} labels for "
                                 f"{snps} SNPs")
            codes = np.unique(ch, return_inverse=True)[1].astype(np.int32)
        code_full = np.full(snps + rb + wb, -1, np.int32)
        code_full[:snps] = codes
        rows_pad = zq.shape[0]

        def rows(a0, a1):
            sl = zq[a0:min(a1, rows_pad)]
            if sl.shape[0] == a1 - a0:
                return jnp.asarray(sl)
            return jnp.zeros((a1 - a0, zq.shape[1]),
                             zq.dtype).at[: sl.shape[0]].set(jnp.asarray(sl))

        score = np.ones(snps, np.float64)
        for i in range(nb):
            r0, r1 = i * rb, min((i + 1) * rb, snps)
            nrow = r1 - r0
            row, inc = _ld_score_block(
                rows(r0, r0 + rb), rows(r0, r0 + rb + wb),
                jnp.asarray(f_full[r0: r0 + rb], jnp.float32),
                jnp.asarray(f_full[r0: r0 + rb + wb], jnp.float32),
                jnp.asarray(sig_full[r0: r0 + rb], jnp.float32),
                jnp.asarray(sig_full[r0: r0 + rb + wb], jnp.float32),
                jnp.asarray(code_full[r0: r0 + rb + wb]),
                jnp.int32(r0), window=window, rb=rb, n=n, snps=snps,
                adjusted=adjusted)
            score[r0:r1] += np.asarray(row, np.float64)[:nrow]
            lim = min(r0 + rb + window, snps)
            score[r0:lim] += np.asarray(inc, np.float64)[: lim - r0]
        return score

    band = ld_windowed(g, window, row_block=row_block, squared=True,
                       chrom=chrom, correct_missing=correct_missing)
    if adjusted:
        if n < 3:
            raise ValueError("adjusted LD scores need >= 3 individuals")
        # in place on the f32 band (O(snps*window) is the whole footprint);
        # out-of-panel (and cross-chromosome) partners must stay exactly 0
        band -= (1.0 - band) / np.float32(n - 2)
        # column-at-a-time re-zeroing (out-of-panel + cross-chromosome
        # pairs): O(snps) extra memory per offset — a full [snps, window]
        # partner-index matrix tripled peak RAM on exactly the
        # out-of-core panels this banded path exists for
        ch = None if chrom is None else np.asarray(chrom)
        for d in range(window):
            lim = max(snps - d - 1, 0)
            band[lim:, d] = 0.0
            if ch is not None and lim > 0:
                band[:lim, d][ch[:lim] != ch[d + 1: d + 1 + lim]] = 0.0
    score = 1.0 + band.sum(axis=1, dtype=np.float64)
    for d in range(window):  # incoming pairs: band[s-d-1, d] contributes to s
        score[d + 1:] += band[: snps - d - 1, d]
    return score


def ld_prune(
    g: GenoMatrix,
    window: int = 512,
    r2_threshold: float = 0.2,
    row_block: int = 4096,
    chrom=None,
    correct_missing: Optional[bool] = None,
):
    """Greedy pairwise LD pruning (the `plink --indep-pairwise` workflow):
    scan SNPs left to right; for every still-kept pair within ``window``
    whose r² exceeds ``r2_threshold``, drop the member with the LOWER MAF
    (ties drop the later SNP).  Returns a boolean keep-mask [snps].

    ``chrom`` (per-SNP labels, any dtype): pairs spanning a chromosome
    boundary are never pruning candidates — plink windows per chromosome,
    and cross-chromosome r² is sampling noise at small n.

    Runs off the banded r² of :func:`ld_windowed` (O(snps x window) device
    work + memory), so it scales to panels whose full LD matrix could
    never be formed.  The greedy scan itself runs in the native codec
    (mx_ld_prune: one tight pass over the float band — minutes-to-seconds
    at 1M SNPs where the Python loop paid per-SNP interpreter overhead);
    the Python loop below is the fallback and the semantics oracle
    (test_ld_prune_native_matches_python).
    """
    import numpy as np

    from ..io import native as _native

    snps, n = g.snps, g.indiv
    f = np.asarray(g.freq, np.float64)
    maf = np.minimum(f, 1.0 - f)
    if correct_missing is None:
        correct_missing = (g.miss_rows_n is not None
                           and g.miss_rows_n.shape[0] > 0)
    if not correct_missing:
        # device-thresholded fast path (round 5): each row block computes
        # the banded r² AND the `> threshold` comparison on chip, so only
        # a uint8 offender mask crosses to the host (4x less transfer
        # than the float band — which dominated the 1M-SNP wall)
        from .common import packed_row_sq_stats

        window_c = min(window, max(snps - 1, 1))
        zq = g.zq_t
        rb = max(512, (row_block // 512) * 512)
        wb = -(-window_c // 512) * 512
        nb = -(-snps // rb)
        zsq = np.asarray(jax.jit(packed_row_sq_stats)(zq),
                         np.float64)[:snps]
        var = zsq - 4.0 * n * f * f
        sigma = np.where(var > 0, np.sqrt(var), 1.0)
        sig_full = np.ones(snps + rb + wb, np.float64)
        sig_full[:snps] = sigma
        f_full = np.zeros(snps + rb + wb, np.float64)
        f_full[:snps] = f
        if chrom is None:
            codes = np.zeros(snps, np.int32)
        else:
            ch = np.asarray(chrom)
            if ch.shape[0] != snps:
                raise ValueError(f"chrom has {ch.shape[0]} labels for "
                                 f"{snps} SNPs")
            codes = np.unique(ch, return_inverse=True)[1].astype(np.int32)
        code_full = np.full(snps + rb + wb, -1, np.int32)
        code_full[:snps] = codes
        rows_pad = zq.shape[0]

        def rows_of(a0, a1):
            sl = zq[a0:min(a1, rows_pad)]
            if sl.shape[0] == a1 - a0:
                return jnp.asarray(sl)
            return jnp.zeros((a1 - a0, zq.shape[1]),
                             zq.dtype).at[: sl.shape[0]].set(jnp.asarray(sl))

        offend = np.empty((snps, window_c), np.uint8)
        for i in range(nb):
            r0, r1 = i * rb, min((i + 1) * rb, snps)
            blk = _ld_mask_block(
                rows_of(r0, r0 + rb), rows_of(r0, r0 + rb + wb),
                jnp.asarray(f_full[r0: r0 + rb], jnp.float32),
                jnp.asarray(f_full[r0: r0 + rb + wb], jnp.float32),
                jnp.asarray(sig_full[r0: r0 + rb], jnp.float32),
                jnp.asarray(sig_full[r0: r0 + rb + wb], jnp.float32),
                jnp.asarray(code_full[r0: r0 + rb + wb]),
                jnp.int32(r0), jnp.float32(r2_threshold),
                window=window_c, rb=rb, n=n, snps=snps)
            offend[r0:r1] = np.asarray(blk)[: r1 - r0]
        native_keep = _native.ld_prune_mask(offend, maf)
        if native_keep is not None:
            return native_keep
        return _ld_prune_greedy(offend > 0, maf, snps, window_c)

    band2 = ld_windowed(g, window=window, row_block=row_block, squared=True,
                        chrom=chrom, correct_missing=correct_missing)
    native_keep = _native.ld_prune(band2, maf, r2_threshold)
    if native_keep is not None:
        return native_keep
    return _ld_prune_greedy(band2 > r2_threshold, maf, snps, window)


def _ld_prune_greedy(offend: "np.ndarray", maf, snps: int, window: int):
    """Python greedy scan over a boolean offender band — the semantics
    oracle for both native scans (mx_ld_prune / mx_ld_prune_mask)."""
    import numpy as np

    keep = np.ones(snps, bool)
    for s in range(snps):
        if not keep[s]:
            continue
        hi = min(s + 1 + window, snps)
        part = np.arange(s + 1, hi)
        mask = keep[part] & offend[s, : hi - s - 1]
        if not mask.any():
            continue
        bad = part[mask]
        # drop the lower-MAF member of each offending pair
        drop_self = maf[s] < maf[bad]
        if drop_self.any():
            keep[s] = False
            # s is gone: its remaining pairs are moot
            keep[bad[~drop_self]] = False
            continue
        keep[bad] = False
    return keep


def _row_block_fn(zq, rb: int):
    """Row-block slicer for out-of-core loops: returns block i of ``rb``
    packed rows (device or host source), zero-padding a ragged last block."""
    def block(i):
        sl = zq[i * rb: (i + 1) * rb]
        if sl.shape[0] == rb:
            return jnp.asarray(sl)
        return jnp.zeros((rb, zq.shape[1]), jnp.uint32).at[: sl.shape[0]].set(
            jnp.asarray(sl))
    return block


def grm_blocked(
    source,
    row_block: int = 8192,
    scale: bool = True,
    out: Optional["np.ndarray"] = None,
):
    """Out-of-core GRM for panels whose relationship matrix (or packed
    [missing genotypes, if any, contribute -2f bias per entry here — the
    exact correction path lives in grm(); blocked sources carry no missing
    index lists]
    genotypes) exceed device HBM — the single-chip path for the reference's
    "large" simulated panels (e.g. 100K+ individuals,
    utils/genotype_simulation_plink/Makefile:1-9).

    The device computes one [row_block x row_block] integer crossproduct
    tile at a time over the full SNP axis (upper-triangle pairs only, like
    the reference's tile loop snp_multiply_cuda.cu:194-340, whose tiles it
    streams over CUDA streams); tiles accumulate into a HOST float32 matrix
    and the VanRaden finish runs on the host in float64.

    ``source``: a GenoMatrix (packed matrix fits HBM, only the GRM
    doesn't), a dense uint8 genotype matrix, or a .bed path (ingested via
    the fused native codec; only packed row blocks ever reach the device).
    Returns the [indiv, indiv] (scaled) GRM as host numpy float32.
    """
    import numpy as np

    from ..geno import GenoMatrix

    # -- resolve the source to (row-sliceable packed zq_n, indiv, snps, freq)
    if isinstance(source, GenoMatrix):
        zq, indiv, freq = source.zq_n, source.indiv, np.asarray(source.freq)
    else:
        if isinstance(source, str):
            from ..io import bed, codec as _codec
            from ..io import native as _nat

            payload, snps_, indiv = bed.read_bed_payload(source)
            ipad, kws = _codec.planar16_dims(indiv, snps_, row_mult=256)
            spad, kwi = _codec.planar16_dims(snps_, indiv, row_mult=256)
            nat = _nat.bed_ingest(payload, snps_, indiv, spad, kwi, ipad,
                                  kws, want_t=False, want_pfreq=False)
            if nat is not None:
                _, zq, freq, _ = nat  # host zq_n [ipad, kws]
            else:
                dense = _codec.plink_to_dense(
                    np.ascontiguousarray(payload.T), indiv)
                freq = _codec.allele_freq(dense)
                zq = _codec.pack_planar16(dense, row_mult=256)
        else:
            from ..io import codec as _codec

            dense = np.asarray(source, dtype=np.uint8)
            indiv = dense.shape[0]
            freq = _codec.allele_freq(dense)
            zq = _codec.pack_planar16(dense, row_mult=256)

    rows_pad = zq.shape[0]
    rb = max(512, (row_block // 512) * 512)
    nb = -(-rows_pad // rb)

    if out is None:
        out = np.zeros((indiv, indiv), dtype=np.float32)

    block = _row_block_fn(zq, rb)

    for i in range(nb):
        zi = block(i)
        r0, r1 = i * rb, min((i + 1) * rb, indiv)
        if r0 >= indiv:
            break
        for j in range(i, nb):
            c0, c1 = j * rb, min((j + 1) * rb, indiv)
            if c0 >= indiv:
                break
            zj = zi if j == i else block(j)
            tile = np.asarray(packed_crossprod_rect(
                zi, zj)).astype(np.float32)
            out[r0:r1, c0:c1] = tile[: r1 - r0, : c1 - c0]
            if j > i:
                out[c0:c1, r0:r1] = tile[: r1 - r0, : c1 - c0].T
    # VanRaden finish (Schlather decomposition, docs/grm.md:5-10), host f64
    n = indiv
    colsum = out.sum(axis=1, dtype=np.float64)
    total = colsum.sum()
    out -= (colsum[None, :] / n).astype(np.float32)
    out -= (colsum[:, None] / n).astype(np.float32)
    out += np.float32(total / (n * n))
    if scale:
        f = np.asarray(freq, dtype=np.float64)
        out /= np.float32(2.0 * np.sum(f * (1.0 - f)))
    return out


def ld_blocked(
    g: GenoMatrix,
    row_block: int = 8192,
    out: Optional["np.ndarray"] = None,
):
    """Out-of-core LD correlation (r) matrix: SNP x SNP tiles computed on
    device (rect int8 crossproducts of the transposed packing over the full
    individual axis), accumulated into a host float32 matrix — LD matrices
    outgrow HBM at ~60K SNPs.  Finish per crossproduct.jl:128-152."""
    import numpy as np

    zq = g.zq_t
    snps, n = g.snps, g.indiv
    rows_pad = zq.shape[0]
    rb = max(512, (row_block // 512) * 512)
    nb = -(-rows_pad // rb)

    if out is None:
        out = np.zeros((snps, snps), dtype=np.float32)
    f = np.asarray(g.freq, dtype=np.float64)

    block = _row_block_fn(zq, rb)

    for i in range(nb):
        r0, r1 = i * rb, min((i + 1) * rb, snps)
        if r0 >= snps:
            break
        zi = block(i)
        for j in range(i, nb):
            c0, c1 = j * rb, min((j + 1) * rb, snps)
            if c0 >= snps:
                break
            zj = zi if j == i else block(j)
            tile = np.asarray(packed_crossprod_rect(
                zi, zj)).astype(np.float64)
            tile = tile[: r1 - r0, : c1 - c0]
            tile -= (4.0 * n) * np.outer(f[r0:r1], f[c0:c1])
            out[r0:r1, c0:c1] = tile
            if j > i:
                out[c0:c1, r0:r1] = tile.T
    diag = np.maximum(np.diag(out).copy(), 0.0)  # see ld(): degenerate SNPs
    sigma = np.where(diag > 0, np.sqrt(diag), 1.0)
    out /= sigma[None, :]
    out /= sigma[:, None]
    return out


def dominance_grm(
    g,
    scale: bool = True,
    dtype=jnp.float32,
) -> jax.Array:
    """Genotypic dominance relationship matrix (Su et al. 2012, the GCTA
    ``--make-grm-d`` family):

        D = (H - hbar)(H - hbar)' / sum_s 2 p q (1 - 2 p q)

    with H the heterozygote indicator panel 1[z == 1] and p the additive
    allele frequencies.  Beyond-parity: the reference computes additive
    relationship matrices only (crossproduct.jl:83-110).  Because H is
    itself a valid {0, 1} genotype panel, the packed int8 crossprod
    machinery applies UNCHANGED: the het panel's own frequency cache is
    exactly hbar/2, so the standard 2f-centering produces (H - hbar).
    Missing genotypes are packed as 0, i.e. treated as non-het (mean
    imputation on the dominance scale).

    Accepts a dense genotype matrix or a GenoMatrix (decoded host-side
    once to build the het panel).
    """
    import numpy as np

    from ..geno import from_dense
    from ..io import codec

    if isinstance(g, GenoMatrix):
        dense = codec.unpack_planar16(np.asarray(g.zq_n), g.indiv, g.snps)
        p = np.asarray(g.freq, np.float64)
    else:
        dense = np.asarray(g, np.uint8)
        p = codec.allele_freq(dense, axis=0)
    het = (dense == 1).astype(np.uint8)
    hm = from_dense(het)
    d = grm(hm, scale=False, dtype=dtype)
    if scale:
        pq = 2.0 * p * (1.0 - p)
        denom = float(np.sum(pq * (1.0 - pq)))
        d = d / jnp.asarray(max(denom, 1e-30), dtype)
    return d


def grm_yang(
    g: GenoMatrix,
    block: int = 2048,          # kept for API compat (old dgemm-pair path)
    dtype=jnp.float32,
    pair_denominator: bool = False,
) -> jax.Array:
    """GCTA-default GRM (Yang et al. 2010): per-SNP standardization

        G_ij = (1/m) sum_s (z_is - 2 p_s)(z_js - 2 p_s) / (2 p_s q_s)

    — each SNP contributes unit variance, vs VanRaden's single global
    sum-of-variances normalization (:func:`grm`).  One weighted
    crossproduct pass (``packed_crossprod_weighted``: f32 products at
    HIGHEST precision) plus a rank-1 exact centering epilogue.
    Near-monomorphic SNPs
    (2pq ~ 0) are weighted 0, GCTA's behavior for excluded SNPs.

    Missing genotypes (panels built with ``keep_missing_info=True``) are
    handled EXACTLY: sparse correction terms make each missing entry
    contribute 0 to the weighted product (gcta's sum over called SNPs).
    ``pair_denominator=True`` completes gcta --make-grm interop: each
    pair divides by ITS OWN co-called SNP count (exact int8 crossproduct
    of the called-indicator packing) instead of the global m.  Semantics
    anchor: reference Vector.matrix.D.cc:179-208.
    """
    import numpy as np

    from .dgemm import dgemm

    n = g.indiv
    f = np.asarray(g.freq, np.float64)
    pq2 = 2.0 * f * (1.0 - f)
    use = pq2 > 1e-12
    m_used = int(use.sum())
    if pair_denominator and g.miss_rows_n is None:
        raise ValueError("pair_denominator requires a panel built with "
                         "keep_missing_info=True")
    denom_global = 1.0 if pair_denominator else float(max(m_used, 1))
    w = np.divide(1.0, pq2 * denom_global, out=np.zeros_like(pq2), where=use)

    # numerator: Zc diag(w) Zcᵀ with EXACT centering by 2f —
    #   Z W Zᵀ - u·1ᵀ - 1·uᵀ + (2f)ᵀW(2f)·11ᵀ,  u = Z W (2f)
    wj = jnp.asarray(w, jnp.float32)
    num = packed_crossprod_weighted(g.zq_n, wj)[:n, :n]
    u = dgemm(g, jnp.asarray(w * 2.0 * f, jnp.float32)[:, None], trans="n",
              center=False, precision="f32")[:n, 0]
    c = float(np.sum(w * (2.0 * f) ** 2))
    num = (num - u[None, :] - u[:, None] + np.float32(c)).astype(dtype)
    if g.miss_rows_n is not None and g.miss_rows_n.shape[0]:
        from scipy import sparse

        from .sparse import sparse_times_geno

        # missing entries packed as 0 centered to -2f: add back
        # a = (D W) Zc0ᵀ (sparse, entries 2f_s w_s) and (D W) Dᵀ so each
        # missing coordinate contributes exactly 0 (cf. grm()'s D-CSR)
        ia, ja, _, _, (mi, ms) = _missing_d_csr(g)
        vals = 2.0 * f[ms] * w[ms]           # (DW) entries, CSR row order
        a = sparse_times_geno(
            g, ia, ja, vals, g.indiv, trans_geno="t",
            precision="f32")  # (DW) Zᵀ [indiv, indiv]
        d2w = np.zeros(n)
        np.add.at(d2w, mi, vals * 2.0 * f[ms])   # (DW)(2f) per individual
        a = a.astype(dtype) - jnp.asarray(d2w, dtype)[:, None]
        d1 = sparse.csr_matrix((vals, (mi, ms)), shape=(n, g.snps))
        d2 = sparse.csr_matrix((2.0 * f[ms], (mi, ms)), shape=(n, g.snps))
        dwdt = jnp.asarray(np.asarray((d1 @ d2.T).todense()), dtype)
        num = num + a + a.T + dwdt
    if pair_denominator:
        counts = pairwise_nonmissing(g, use=use)
        num = jnp.where(counts > 0,
                        num / jnp.maximum(counts, 1).astype(dtype), 0.0)
    return 0.5 * (num + num.T)  # symmetrize f32 rounding exactly
