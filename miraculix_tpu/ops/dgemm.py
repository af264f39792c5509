"""dgemm_compressed: genotype matrix x dense matrix, straight off packed bits.

Replacement for the reference's three GEMM engines — the 5codes CPU
algorithm (src/miraculix/5codesIntern.h:214-316), the direct-PLINK AVX2
kernel (src/miraculix/plink256.cc:64-662) and the CUTLASS mixed-input GPU GEMM
(src/cuda/dgemm_compressed_cuda.cu:218-489).  Like the CUTLASS path, one
kernel decodes the 2-bit operand inside the GEMM main loop: a Pallas kernel
compiled through Triton loads a tile of planar16 words, decodes the 16
genotype planes in registers and feeds each to a bf16 tensor-core dot with
f32 accumulation, so the decoded panel never touches device memory.

Semantics (reference docs/genotype_matrix_multiplication.md, Julia test
tests/dgemm_compressed/test.jl:96-105): for genotype matrix Z of shape
(indiv, snps) and allele frequencies f,

    trans='n':  C[indiv, n] = (Z - 2·1·fᵀ) @ B,   B: [snps, n]
    trans='t':  C[snps,  n] = (Z - 2·1·fᵀ)ᵀ @ B,  B: [indiv, n]

Centering is never materialized: the raw packed product is corrected by a
rank-1 epilogue, exactly like the reference's cuBLAS epilogue
(dgemm_compressed_cuda.cu:421-459) and gV_vG_means_double
(Vector.matrix.D.cc:145-175):

    'n': C -= 2 * (fᵀ B)            (one [n]-vector, broadcast over rows)
    't': C -= 2 * f ⊗ (1ᵀ B)        (outer product)

Precision: genotypes are exact in bf16, so the tiers differ only in how many
bf16 pieces B is split into (B ≈ b₁ + … + b_p, each an exact bf16 value):
"bf16" one piece (~2e-3 relative), "fast" two (f32-grade, ~1e-6), "f32"
three (all 24 bits of B: f32 accumulation is the only rounding).  "f64"
expands B in base 2^7 int8 digits and runs exact int8×int8→int32 passes,
recombined in host float64 (~1e-15 relative; `packed_matmul_exact` — the
Ozaki scheme replacing the reference's long-double accumulators,
Vector.matrix.D.cc:42-229).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..geno import GenoMatrix
from .common import (decode_planar16, kernel_interpret, pad_words,
                     planar_rows)

# bf16 pieces of B per precision tier (see module docstring)
_PARTS = {"bf16": 1, "fast": 2, "f32": 3}

# Kernel blocking, read when the kernel is traced: rows of the packing per
# program, packed words per step of the in-program contraction loop (16x as
# many genotype columns), output columns per program — powers of two, as
# Triton requires — and packed words per K chunk.  Each chunk is its own
# program, and the chunks are summed afterwards: more programs for panels
# with few rows.
BLOCK_ROWS = 128
BLOCK_WORDS = 32
MAX_BLOCK_COLS = 128
CHUNK_WORDS = 1024
FLUSH_PLANES = 4      # planes per tensor-core accumulation chain (divides 16)
NUM_WARPS = 8
NUM_STAGES = 3


def split_bf16(b: jax.Array, parts: int) -> list:
    """Split f32 ``b`` into ``parts`` bf16 arrays whose exact sum is b to
    about 8·parts significant bits (all of f32's 24 at parts=3).  Every
    piece is the remainder rounded to the nearest bf16, and the remainder
    update is exact in f32.

    The rounding is integer arithmetic on the f32 bits (round half to
    even, then keep the top 16 bits), not float casts or
    ``reduce_precision``: XLA's excess-precision simplifications can fold
    ``x - f32(bf16(x))`` to 0 and silently drop every piece after the
    first."""
    pieces = []
    rest = b.astype(jnp.float32)
    for _ in range(parts - 1):
        bits = jax.lax.bitcast_convert_type(rest, jnp.uint32)
        bits = bits + jnp.uint32(0x7FFF) + ((bits >> 16) & jnp.uint32(1))
        hi = jax.lax.bitcast_convert_type(bits & jnp.uint32(0xFFFF0000),
                                          jnp.float32)
        pieces.append(hi.astype(jnp.bfloat16))      # exact: 8 bits
        rest = rest - hi                            # exact
    pieces.append(rest.astype(jnp.bfloat16))
    return pieces


def _dgemm_kernel(zq_ref, *refs, kw, planes, block_words, chunk_words):
    """out[c, rows, cols] = decode(zq[rows, chunk c]) @ Σ_p b_p[chunk c, cols].

    One program covers one K chunk of ``chunk_words`` packed words, as one
    loop over (word tile t, plane m) pairs, planes fastest: plane m of word
    tile t holds the genotypes of decoded columns m*kw + t*block_words +
    [0, block_words), so each step dots one decoded plane with the matching
    row slice of every B piece (no RHS reordering), and the steps of a
    tile re-read the same words from cache.  Only the first ``planes``
    planes hold columns of B; the rest are padding and are skipped.  The
    caller sums the chunks.

    The dots accumulate in ``part``, which the compiler keeps in the tensor
    cores' accumulator; every FLUSH_PLANES steps it is added into ``acc``
    by an ordinary f32 add.  On the card, a tensor-core accumulation chain
    loses precision with its length (measured ~2e-5 relative over a chain
    of 1024 words, 4e-5 over 2048), so the chains are kept short."""
    *b_refs, out_ref = refs
    rows, cols = out_ref.shape
    tiles = chunk_words // block_words
    t0 = pl.program_id(2) * tiles
    n_tiles = jnp.minimum(tiles, kw // block_words - t0)
    zeros = jnp.zeros((rows, cols), jnp.float32)

    def step(i, carry):
        acc, part = carry
        t, m = t0 + i // planes, i % planes
        w0 = pl.multiple_of(t * block_words, block_words)
        words = zq_ref[:, pl.ds(w0, block_words)]
        shift = (2 * m).astype(words.dtype)
        plane = ((words >> shift) & 3).astype(jnp.int32).astype(jnp.bfloat16)
        r0 = pl.multiple_of(m * kw + w0, block_words)
        for b_ref in b_refs:
            part = part + jnp.dot(plane, b_ref[pl.ds(r0, block_words), :],
                                  preferred_element_type=jnp.float32)
        flush = (m % FLUSH_PLANES == FLUSH_PLANES - 1) | (m == planes - 1)
        return (jnp.where(flush, acc + part, acc),
                jnp.where(flush, zeros, part))

    acc, _ = jax.lax.fori_loop(jnp.int32(0), planes * n_tiles, step,
                               (zeros, zeros))
    out_ref[...] = acc


def _pow2_at_least(n: int, lo: int) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _block_cols(n: int, cap: int = MAX_BLOCK_COLS) -> int:
    """Output columns per program: the power of two >= n (at least 16, the
    smallest dot width Triton takes), capped at ``cap``.  Padded columns
    are zero and cost flops only, which a memory-bound skinny product has
    to spare."""
    return min(_pow2_at_least(n, 16), cap)


def _blocks(rows: int, kw: int, n: int, interpret: bool) -> tuple:
    """(block_rows, block_words, block_cols): the Triton sizes tuned on the
    card, or, for the kernel interpreted on the CPU, which pays per
    program and per loop step rather than per byte, blocks as large as the
    operands (up to 1,024 rows, one K chunk of words, 512 columns)."""
    if not interpret:
        return BLOCK_ROWS, BLOCK_WORDS, _block_cols(n)
    return (min(_pow2_at_least(rows, 16), 1024),
            min(_pow2_at_least(kw, 16), CHUNK_WORDS), _block_cols(n, 512))


@functools.partial(jax.jit, static_argnames=("precision",))
def packed_matmul(zq: jax.Array, b: jax.Array, *,
                  precision: str = "fast") -> jax.Array:
    """Raw product decode(zq) @ B -> f32 [rows, n], no centering.

    ``zq``: uint32 planar16 [rows, kw]; ``b``: [cols <= 16*kw, n] (rows past
    ``cols`` count as zero).  ``precision``: "bf16", "fast" or "f32" (the
    number of bf16 pieces of B, see the module docstring).  Rows and words
    are zero-padded to the block sizes and the result sliced back, so any
    shape works; the library's packings (rows padded to 256, words to 128)
    need no copy."""
    if precision not in _PARTS:
        raise ValueError(f"precision must be one of {sorted(_PARTS)}, "
                         f"got {precision!r}")
    rows, kw = zq.shape
    cols, n = b.shape
    if cols > 16 * kw:
        raise ValueError(f"B has {cols} rows; the packing holds {16 * kw}")
    interpret = kernel_interpret()
    block_rows, block_words, bn = _blocks(rows, kw, n, interpret)
    zqp = pad_words(zq, block_words)
    kwp = zqp.shape[1]
    rows_p = -(-rows // block_rows) * block_rows
    if rows_p != rows:
        zqp = jnp.pad(zqp, ((0, rows_p - rows), (0, 0)))
    n_p = -(-n // bn) * bn
    planes = max(1, -(-cols // kw))         # planes that hold columns of B
    b2 = planar_rows(b.astype(jnp.float32), kw, kwp)[: planes * kwp]
    if n_p != n:
        b2 = jnp.pad(b2, ((0, 0), (0, n_p - n)))
    pieces = split_bf16(b2, _PARTS[precision])
    chunk_words = min(CHUNK_WORDS, kwp) // block_words * block_words
    n_chunks = -(-kwp // chunk_words)

    out = pl.pallas_call(
        functools.partial(_dgemm_kernel, kw=kwp, planes=planes,
                          block_words=block_words, chunk_words=chunk_words),
        grid=(rows_p // block_rows, n_p // bn, n_chunks),
        in_specs=[pl.BlockSpec((block_rows, kwp), lambda i, j, c: (i, 0))]
        + [pl.BlockSpec((planes * kwp, bn), lambda i, j, c: (0, j))]
        * len(pieces),
        out_specs=pl.BlockSpec((None, block_rows, bn),
                               lambda i, j, c: (c, i, j)),
        out_shape=jax.ShapeDtypeStruct((n_chunks, rows_p, n_p), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        cost_estimate=pl.CostEstimate(
            flops=2 * rows_p * planes * kwp * n_p * len(pieces),
            bytes_accessed=(zqp.size * 4 * (n_p // bn)
                            + planes * kwp * n_p * 2 * len(pieces)
                            * (rows_p // block_rows)
                            + n_chunks * rows_p * n_p * 4),
            transcendentals=0),
        interpret=interpret,
        name="packed_dgemm",
    )(zqp, *pieces)
    return jnp.sum(out, axis=0)[:rows, :n]


# Packed words per K block of the int8 digit passes, read when traced:
# bounds the decoded int8 slab at rows x 16K bytes
_DIGIT_BLOCK_WORDS = 1024


@jax.jit
def packed_matmul_int8(zq: jax.Array, d: jax.Array) -> jax.Array:
    """decode(zq) @ d with int8 digit values d [cols <= 16*kw, n] (any
    integer dtype, |d| <= 127), EXACT int32 accumulation: plain XLA, the
    packing decoded to int8 one K block at a time and each block run as one
    int8 x int8 -> int32 dot.  Exact while 192 * 16*kw < 2^31 (genotypes
    {0..3} x digits in [-64, 64])."""
    rows, kw = zq.shape
    n = d.shape[1]
    if 192 * 16 * kw >= 2 ** 31:
        raise ValueError(
            f"{16 * kw} genotype columns could overflow the exact int32 "
            "digit accumulator (limit ~11.2M SNPs); chunk the contraction "
            "(packed_matmul_exact does this automatically)")
    bw = min(_DIGIT_BLOCK_WORDS, kw)
    zqp = pad_words(zq, bw)
    kwp = zqp.shape[1]
    d3 = planar_rows(d.astype(jnp.int8), kw, kwp).reshape(16, kwp, n)

    def step(t, acc):
        words = jax.lax.dynamic_slice_in_dim(zqp, t * bw, bw, axis=1)
        rhs = jax.lax.dynamic_slice_in_dim(d3, t * bw, bw, axis=1)
        return acc + jax.lax.dot_general(
            decode_planar16(words, jnp.int8), rhs.reshape(16 * bw, n),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)

    return jax.lax.fori_loop(0, kwp // bw, step,
                             jnp.zeros((rows, n), jnp.int32))


def packed_matmul_exact(
    zq: jax.Array,
    b,
    *,
    digits: int = 8,
    as_numpy: bool = True,
    _kw_cap: int = 2 ** 19,
):
    """decode(zq) @ B to f64-GRADE accuracy via integer-digit splitting —
    the Ozaki-scheme idea mapped to exact int8 products.

    Each RHS column is scaled by a power of two to (-1/2, 1/2) and expanded
    in base 2^7 as ``digits`` int8 digit vectors (|digit| <= 64, extracted
    with round-to-nearest so residuals stay in [-1/2, 1/2]).  Every digit
    slice rides one EXACT int8 x int8 -> int32 product, and the int32
    partials recombine on host in float64 with power-of-two weights — also
    exact.  The only error is the base-2^7 truncation of B, ~2^-(7*digits)
    relative to each column's max (digits=8 -> ~1.4e-17), plus one final
    f64 rounding per element.  This replaces the reference's double /
    long-double accumulators (Vector.matrix.D.cc:42-229, CUTLASS f64 SIMT
    path dgemm_compressed_cuda.h:111-698).  (Whether the card's own f64
    units beat this route is not measured yet.)

    Host-orchestrated (digit extraction + f64 combine): not usable inside
    jit.  Returns numpy float64 when ``as_numpy`` (default), else a jnp
    array (f32 unless jax_enable_x64 is on).
    """
    import numpy as np

    if isinstance(b, jax.core.Tracer) or isinstance(zq, jax.core.Tracer):
        raise TypeError(
            "the exact/f64 tier is host-orchestrated (digit extraction and "
            "the f64 recombination run in numpy) and cannot run inside jit "
            "— call it eagerly, or use precision='f32' inside jitted solvers")
    rows, kw = zq.shape
    b64 = np.asarray(b, dtype=np.float64)
    cols, n = b64.shape
    if 192 * 16 * kw >= 2 ** 31 or kw > _kw_cap:
        # contraction too long for one exact int32 accumulation (~11.2M
        # genotype columns): chunk the packed-word axis and sum the exact
        # f64 partials — still exact to one final f64 rounding, preserving
        # the f64 tier's unlimited-K contract.  _kw_cap (192*16*2^19 <
        # 2^31) is overridable only so tests can exercise this path at
        # small sizes.
        kw_cap = min(_kw_cap, 2 ** 19)
        acc = np.zeros((rows, n), np.float64)
        for c0 in range(0, kw, kw_cap):
            c1 = min(c0 + kw_cap, kw)
            # decoded column m*kw + c of the full packing becomes column
            # m*(c1-c0) + (c-c0) of the chunk packing
            idx = (np.arange(16)[:, None] * kw
                   + np.arange(c0, c1)[None, :]).reshape(-1)
            bc = np.zeros((idx.size, n), np.float64)
            valid = idx < cols
            bc[valid] = b64[idx[valid]]
            acc += packed_matmul_exact(zq[:, c0:c1], bc, digits=digits,
                                       as_numpy=True, _kw_cap=kw_cap)
        return acc if as_numpy else jnp.asarray(acc)
    absmax = np.max(np.abs(b64), axis=0)
    # frexp exponent e gives |b| < 2^e, hence |b / 2^(e+1)| < 1/2
    e = np.where(absmax > 0, np.frexp(absmax)[1], 0).astype(np.float64)
    scale = np.exp2(e)
    x = b64 / (2.0 * scale)                 # |x| < 1/2
    acc = np.zeros((rows, n), np.float64)
    for j in range(digits):
        d = np.rint(x * 128.0)
        x = x * 128.0 - d                   # residual in [-1/2, 1/2]
        if not d.any():
            continue
        p = packed_matmul_int8(zq, jnp.asarray(d, jnp.int8))
        acc += np.asarray(p, np.float64) * (
            2.0 * scale * 128.0 ** -(j + 1))[None, :]
    return acc if as_numpy else jnp.asarray(acc)


def packed_matmul_f64(zq: jax.Array, b, *, as_numpy: bool = False):
    """The ``precision='f64'`` tier: ``packed_matmul_exact`` (integer-digit
    splitting, ~1e-16 relative).  Host-orchestrated; see there."""
    return packed_matmul_exact(zq, b, as_numpy=as_numpy)


# ---------------------------------------------------------------------------
# Public op
# ---------------------------------------------------------------------------

_HIGHEST = jax.lax.Precision.HIGHEST


def _resolve_center(center) -> tuple:
    """Normalize the ``center`` argument to (mode, user_vector).

    Modes mirror the reference ``centering_type`` enum
    (Automiraculix.h:121-124): NoCentering / RowMeans / ColMeans / User.
    """
    if center is True:
        return "rowmeans", None
    if center is False or center is None:
        return "none", None
    if isinstance(center, str):
        mode = center.lower()
        if mode in ("none", "nocentering"):
            return "none", None
        if mode in ("rowmeans", "row"):
            return "rowmeans", None
        if mode in ("colmeans", "col"):
            return "colmeans", None
        raise ValueError(f"unknown centering mode {center!r}")
    return "user", jnp.asarray(center)  # per-SNP user centering vector


def dgemm(
    g: GenoMatrix,
    b: jax.Array,
    trans: str = "n",
    center=True,
    normalize: bool = False,
    precision: str = "fast",
    ignore_missings: bool = True,
) -> jax.Array:
    """The ``dgemm_compressed`` entry point (reference 5codesAPI.c:98-110)
    with the full centering/normalization semantics of the means wrapper
    ``gV_vG_means_double`` (Vector.matrix.D.cc:42-229).

    trans='n': C[indiv, n] = (Z - M) @ B with B [snps, n]
    trans='t': C[snps, n]  = (Z - M)ᵀ @ B with B [indiv, n]

    ``center`` selects the centering matrix M (reference centering_type):
      - True / "rowmeans": M = 2·1·fᵀ (per-SNP allele means — the default)
      - "colmeans":        M = 2·pf·1ᵀ (per-individual means, getPseudoFreq)
      - an array u[snps]:  M = 1·uᵀ (User centering vector)
      - False / "none":    M = 0

    ``normalize`` divides the result by sigma (GlobalNormalizing,
    Vector.matrix.D.cc:213-222): sqrt(2 Σ p(1-p)) over SNP frequencies for
    trans='t' (the reference's gV orientation) and over per-individual
    pseudo-frequencies for trans='n'.

    The epilogue's f32 products run at HIGHEST precision: a GPU would
    otherwise take them in TF32 (~1e-3), below every tier but bf16.
    """
    trans = trans.lower()
    if trans not in ("n", "t"):
        raise ValueError(f"trans must be 'n' or 't', got {trans!r}")
    if precision not in ("bf16", "fast", "f32", "f64"):
        # an unknown string must not fall through to some other tier — a
        # caller expecting the exact f64 tier must not get ~1e-7
        raise ValueError(f"precision must be one of bf16/fast/f32/f64, "
                         f"got {precision!r}")
    if b.ndim == 1:
        b = b[:, None]
    mode, user_vec = _resolve_center(center)

    if trans == "n":
        zq, rows, cols = g.zq_n, g.indiv, g.snps
    else:
        zq, rows, cols = g.zq_t, g.snps, g.indiv
    if b.shape[0] != cols:
        raise ValueError(
            f"B has {b.shape[0]} rows, expected {cols} for trans='{trans}'"
        )
    if mode == "colmeans" and g.pseudo_freq is None:
        raise ValueError("colmeans centering needs pseudo_freq")
    if precision == "f64":
        return _dgemm_f64(g, zq, b, trans, rows, mode, center,
                          normalize, ignore_missings)

    c = packed_matmul(zq, b, precision=precision)[:rows]
    if mode != "none":
        bc = b.astype(c.dtype)
        if mode in ("rowmeans", "user"):
            cvec = (2.0 * g.freq if mode == "rowmeans" else user_vec)
            cvec = cvec.astype(c.dtype)  # per-SNP centers
            if trans == "n":
                c = c - jnp.dot(cvec, bc, precision=_HIGHEST)[None, :]
            else:
                c = c - cvec[:, None] * jnp.sum(bc, axis=0)[None, :]
        else:  # colmeans: per-individual centers
            pvec = (2.0 * g.pseudo_freq).astype(c.dtype)
            if trans == "n":
                c = c - pvec[: rows, None] * jnp.sum(bc, axis=0)[None, :]
            else:
                c = c - jnp.dot(pvec, bc, precision=_HIGHEST)[None, :]
    if mode != "none" and not ignore_missings and g.miss_rows_n is not None:
        c = _missing_correction(g, b.astype(c.dtype), c, trans, mode,
                                user_vec)
    if normalize:
        s2 = g.sigma2 if trans == "t" else g.pseudo_sigma2
        c = c / jnp.sqrt(s2).astype(c.dtype)
    return c


def _dgemm_f64(g, zq, b, trans, rows, mode, center, normalize,
               ignore_missings):
    """The f64 tier of :func:`dgemm`, epilogue included, in host numpy
    float64: without jax_enable_x64, a jnp result would be quantized to f32
    and silently degrade the tier to ~5e-8."""
    import numpy as np

    c = packed_matmul_f64(zq, b, as_numpy=True)[:rows]
    bc = np.asarray(b, np.float64)
    # user centering: take the caller's ORIGINAL vector — _resolve_center
    # round-tripped it through jnp.asarray, which quantizes an f64 vector
    # to f32 whenever x64 is off
    uvec64 = (np.asarray(center, np.float64) if mode == "user" else None)
    if mode in ("rowmeans", "user"):
        cvec = (np.asarray(2.0 * g.freq, np.float64)
                if mode == "rowmeans" else uvec64)
        if trans == "n":
            c = c - (cvec @ bc)[None, :]
        else:
            c = c - cvec[:, None] * bc.sum(axis=0)[None, :]
    elif mode == "colmeans":
        pvec = np.asarray(2.0 * g.pseudo_freq, np.float64)
        if trans == "n":
            c = c - pvec[:rows, None] * bc.sum(axis=0)[None, :]
        else:
            c = c - (pvec @ bc)[None, :]
    if mode != "none" and not ignore_missings and g.miss_rows_n is not None:
        mi = np.asarray(g.miss_rows_n)
        ms = np.asarray(g.miss_cols_n)
        if mode == "colmeans":
            cent = np.asarray(2.0 * g.pseudo_freq, np.float64)[mi]
        elif mode == "user":
            cent = uvec64[ms]
        else:
            cent = np.asarray(2.0 * g.freq, np.float64)[ms]
        if trans == "n":
            np.add.at(c, mi, cent[:, None] * bc[ms])
        else:
            np.add.at(c, ms, cent[:, None] * bc[mi])
    if normalize:
        s2 = g.sigma2 if trans == "t" else g.pseudo_sigma2
        c = c / np.sqrt(np.asarray(s2, np.float64))
    return c


def _missing_correction(g: GenoMatrix, b: jax.Array, c: jax.Array,
                        trans: str, mode: str = "rowmeans",
                        user_vec=None):
    """Centering correction for missing genotypes: a missing entry entered
    the packed product as genotype 0, hence contributed (0 - center)·B-row;
    the reference semantics (Vector.matrix.D.cc:179-208) make it contribute
    0.  Add back the subtracted center at each missing coordinate (i, s)."""
    mi, ms = g.miss_rows_n, g.miss_cols_n  # (indiv-idx, snp-idx)
    if mode == "colmeans":
        cent = (2.0 * g.pseudo_freq).astype(c.dtype)[mi]  # per-individual
    elif mode == "user":
        cent = user_vec.astype(c.dtype)[ms]
    else:
        cent = (2.0 * g.freq).astype(c.dtype)[ms]
    if trans == "n":  # C rows = individuals, B rows = snps
        return c.at[mi].add(cent[:, None] * b[ms])
    # 't': C rows = snps, B rows = individuals
    return c.at[ms].add(cent[:, None] * b[mi])
