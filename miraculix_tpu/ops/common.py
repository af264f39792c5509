"""Shared packed-op utilities: the kernel dispatch, planar16 decode, and the
exact packed row statistics."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def kernel_interpret() -> bool:
    """How a Pallas kernel runs on the default backend — the ONE place this
    is decided: interpreted on ``cpu`` (the test platform), compiled through
    Triton on ``gpu``.  Any other platform raises: no kernel here targets
    it, and running one there by accident must not pass for a result."""
    platform = jax.default_backend()
    if platform == "cpu":
        return True
    if platform == "gpu":
        return False
    raise RuntimeError(
        f"no packed-op kernel for platform {platform!r}; supported: gpu "
        "(compiled through Triton) and cpu (interpreted)")


_SHIFTS = tuple(np.uint32(2 * m) for m in range(16))


def decode_plane(words: jax.Array, m: int, dtype) -> jax.Array:
    """Genotypes of plane ``m`` of planar16 words [R, W] -> [R, W] ``dtype``
    (word column c of plane m is decoded column m*W + c).  Values {0,1,2}
    are exact in every dtype used here (int8, bf16, f32)."""
    return ((words >> (2 * m)) & 3).astype(jnp.int32).astype(dtype)


def decode_planar16(words: jax.Array, dtype=jnp.bfloat16) -> jax.Array:
    """Decode planar16 uint32 words [R, W] -> genotype matrix [R, 16*W].

    Pure shift/mask ops; the concatenation joins contiguous [R, W] slabs in
    plane-major order, which by construction of the packing
    (miraculix_tpu.io.codec.pack_planar16) is the natural column order.

    This one decode replaces the reference's per-ISA kernel families
    (5codesIntern.h table lookups, 2bitIntern.h popcount tricks, the CUTLASS
    2-bit microkernel dgemm_compressed_cuda.h:229-269).
    """
    return jnp.concatenate([decode_plane(words, m, dtype) for m in range(16)],
                           axis=1)


def pad_words(zq: jax.Array, multiple: int) -> jax.Array:
    """Zero-pad the packed-word axis of ``zq`` [R, kw] to a multiple of
    ``multiple`` words.  Zero words decode to genotype 0, so a product over
    the padded axis is unchanged — provided the operand on the other side
    is laid out for the padded width (see ``planar_rows``)."""
    kw = zq.shape[1]
    kwp = -(-kw // multiple) * multiple
    if kwp == kw:
        return zq
    return jnp.pad(zq, ((0, 0), (0, kwp - kw)))


def planar_rows(b: jax.Array, kw: int, kwp: int) -> jax.Array:
    """Lay a dense operand B [cols <= 16*kw, n] out against a packing whose
    word axis is padded from ``kw`` to ``kwp`` words: row m*kw + c (plane m,
    word column c) moves to m*kwp + c, every other row is zero.  Returns
    [16*kwp, n]."""
    cols, n = b.shape
    b16 = jnp.zeros((16 * kw, n), b.dtype).at[:cols].set(b)
    if kwp == kw:
        return b16
    return jnp.pad(b16.reshape(16, kw, n),
                   ((0, 0), (0, kwp - kw), (0, 0))).reshape(16 * kwp, n)


def packed_indicator2(zq):
    """Packed {0,1} indicator of genotype == 2 from a planar16 packing,
    with pure bitwise ops: a 2-bit field holds 2 as binary 10, so
    ind = (b1 AND NOT b0) placed at the field's low bit.  Elementwise per
    genotype field, so it commutes with transposition: the indicator of a
    transposed packing IS the transposed packing of the indicator.  Powers
    z² = z + 2·1(z=2) tricks (logistic GWAS weights, weighted diagonals)."""
    m55 = jnp.uint32(0x55555555)
    return ((zq >> 1) & ~zq) & m55


def packed_row_sq_stats(zq):
    """Per-row Σ z² over a planar16 packing, EXACTLY, as f32 [rows]:
    Σ z² = Σ z + 2·#{z = 2} for z ∈ {0,1,2} — both terms integer-exact
    from shift/mask plane sums (missing packs as 0 and contributes 0).
    The shared core of the single-chip / 1D- / 2D-sharded GRM diagonals."""
    s1 = jnp.zeros((zq.shape[0],), jnp.int32)
    c2 = jnp.zeros((zq.shape[0],), jnp.int32)
    for m in range(16):
        plane = (zq >> _SHIFTS[m]) & jnp.uint32(3)
        s1 = s1 + jnp.sum(plane, axis=1).astype(jnp.int32)
        c2 = c2 + jnp.sum((plane == 2).astype(jnp.int32), axis=1)
    return (s1 + 2 * c2).astype(jnp.float32)
