"""The packed-op kernels: the Triton decode-matmul behind every dgemm tier
(interpreted here, compiled on the card), the K-blocked int8
crossproducts, and the one place that decides how a kernel runs.

Tests marked ``gpu`` compile the kernels for the card and skip without
one; run them there with ``MIRACULIX_TPU_TEST_GPU=1 python -m pytest tests
-m gpu``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import miraculix_tpu as mx
from miraculix_tpu.io import bed, codec
from miraculix_tpu.ops import common
from miraculix_tpu.ops import dgemm as dg
from miraculix_tpu.ops import grm as grm_ops
from miraculix_tpu.ops import ref_impl
from miraculix_tpu.ops.grm import (_check_int32_exact, packed_crossprod,
                                   packed_crossprod_rect,
                                   packed_crossprod_weighted)

# relative to max |oracle|: one bf16 piece of B keeps 8 bits (~2^-9 per
# element); two keep ~17 (f32 accumulation adds ~1e-7 at these sizes);
# three keep all 24, so only f32 accumulation rounds
TOL = {"bf16": 5e-3, "fast": 1e-5, "f32": 1e-6}


@pytest.fixture()
def small_blocks(blocks):
    """The card's blocking shape at the interpreter's scale: 32-row blocks,
    16-word tiles and 32-word K chunks, so the 77 x 63-word packings below
    span three row blocks, padded tiles and two chunks."""
    blocks(dg, CHUNK_WORDS=32,
           _blocks=lambda rows, kw, n, interpret: (32, 16, dg._block_cols(n)))


def _odd_packing(seed, rows=77, cols=1000):
    """A packing with an odd row count and a word axis (63 words) that is
    a multiple of no block size: rows and words are padded inside."""
    g = bed.simulate_genotypes(rows, cols, seed=seed)
    zq = codec.pack_planar16(g, lane=1, row_mult=1)
    assert zq.shape == (rows, -(-cols // 16))
    return np.where(g == 3, 0, g).astype(np.float64), jnp.asarray(zq)


def _rel(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(
        want).max()


@pytest.mark.parametrize("precision", ["bf16", "fast", "f32"])
@pytest.mark.parametrize("ncol", [1, 16, 32, 130, 600])
def test_packed_matmul_kernel_matches_oracle(small_blocks, rng, ncol,
                                            precision):
    g, zq = _odd_packing(ncol)
    b = rng.standard_normal((g.shape[1], ncol))
    got = dg.packed_matmul(zq, jnp.asarray(b, jnp.float32),
                           precision=precision)
    assert got.shape == (g.shape[0], ncol) and got.dtype == jnp.float32
    assert _rel(got, g @ b) < TOL[precision]


@pytest.mark.parametrize("precision", ["bf16", "fast", "f32"])
@pytest.mark.parametrize("trans", ["n", "t"])
def test_dgemm_tiers_odd_shapes(rng, trans, precision):
    """Both orientations of the public op on every kernel tier, centered,
    with row counts that fill no block."""
    g = bed.simulate_genotypes(83, 1301, seed=5)
    gm = mx.from_dense(g)
    b = rng.standard_normal((1301 if trans == "n" else 83, 7))
    got = mx.dgemm(gm, jnp.asarray(b, jnp.float32), trans=trans,
                   precision=precision)
    want = ref_impl.dgemm_oracle(g, b, np.asarray(gm.freq, np.float64),
                                 trans=trans)
    assert _rel(got, want) < TOL[precision]


def test_packed_matmul_rejects_unknown_tier():
    _, zq = _odd_packing(0)
    with pytest.raises(ValueError, match="precision"):
        dg.packed_matmul(zq, jnp.zeros((1000, 2)), precision="f64")


@pytest.mark.parametrize("parts", [1, 2, 3])
def test_split_bf16_pieces(parts):
    """Pieces are bf16 and their exact sum keeps ~8 bits per piece — all
    24 of f32 at three.  Jitted, so a compiler that folded the remainder
    to zero would fail here."""
    b = jnp.asarray(np.random.default_rng(3).standard_normal((64, 5))
                    * np.exp2(np.arange(-8, 8, 0.25)[:64, None]),
                    jnp.float32)
    pieces = jax.jit(dg.split_bf16, static_argnums=1)(b, parts)
    assert len(pieces) == parts
    assert all(p.dtype == jnp.bfloat16 for p in pieces)
    total = sum(np.asarray(p, np.float64) for p in pieces)
    err = np.abs(total - np.asarray(b, np.float64)) / np.abs(
        np.asarray(b, np.float64))
    assert err.max() <= (0.0 if parts == 3 else 2.0 ** (-8 * parts))


def test_block_cols():
    """Output columns per program: a power of two >= n, at least 16 (the
    narrowest dot Triton takes), at most MAX_BLOCK_COLS on the card.  The
    interpreter gets blocks as large as the operands, within bounds."""
    assert [dg._block_cols(n) for n in (1, 16, 17, 33, 100, 600)] == [
        16, 16, 32, 64, 128, dg.MAX_BLOCK_COLS]
    assert dg._blocks(21248, 15744, 32, interpret=False) == (
        dg.BLOCK_ROWS, dg.BLOCK_WORDS, 32)
    assert dg._blocks(77, 63, 600, interpret=True) == (128, 64, 512)
    assert dg._blocks(5000, 9000, 3, interpret=True) == (
        1024, dg.CHUNK_WORDS, 16)


def test_packed_matmul_x64_tracing(small_blocks, rng):
    """The kernel traces to the same f32 result with x64 on and off (its
    loop indices are int32 either way)."""
    g, zq = _odd_packing(2)
    b = jnp.asarray(rng.standard_normal((g.shape[1], 3)), jnp.float32)
    outs = []
    for x64 in (False, True):
        with jax.enable_x64(x64):
            outs.append(np.asarray(dg.packed_matmul(zq, b)))
    assert outs[0].dtype == outs[1].dtype == np.float32
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("platform,interpret",
                         [("cpu", True), ("gpu", False), ("rocm", None)])
def test_kernel_dispatch(monkeypatch, platform, interpret):
    """Interpreted on the CPU, compiled on the GPU, refused elsewhere."""
    monkeypatch.setattr(common.jax, "default_backend", lambda: platform)
    if interpret is None:
        with pytest.raises(RuntimeError, match="no packed-op kernel"):
            common.kernel_interpret()
    else:
        assert common.kernel_interpret() is interpret


@pytest.mark.parametrize("block_words", [16, 24, 4096])
def test_crossprod_k_blocks_exact(blocks, block_words):
    """The K-blocked int8 crossproduct is bit-exact against int64 numpy
    across block boundaries (63 words in blocks of 16 or 24 words: the last
    block zero-padded) and in one block."""
    blocks(grm_ops, CROSS_BLOCK_WORDS=block_words)
    g, zq = _odd_packing(11)
    m = np.asarray(packed_crossprod(zq))
    assert m.dtype == np.int32
    gi = g.astype(np.int64)
    np.testing.assert_array_equal(m, gi @ gi.T)


def test_crossprod_rect_k_blocks_exact(blocks):
    blocks(grm_ops, CROSS_BLOCK_WORDS=16)
    ga, za = _odd_packing(12, rows=40)
    gb, zb = _odd_packing(13, rows=91)
    m = np.asarray(packed_crossprod_rect(za, zb))
    np.testing.assert_array_equal(
        m, ga.astype(np.int64) @ gb.astype(np.int64).T)
    with pytest.raises(ValueError, match="K widths"):
        packed_crossprod_rect(za, zb[:, :32])


def test_crossprod_int32_guard():
    """The int32 accumulator is exact while 4 * snps < 2^31."""
    _check_int32_exact(2 ** 20)
    with pytest.raises(ValueError, match="overflow"):
        _check_int32_exact(2 ** 25)


def test_crossprod_weighted_f32_grade(blocks, rng):
    """decode(zq) diag(w) decode(zq)ᵀ within 1e-6 of the float64 oracle,
    across K blocks."""
    blocks(grm_ops, CROSS_BLOCK_WORDS=16)
    g, zq = _odd_packing(14)
    w = rng.uniform(0.05, 4.0, g.shape[1])
    got = packed_crossprod_weighted(zq, jnp.asarray(w, jnp.float32))
    assert _rel(got, (g * w) @ g.T) < 1e-6


@pytest.mark.parametrize("block_words", [16, 4096])
def test_packed_matmul_int8_k_blocks_exact(blocks, rng, block_words):
    """The f64 tier's digit pass is exact int32 against int64 numpy across
    K blocks (63 words in 16-word blocks, the last zero-padded) and in
    one block."""
    blocks(dg, _DIGIT_BLOCK_WORDS=block_words)
    g, zq = _odd_packing(15)
    d = rng.integers(-64, 65, (g.shape[1], 5))
    got = np.asarray(dg.packed_matmul_int8(zq, jnp.asarray(d, jnp.int8)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, g.astype(np.int64) @ d)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,ncol,lane,row_mult", [(3000, 48, 128, 256),
                                                     (3001, 300, 1, 1)])
def test_dgemm_kernel_compiled_on_card(gpu, rng, rows, ncol, lane, row_mult):
    """The Triton kernel as compiled for the card, every tier, against the
    float64 oracle at a width that fills several blocks: the library's
    padded packing with one output-column block, and a packing with a row
    count that fills no row block, a word count that fills no tile
    (2,500) and three output-column blocks (ncol 300 > 2*MAX_BLOCK_COLS)."""
    assert not common.kernel_interpret()
    g = bed.simulate_genotypes(rows, 40000, seed=1)
    zq = jnp.asarray(codec.pack_planar16(g, lane=lane, row_mult=row_mult))
    b = rng.standard_normal((40000, ncol))
    want = g.astype(np.float64) @ b
    for precision, tol in TOL.items():
        got = dg.packed_matmul(zq, jnp.asarray(b, jnp.float32),
                               precision=precision)[:rows]
        assert _rel(got, want) < tol, precision


@pytest.mark.gpu
def test_crossprod_on_card_exact(gpu):
    g = bed.simulate_genotypes(2000, 30000, seed=2)
    zq = jnp.asarray(codec.pack_planar16(g, row_mult=256))
    m = np.asarray(packed_crossprod(zq))[:2000, :2000]
    gi = g.astype(np.int64)
    np.testing.assert_array_equal(m, gi @ gi.T)
