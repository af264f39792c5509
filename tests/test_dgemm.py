"""dgemm_compressed correctness vs the dense float64 oracle.

Mirrors reference tests/dgemm_compressed/test.jl (both orientations against
dense (Z - 2f)·B, tol 1e-1 abs there; we require much tighter) and the
Fortran tests' 1e-4 relative tolerance (test_5codesapi.f90:43).
"""
import numpy as np
import pytest

import miraculix_tpu as mx
from miraculix_tpu.io import bed
from miraculix_tpu.ops import ref_impl


def _panel(rng, indiv, snps, missing_rate=0.0):
    g = bed.simulate_genotypes(indiv, snps, seed=int(rng.integers(1 << 30)),
                               missing_rate=missing_rate)
    return g


@pytest.mark.parametrize("indiv,snps,n", [(40, 100, 4), (300, 1000, 8), (61, 2049, 3)])
@pytest.mark.parametrize("trans", ["n", "t"])
@pytest.mark.parametrize("center", [False, True])
def test_dgemm_matches_oracle(rng, indiv, snps, n, trans, center):
    g = _panel(rng, indiv, snps)
    gm = mx.from_dense(g)
    rows_b = snps if trans == "n" else indiv
    b = rng.standard_normal((rows_b, n))
    c = np.asarray(mx.dgemm(gm, b, trans=trans, center=center))
    want = ref_impl.dgemm_oracle(g, b, np.asarray(gm.freq, np.float64),
                                 trans=trans, center=center)
    scale = max(1.0, np.abs(want).max())
    assert np.abs(c - want).max() / scale < 1e-4


@pytest.mark.parametrize("precision,tol", [("fast", 1e-4), ("f32", 1e-5), ("f64", 1e-12)])
def test_dgemm_precision_modes(rng, precision, tol):
    g = _panel(rng, 120, 3000)
    gm = mx.from_dense(g)
    b = rng.standard_normal((3000, 4))
    c = np.asarray(mx.dgemm(gm, b, trans="n", center=True, precision=precision))
    want = ref_impl.dgemm_oracle(g, b, np.asarray(gm.freq, np.float64))
    assert np.abs(c - want).max() / np.abs(want).max() < tol


def test_dgemm_normalize(rng):
    g = _panel(rng, 50, 200)
    gm = mx.from_dense(g)
    b = rng.standard_normal((200, 2))
    c = np.asarray(mx.dgemm(gm, b, normalize=True))
    want = ref_impl.dgemm_oracle(g, b, np.asarray(gm.freq, np.float64),
                                 normalize=True)
    assert np.abs(c - want).max() < 1e-4 * max(1.0, np.abs(want).max())


def test_dgemm_external_freq(rng):
    """plink2compressed accepts externally supplied frequencies (5codesAPI.c:80)."""
    g = _panel(rng, 30, 64)
    f_ext = rng.uniform(0.1, 0.5, size=64)
    gm = mx.from_dense(g, freq=f_ext)
    b = rng.standard_normal((64, 2))
    c = np.asarray(mx.dgemm(gm, b, center=True))
    want = ref_impl.dgemm_oracle(g, b, f_ext, center=True)
    assert np.abs(c - want).max() < 1e-4


def test_dgemm_missing_ignored(rng):
    """Default path: missings enter as genotype 0, centering still global."""
    g = _panel(rng, 80, 500, missing_rate=0.05)
    gm = mx.from_dense(g)
    b = rng.standard_normal((500, 3))
    c = np.asarray(mx.dgemm(gm, b, center=True, ignore_missings=True))
    want = ref_impl.dgemm_oracle(g, b, np.asarray(gm.freq, np.float64),
                                 center=True, respect_missings=False)
    assert np.abs(c - want).max() / np.abs(want).max() < 1e-4


@pytest.mark.parametrize("trans", ["n", "t"])
def test_dgemm_missing_corrected(rng, trans):
    """ignore_missings=False: missing entries contribute 0 to the centered
    product (reference Vector.matrix.D.cc:179-208)."""
    g = _panel(rng, 70, 400, missing_rate=0.08)
    gm = mx.from_dense(g, keep_missing_info=True)
    rows_b = 400 if trans == "n" else 70
    b = rng.standard_normal((rows_b, 3))
    c = np.asarray(mx.dgemm(gm, b, trans=trans, center=True,
                            ignore_missings=False))
    want = ref_impl.dgemm_oracle(g, b, np.asarray(gm.freq, np.float64),
                                 trans=trans, center=True,
                                 respect_missings=True)
    assert np.abs(c - want).max() / np.abs(want).max() < 1e-4


def test_dgemm_vector_rhs(rng):
    g = _panel(rng, 20, 50)
    gm = mx.from_dense(g)
    b = rng.standard_normal(50)
    c = np.asarray(mx.dgemm(gm, b))
    assert c.shape == (20, 1)


@pytest.mark.parametrize("trans", ["n", "t"])
@pytest.mark.parametrize("mode", ["colmeans", "user"])
def test_dgemm_centering_modes(rng, trans, mode):
    """ColMeans / User centering (reference centering_type,
    Automiraculix.h:121-124, epilogue Vector.matrix.D.cc:145-175)."""
    g = _panel(rng, 70, 400)
    gm = mx.from_dense(g)
    rows_b = 400 if trans == "n" else 70
    b = rng.standard_normal((rows_b, 3))
    center = mode if mode == "colmeans" else rng.uniform(0, 2, size=400)
    c = np.asarray(mx.dgemm(gm, b, trans=trans, center=center))
    want = ref_impl.dgemm_oracle(g, b, np.asarray(gm.freq, np.float64),
                                 trans=trans, center=center)
    scale = max(1.0, np.abs(want).max())
    assert np.abs(c - want).max() / scale < 1e-4


@pytest.mark.parametrize("trans", ["n", "t"])
@pytest.mark.parametrize("mode", ["rowmeans", "colmeans"])
def test_dgemm_missing_corrections_modes(rng, trans, mode):
    """Missing-value centering corrections per mode
    (Vector.matrix.D.cc:179-208)."""
    g = _panel(rng, 50, 300, missing_rate=0.05)
    gm = mx.from_dense(g, keep_missing_info=True)
    rows_b = 300 if trans == "n" else 50
    b = rng.standard_normal((rows_b, 2))
    c = np.asarray(mx.dgemm(gm, b, trans=trans, center=mode,
                            ignore_missings=False))
    want = ref_impl.dgemm_oracle(g, b, np.asarray(gm.freq, np.float64),
                                 trans=trans, center=mode,
                                 respect_missings=True)
    scale = max(1.0, np.abs(want).max())
    assert np.abs(c - want).max() / scale < 1e-4


def test_freq_cache_family(rng):
    """getFreq-family derivatives (reference haplogeno.cc:1461-1661)."""
    g = _panel(rng, 60, 200)
    gm = mx.from_dense(g)
    gd = g.astype(np.float64)
    np.testing.assert_allclose(np.asarray(gm.snp_sums()), gd.sum(0), atol=1e-3)
    np.testing.assert_allclose(np.asarray(gm.indiv_sums()), gd.sum(1), atol=1e-3)
    np.testing.assert_allclose(np.asarray(gm.freq_sxi()),
                               gd @ np.asarray(gm.freq, np.float64),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(np.asarray(gm.pseudo_freq_sxi()),
                               gd.T @ np.asarray(gm.pseudo_freq, np.float64),
                               rtol=1e-5, atol=1e-3)
    assert abs(float(gm.total_sum()) - gd.sum()) < 1e-2
    pf = ref_impl.allele_freq_oracle(g, axis=1)
    np.testing.assert_allclose(np.asarray(gm.pseudo_freq), pf, atol=1e-6)


@pytest.mark.parametrize("trans", ["n", "t"])
@pytest.mark.parametrize("n", [4, 200])   # tall and wide schedules
def test_dgemm_bf16_tier(rng, trans, n):
    """precision='bf16': single-pass speed tier, ~2e-3 relative."""
    g = _panel(rng, 90, 500)
    gm = mx.from_dense(g)
    rows_b = 500 if trans == "n" else 90
    b = rng.standard_normal((rows_b, n))
    c = np.asarray(mx.dgemm(gm, b, trans=trans, precision="bf16"))
    want = ref_impl.dgemm_oracle(g, b, np.asarray(gm.freq, np.float64),
                                 trans=trans)
    scale = max(1.0, np.abs(want).max())
    err = np.abs(c - want).max() / scale
    assert err < 2e-2            # bf16 tier tolerance
    assert err > 1e-7            # and it really is the low tier, not split


def test_dgemm_fuzz_shapes(rng):
    """Property sweep: random (indiv, snps, n, trans, center) configs must
    match the float64 oracle — covers odd shapes, both schedules, both
    orientations in one sweep (the reference's edge-dims tests generalized)."""
    for trial in range(10):
        indiv = int(rng.integers(3, 400))
        snps = int(rng.integers(3, 1200))
        n = int(rng.integers(1, 150))
        trans = ["n", "t"][int(rng.integers(2))]
        center = [True, False, "colmeans"][int(rng.integers(3))]
        g = bed.simulate_genotypes(indiv, snps, seed=trial,
                                   missing_rate=0.02 * (trial % 2))
        gm = mx.from_dense(g)
        rows_b = snps if trans == "n" else indiv
        b = rng.standard_normal((rows_b, n))
        c = np.asarray(mx.dgemm(gm, b, trans=trans, center=center))
        want = ref_impl.dgemm_oracle(g, b, np.asarray(gm.freq, np.float64),
                                     trans=trans, center=center)
        scale = max(1.0, np.abs(want).max())
        err = np.abs(c - want).max() / scale
        assert err < 1e-4, (indiv, snps, n, trans, center, err)


_X64_SCRIPT = """
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
import miraculix_tpu as mx
from miraculix_tpu.io import bed
from miraculix_tpu.ops import ref_impl
g = bed.simulate_genotypes(120, 3000, seed=11)
gm = mx.from_dense(g)
b = np.random.default_rng(0).standard_normal((3000, 4))
for center in (False, True):
    c = np.asarray(mx.dgemm(gm, b, trans="n", center=center, precision="f64"))
    assert c.dtype == np.float64, c.dtype
    want = ref_impl.dgemm_oracle(g, b, np.asarray(gm.freq, np.float64),
                                 center=center)
    err = np.abs(c - want).max() / np.abs(want).max()
    assert err < 1e-12, (center, err)
print("ok")
"""


def test_dgemm_f64_tier_under_x64():
    """precision='f64' must hold its f64 grade (~1e-12) with jax_enable_x64 on —
    the mode where callers actually want float64 outputs.  Runs in a
    subprocess: toggling x64 at runtime poisons jit caches for the rest of
    the process."""
    import subprocess
    import sys

    res = subprocess.run([sys.executable, "-c", _X64_SCRIPT],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "ok" in res.stdout


def test_packed_matmul_exact_digit_path(rng):
    """The integer-digit (Ozaki-style) exact path: result matches a pure
    float64 oracle to ~1e-15 — true double precision from exact int8 passes."""
    from miraculix_tpu.io import codec
    from miraculix_tpu.ops.dgemm import packed_matmul_exact

    g = _panel(rng, 64, 1500)
    zq = codec.pack_planar16(g)
    b = rng.standard_normal((1500, 3)) * np.exp2(
        rng.integers(-20, 20, size=(1, 3)))  # wide per-column dynamic range
    got = packed_matmul_exact(zq, b)
    want = np.where(g == 3, 3, g).astype(np.float64) @ b
    assert got.dtype == np.float64
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 1e-13, rel


def test_packed_matmul_exact_kw_chunked(rng):
    """The unlimited-K contract: contractions beyond the int32 digit
    accumulator's ~11.2M-column limit split the packed-word axis and sum
    exact f64 partials.  Forced here via the test-only _kw_cap knob."""
    from miraculix_tpu.io import codec
    from miraculix_tpu.ops.dgemm import packed_matmul_exact

    g = _panel(rng, 64, 8192)  # kw = 512 -> 4 chunks at cap 128
    zq = codec.pack_planar16(g)
    b = rng.standard_normal((8192, 3))
    got = packed_matmul_exact(zq, b, _kw_cap=128)
    want = np.where(g == 3, 3, g).astype(np.float64) @ b
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 1e-13, rel


_NO_X64_SCRIPT = """
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import miraculix_tpu as mx
from miraculix_tpu.io import bed
from miraculix_tpu.ops import ref_impl
assert not jax.config.jax_enable_x64
g = bed.simulate_genotypes(100, 2000, seed=13, missing_rate=0.03)
gm = mx.from_dense(g, keep_missing_info=True)
b = np.random.default_rng(1).standard_normal((2000, 4))
user = np.random.default_rng(2).standard_normal(2000)  # f64 user centers
for center in (False, True, user):
    c = mx.dgemm(gm, b, trans="n", center=center, precision="f64",
                 ignore_missings=center is False)
    assert isinstance(c, np.ndarray) and c.dtype == np.float64, type(c)
    want = ref_impl.dgemm_oracle(g, b, np.asarray(gm.freq, np.float64),
                                 center=center,
                                 respect_missings=center is not False)
    err = np.abs(c - want).max() / np.abs(want).max()
    assert err < 1e-12, (center, err)
print("ok")
"""


def test_dgemm_f64_tier_without_x64():
    """precision='f64' must hold its f64 grade with jax_enable_x64 OFF —
    JAX's default.  Regression: jnp.asarray of the exact host-f64 result
    used to quantize the tier to f32 (~5e-8); the fix keeps the result and
    the whole centering/missing epilogue in host numpy float64."""
    import subprocess
    import sys

    res = subprocess.run([sys.executable, "-c", _NO_X64_SCRIPT],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "ok" in res.stdout


def test_subset_snps_keeps_missing_corrections():
    """subset_snps must carry the restricted+remapped missing coordinate
    lists: dgemm(ignore_missings=False) on the subset == the dense f64
    oracle with missing entries contributing 0 (review finding: a dropped
    list silently reverted to ignore_missings=True semantics)."""
    import jax.numpy as jnp

    from miraculix_tpu.geno import from_dense, subset_snps
    from miraculix_tpu.ops.dgemm import dgemm

    rng = np.random.default_rng(11)
    geno = bed.simulate_genotypes(48, 96, seed=11, missing_rate=0.08)
    gm = from_dense(geno, keep_missing_info=True)
    idx = np.sort(rng.choice(96, size=40, replace=False))
    sub = subset_snps(gm, idx)
    assert sub.miss_rows_n is not None

    b = rng.standard_normal((40, 3)).astype(np.float32)
    got = np.asarray(dgemm(sub, jnp.asarray(b), trans="n", center=True,
                           ignore_missings=False), np.float64)
    f = np.asarray(gm.freq, np.float64)[idx]   # parent freqs at idx
    zsub = geno[:, idx].astype(np.float64)
    zc = np.where(zsub == 3, 0.0, zsub - 2.0 * f)   # missing contributes 0
    want = zc @ b.astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)


def test_dgemm_rejects_unknown_precision():
    import jax.numpy as jnp

    g = bed.simulate_genotypes(16, 32, seed=0)
    from miraculix_tpu.geno import from_dense
    from miraculix_tpu.ops.dgemm import dgemm

    gm = from_dense(g)
    b = np.zeros((32, 2), np.float32)
    with pytest.raises(ValueError, match="precision"):
        dgemm(gm, jnp.asarray(b), trans="n", precision="exact")
