"""Exact GRM/LD missing-genotype corrections.

Oracle: float64 mean-imputed centered matrices — a missing entry
contributes exactly 0 to Zc (reference Missings semantics,
src/miraculix/Vector.matrix.D.cc:179-208)."""
import numpy as np
import pytest

from miraculix_tpu import from_dense
from miraculix_tpu.io import bed
from miraculix_tpu.ops.grm import grm, ld


@pytest.fixture()
def panel():
    g = bed.simulate_genotypes(150, 400, seed=21, missing_rate=0.05)
    gm = from_dense(g, keep_missing_info=True)
    f = np.asarray(gm.freq, np.float64)
    zc = np.where(g == 3, 0.0, g.astype(np.float64) - 2.0 * f[None, :])
    zc[g == 3] = 0.0
    return g, gm, f, zc


def test_grm_missing_correction_exact(panel):
    g, gm, f, zc = panel
    want = zc @ zc.T
    got = np.asarray(grm(gm, scale=False), np.float64)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4


def test_grm_scale_with_correction(panel):
    g, gm, f, zc = panel
    want = (zc @ zc.T) / (2.0 * np.sum(f * (1.0 - f)))
    got = np.asarray(grm(gm), np.float64)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4


def test_ld_missing_correction_exact(panel):
    g, gm, f, zc = panel
    cov = zc.T @ zc
    sd = np.sqrt(np.diag(cov))
    sd[sd == 0] = 1.0
    want = cov / np.outer(sd, sd)
    got = np.asarray(ld(gm), np.float64)
    assert np.abs(got - want).max() < 1e-3
    # exact correction: diagonal is a true variance, never clamped
    assert (np.diag(cov) >= 0).all()


def test_correct_missing_requires_info():
    g = bed.simulate_genotypes(30, 40, seed=1, missing_rate=0.1)
    gm = from_dense(g)  # no keep_missing_info
    with pytest.raises(ValueError, match="keep_missing_info"):
        grm(gm, correct_missing=True)
    with pytest.raises(ValueError, match="keep_missing_info"):
        ld(gm, correct_missing=True)


def test_no_missing_paths_unchanged():
    g = bed.simulate_genotypes(60, 80, seed=2)
    gm_plain = from_dense(g)
    gm_info = from_dense(g, keep_missing_info=True)  # no missing present
    np.testing.assert_allclose(np.asarray(grm(gm_plain)),
                               np.asarray(grm(gm_info)), atol=1e-4)


def test_missing_aware_entry_points_work_on_clean_panels():
    """keep_missing_info=True on a panel with ZERO missing calls must
    store EMPTY coordinate arrays (not None): grm/ld/grm_yang's
    missing-aware modes are well-defined on complete panels and used to
    raise a false 'requires keep_missing_info=True' (review finding)."""
    import miraculix_tpu as mx
    from miraculix_tpu.ops.grm import grm_yang, pairwise_nonmissing

    g = bed.simulate_genotypes(24, 64, seed=6)     # no missing
    assert (g != 3).all()
    gm = mx.from_dense(g, keep_missing_info=True)
    assert gm.miss_rows_n is not None and gm.miss_rows_n.shape == (0,)

    out = np.asarray(mx.grm(gm, pair_denominator=True), np.float64)
    f = np.asarray(gm.freq, np.float64)
    zc = g.astype(np.float64) - 2 * f
    counts = np.asarray(pairwise_nonmissing(gm))
    assert (counts == 64).all()
    r = np.asarray(mx.ld(gm, correct_missing=True))
    r0 = np.asarray(mx.ld(gm))
    np.testing.assert_allclose(r, r0, atol=1e-6)
    gy = np.asarray(grm_yang(gm, pair_denominator=True))
    gy0 = np.asarray(grm_yang(mx.from_dense(g)))
    np.testing.assert_allclose(gy, gy0, atol=1e-5)
    # checkpoint round-trip keeps the tracked-but-clean state
    del out, zc
