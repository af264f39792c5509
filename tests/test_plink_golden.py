"""GRM/LD vs the vendored PLINK-FORMULA oracle fixture (not real PLINK
binary output).

Mirrors the reference's external-oracle tests without the binary (none is
obtainable here — no PLINK, no network): tests/crossproduct/
test_grm.jl:96-110 runs `plink --make-rel square cov` and asserts
‖G1·(1/M) − G2‖ < 1e-4; test_ld.jl:68-81 compares against `plink --r
square`.  The golden matrices come from tests/data/make_plink_golden.py,
an INDEPENDENT numpy implementation of PLINK's documented formulas that
never imports miraculix_tpu — a formula-oracle, which a same-formula
misreading could in principle fool.  The pair-masked-denominator case
(PLINK/GCTA missingness semantics — exactly the historical blind spot)
is covered below by golden_panel_missing.  Regenerate from real PLINK
output the moment a binary is obtainable."""
import os

import numpy as np

from miraculix_tpu import from_bed, grm, ld

DATA = os.path.join(os.path.dirname(__file__), "data")
BED = os.path.join(DATA, "golden_panel.bed")

# The golden files are checked in (git add -f past the *.bed/*.npy ignore
# rules), but regenerate if absent: make_plink_golden is deterministic
# (fixed seed) and independent of miraculix_tpu, so a regenerated fixture
# is the same oracle.
if not os.path.exists(BED):
    import subprocess
    import sys

    subprocess.run([sys.executable, os.path.join(DATA, "make_plink_golden.py")],
                   check=True)


def test_grm_matches_plink_make_rel_cov():
    gm = from_bed(BED)
    g1 = np.asarray(grm(gm, scale=False), np.float64) / gm.snps
    g2 = np.load(os.path.join(DATA, "golden_rel_cov.npy"))
    # the reference's exact acceptance criterion: Frobenius norm < 1e-4
    assert np.linalg.norm(g1 - g2) < 1e-4


def test_ld_matches_plink_r():
    gm = from_bed(BED)
    r1 = np.asarray(ld(gm), np.float64)
    r2 = np.load(os.path.join(DATA, "golden_r.npy"))
    # reference tolerance is max-abs < 0.1 (test_ld.jl:68-81); our exact
    # integer crossproduct does far better — hold it to 1e-4
    assert np.abs(r1 - r2).max() < 1e-4


def test_grm_matches_plink_make_rel_pair_masked():
    """`plink --make-rel` default (= gcta --make-grm) on a 6%-missing
    panel: per-SNP standardized terms over co-called SNPs, divided by each
    pair's own co-called count — grm_yang(pair_denominator=True) must
    reproduce the independent formula oracle."""
    from miraculix_tpu.ops.grm import grm_yang

    gm = from_bed(os.path.join(DATA, "golden_panel_missing.bed"),
                  keep_missing_info=True)
    g1 = np.asarray(grm_yang(gm, pair_denominator=True), np.float64)
    g2 = np.load(os.path.join(DATA, "golden_rel_std_missing.npy"))
    # f32-grade weighted-crossprod path (weights up to 1/(2pq) ~ 1e2):
    # elementwise ~1e-6; the reference's own GRM bands are 1e-1/1e-4
    assert np.abs(g1 - g2).max() < 3e-5
    assert np.linalg.norm(g1 - g2) < 1e-3


def test_fixture_freq_roundtrip():
    gm = from_bed(BED)
    # frequencies in the container must equal the empirical x̄/2 the golden
    # formulas used (no missing values in the fixture)
    from miraculix_tpu.io import bed as bedio

    g, freq = bedio.read_bed_genotypes(BED)
    assert (g != 3).all()
    np.testing.assert_allclose(np.asarray(gm.freq),
                               g.mean(axis=0) / 2.0, atol=1e-6)
