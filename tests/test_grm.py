"""GRM / LD crossproduct correctness vs dense oracles.

Mirrors reference tests/crossproduct/test_grm.jl (dense-oracle path, centered
and uncentered, odd edge dims like 953x752) and test_ld.jl.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import miraculix_tpu as mx
from miraculix_tpu.io import bed
from miraculix_tpu.ops import ref_impl


@pytest.mark.parametrize("indiv,snps", [(40, 100), (128, 512), (95, 753)])
def test_crossprod_exact_integers(rng, indiv, snps):
    g = bed.simulate_genotypes(indiv, snps, seed=7)
    gm = mx.from_dense(g)
    m = np.asarray(mx.snp_crossprod(gm))
    want = ref_impl.crossprod_oracle(g)
    np.testing.assert_array_equal(m, want)  # bf16xbf16->f32 is EXACT here


def test_crossprod_snpmajor(rng):
    g = bed.simulate_genotypes(60, 200, seed=8)
    gm = mx.from_dense(g)
    m = np.asarray(mx.snp_crossprod(gm, snpmajor_output=True))
    want = ref_impl.crossprod_oracle(g, snpmajor_output=True)
    np.testing.assert_array_equal(m, want)


@pytest.mark.parametrize("indiv,snps", [(100, 400), (953, 752)])
def test_grm_matches_definition(rng, indiv, snps):
    """Schlather decomposition == direct P Z Zt P / sigma2 (docs/grm.md)."""
    g = bed.simulate_genotypes(indiv, snps, seed=9)
    gm = mx.from_dense(g)
    got = np.asarray(mx.grm(gm), dtype=np.float64)
    want = ref_impl.grm_oracle(g, np.asarray(gm.freq, np.float64))
    assert np.abs(got - want).max() < 1e-4
    assert np.allclose(got, got.T)


def test_grm_unscaled(rng):
    g = bed.simulate_genotypes(50, 150, seed=10)
    gm = mx.from_dense(g)
    got = np.asarray(mx.grm(gm, scale=False), dtype=np.float64)
    want = ref_impl.grm_oracle(g, np.asarray(gm.freq, np.float64), scale=False)
    assert np.abs(got - want).max() < 1e-3


def test_ld_matches_oracle(rng):
    g = bed.simulate_genotypes(300, 80, seed=11)
    gm = mx.from_dense(g)
    got = np.asarray(mx.ld(gm), dtype=np.float64)
    want = ref_impl.ld_oracle(g, np.asarray(gm.freq, np.float64))
    assert np.abs(got - want).max() < 1e-4
    # r^2 diagonal is exactly 1
    np.testing.assert_allclose(np.diag(got), 1.0, atol=1e-6)
    # LD against the empirical correlation of allele counts
    z = g.astype(np.float64)
    corr = np.corrcoef(z.T)
    # ld() centers by 2f (allele freq), not the sample mean; they coincide
    # because mean = 2f by definition
    assert np.abs(got - corr).max() < 1e-4


def test_grm_blocked_matches_grm(rng, tmp_path):
    """Out-of-core blocked GRM (host accumulation, triangle tile pairs) must
    reproduce the on-device GRM from every source type."""
    from miraculix_tpu.ops.grm import grm_blocked

    g = bed.simulate_genotypes(700, 1500, seed=33)
    gm = mx.from_dense(g)
    want = np.asarray(mx.grm(gm))
    # row_block=512 forces a 2x2 block grid (indiv_pad = 768 -> blocks)
    got = grm_blocked(gm, row_block=512)
    np.testing.assert_allclose(got[:700, :700], want, atol=1e-4)

    got_dense = grm_blocked(g, row_block=512)
    np.testing.assert_allclose(got_dense, want, atol=1e-4)

    p = str(tmp_path / "oc.bed")
    bed.write_bed(p, g)
    got_bed = grm_blocked(p, row_block=512)
    np.testing.assert_allclose(got_bed, want, atol=1e-4)


def test_ld_blocked_matches_ld(rng):
    from miraculix_tpu.ops.grm import ld_blocked

    g = bed.simulate_genotypes(150, 1100, seed=34)
    gm = mx.from_dense(g)
    want = np.asarray(mx.ld(gm))
    got = ld_blocked(gm, row_block=512)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_crossprod_autopads_odd_row_counts(rng):
    """Packings with row counts that are no power of two (3968 = 128*31,
    384, 192 — the 21k-individual reference panels pad to 21,248 rows) give
    the exact integer crossproduct."""
    from miraculix_tpu.io import codec
    from miraculix_tpu.ops.grm import packed_crossprod

    g = (rng.random((3968, 512)) * 3).astype(np.int8)
    zq = codec.pack_planar16(g, row_mult=128)
    assert zq.shape[0] == 3968
    m = np.asarray(packed_crossprod(zq))
    want = g.astype(np.int64) @ g.astype(np.int64).T
    assert m.shape == (3968, 3968)
    np.testing.assert_array_equal(m, want)

    g1 = (rng.random((384, 512)) * 3).astype(np.int8)
    zq1 = codec.pack_planar16(g1, row_mult=128)
    m1 = np.asarray(packed_crossprod(zq1))
    np.testing.assert_array_equal(
        m1, g1.astype(np.int64) @ g1.astype(np.int64).T)

    g2 = (rng.random((192, 512)) * 3).astype(np.int8)
    zq2 = codec.pack_planar16(g2, row_mult=64)
    assert zq2.shape[0] == 192
    m2 = np.asarray(packed_crossprod(zq2))
    np.testing.assert_array_equal(
        m2, g2.astype(np.int64) @ g2.astype(np.int64).T)


def test_ld_windowed_matches_full(rng):
    """Banded LD == the corresponding superdiagonals of the full r matrix;
    entries past the panel edge are 0; squared option squares."""
    import miraculix_tpu as mx

    g = bed.simulate_genotypes(96, 900, seed=18)
    gm = mx.from_dense(g)
    full = np.asarray(mx.ld(gm))
    w = 48
    band = mx.ld_windowed(gm, window=w, row_block=512)
    want = np.zeros((900, w), np.float32)
    for s in range(900):
        hi = min(s + 1 + w, 900)
        want[s, : hi - s - 1] = full[s, s + 1: hi]
    assert np.abs(band - want).max() < 2e-5
    assert (band[-1] == 0).all()  # last SNP has no later partner
    np.testing.assert_allclose(
        mx.ld_windowed(gm, window=w, row_block=512, squared=True),
        band * band, atol=1e-6)


def test_ld_prune_invariants(rng):
    """Greedy pairwise pruning: exact-duplicate SNPs lose exactly one
    member, and NO kept pair within the window exceeds the threshold."""
    import miraculix_tpu as mx

    base = bed.simulate_genotypes(200, 400, seed=5)
    dup = base.copy()
    dup[:, 100:120] = dup[:, 80:100]  # r^2 = 1 pairs, 20 apart
    gm = mx.from_dense(dup)
    w, thr = 64, 0.5
    keep = mx.ld_prune(gm, window=w, r2_threshold=thr)
    for a, b in zip(range(80, 100), range(100, 120)):
        assert not (keep[a] and keep[b])
    band2 = mx.ld_windowed(gm, window=w, squared=True)
    for s in range(400):
        if not keep[s]:
            continue
        hi = min(s + 1 + w, 400)
        part = np.arange(s + 1, hi)
        assert not (keep[part] & (band2[s, : hi - s - 1] > thr)).any()


def test_dominance_grm_oracle():
    """Su et al. genotypic dominance GRM == the dense float64 definition,
    from both dense input and the packed GenoMatrix."""
    from miraculix_tpu.ops.grm import dominance_grm

    g = bed.simulate_genotypes(96, 700, seed=13)
    het = (g == 1).astype(np.float64)
    hc = het - het.mean(axis=0, keepdims=True)
    p = g.mean(axis=0) / 2.0
    pq = 2.0 * p * (1.0 - p)
    want = (hc @ hc.T) / np.sum(pq * (1.0 - pq))

    got_dense = np.asarray(dominance_grm(g), np.float64)
    assert np.abs(got_dense - want).max() / np.abs(want).max() < 1e-5

    gm = mx.from_dense(g)
    got_gm = np.asarray(dominance_grm(gm), np.float64)
    np.testing.assert_allclose(got_gm, got_dense, atol=1e-7)


def test_dominance_grm_missing_as_nonhet():
    from miraculix_tpu.ops.grm import dominance_grm

    g = bed.simulate_genotypes(48, 300, seed=14, missing_rate=0.05)
    gm = mx.from_dense(g)  # packs missing as 0 -> non-het
    gz = np.where(g == 3, 0, g)
    het = (gz == 1).astype(np.float64)
    hc = het - het.mean(axis=0, keepdims=True)
    p = np.asarray(gm.freq, np.float64)  # missing-aware additive freq
    pq = 2.0 * p * (1.0 - p)
    want = (hc @ hc.T) / np.sum(pq * (1.0 - pq))
    got = np.asarray(dominance_grm(gm), np.float64)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_grm_yang_oracle():
    """GCTA-style per-SNP-standardized GRM == the dense float64
    definition (monomorphic SNPs weighted zero)."""
    from miraculix_tpu.ops.grm import grm_yang

    g = bed.simulate_genotypes(100, 600, seed=17)
    g[:, 5] = 0  # monomorphic: must be excluded, not blow up
    gm = mx.from_dense(g)
    f = np.asarray(gm.freq, np.float64)
    zc = g.astype(np.float64) - 2 * f[None, :]
    pq2 = 2 * f * (1 - f)
    use = pq2 > 1e-12
    want = (zc[:, use] / pq2[use][None, :]) @ zc[:, use].T / use.sum()

    got = np.asarray(grm_yang(gm, block=64), np.float64)
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-4
    np.testing.assert_allclose(got, got.T)


def test_ld_score_matches_dense_oracle(tmp_path, capsys):
    """ld_score == 1 + windowed sum of (adjusted) r^2 computed from a dense
    float64 correlation matrix; CLI writes the TSV."""
    from miraculix_tpu import cli, ld_score
    from miraculix_tpu.io import bed as bedio

    n, snps, window = 150, 400, 32
    geno = bedio.simulate_genotypes(n, snps, seed=77)
    gm = mx.from_dense(geno)

    z = geno.astype(np.float64)
    zc = z - z.mean(axis=0)
    sd = np.sqrt((zc * zc).sum(axis=0))
    sd[sd == 0] = 1.0
    r = (zc.T @ zc) / np.outer(sd, sd)
    r2 = r * r
    for adjusted in (False, True):
        mat = r2 - (1.0 - r2) / (n - 2) if adjusted else r2
        want = np.ones(snps)
        for s in range(snps):
            lo, hi = max(0, s - window), min(snps, s + window + 1)
            want[s] += mat[s, lo:hi].sum() - mat[s, s]
        got = ld_score(gm, window=window, adjusted=adjusted)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)

    p = str(tmp_path / "l.bed")
    bedio.write_bed(p, geno)
    out = str(tmp_path / "sc.tsv")
    assert cli.main(["ld", p, "--score", "--window", str(window),
                     "-o", out]) == 0
    capsys.readouterr()
    rows = [ln.split("\t") for ln in open(out)][1:]
    np.testing.assert_allclose(
        np.array([float(x[1]) for x in rows]),
        ld_score(mx.from_dense(geno), window=window), rtol=1e-4)

    # window >= snps must clamp, not crash (the CLI default window is 512
    # on arbitrarily small panels), and equal the all-pairs score
    got_all = ld_score(gm, window=snps + 64, adjusted=False)
    want_all = np.ones(snps) + r2.sum(axis=0) - np.diag(r2)
    np.testing.assert_allclose(got_all, want_all, rtol=2e-4, atol=2e-4)


def test_ld_prune_respects_chromosomes():
    """With per-SNP chromosome labels, pairs spanning a boundary are never
    pruning candidates (plink windows per chromosome)."""
    from miraculix_tpu import ld_prune
    from miraculix_tpu.io import bed as bedio

    rng = np.random.default_rng(9)
    base = bedio.simulate_genotypes(60, 100, seed=3)
    geno = np.concatenate([base, base], axis=1)  # SNP i == SNP i+100
    gm = mx.from_dense(geno)
    # duplicated pairs are 100 apart; window=128 sees them
    keep_nochrom = ld_prune(gm, window=128, r2_threshold=0.9)
    assert (~keep_nochrom).sum() >= 90  # dup pairs pruned
    chrom = np.array([1] * 100 + [2] * 100)
    keep_chrom = ld_prune(gm, window=128, r2_threshold=0.9, chrom=chrom)
    # the only r^2 > 0.9 pairs cross the boundary -> nothing pruned
    assert keep_chrom.all()


def test_ld_score_respects_chromosomes():
    """With per-SNP chromosome labels, cross-chromosome pairs contribute 0
    to LD scores (gcta windows per chromosome) in both adjusted modes."""
    from miraculix_tpu import ld_score
    from miraculix_tpu.io import bed as bedio

    base = bedio.simulate_genotypes(80, 90, seed=21)
    geno = np.concatenate([base, base], axis=1)  # SNP i == SNP i+90
    gm = mx.from_dense(geno)
    chrom = np.array([1] * 90 + [2] * 90)
    for adjusted in (False, True):
        got = ld_score(gm, window=256, adjusted=adjusted, chrom=chrom)
        # per-chromosome oracle: score each half independently
        half = ld_score(mx.from_dense(base), window=256, adjusted=adjusted)
        np.testing.assert_allclose(got[:90], half, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got[90:], half, rtol=2e-4, atol=2e-4)


def test_packed_crossprod_weighted_oracle(blocks):
    """Weighted crossproduct Z diag(w) Zᵀ == dense float64, to f32 grade
    (f32 products at HIGHEST precision; only f32 rounding), in one K block
    and across K blocks."""
    from miraculix_tpu.ops import grm as grm_ops
    from miraculix_tpu.ops.grm import packed_crossprod_weighted

    g = bed.simulate_genotypes(150, 700, seed=31)
    gm = mx.from_dense(g)
    rng = np.random.default_rng(0)
    w = rng.uniform(0.1, 3.0, 700)
    want = (g.astype(np.float64) * w[None, :]) @ g.astype(np.float64).T
    for block_words in (16, 2048):
        blocks(grm_ops, CROSS_BLOCK_WORDS=block_words)
        got = np.asarray(packed_crossprod_weighted(
            gm.zq_n, jnp.asarray(w, jnp.float32)), np.float64)[:150, :150]
        assert np.abs(got - want).max() / np.abs(want).max() < 5e-6


def test_pairwise_nonmissing_exact():
    """Pairwise co-called counts == exact integer oracle, with and without
    a SNP exclusion mask."""
    from miraculix_tpu import pairwise_nonmissing

    g = bed.simulate_genotypes(120, 500, seed=33, missing_rate=0.1)
    gm = mx.from_dense(g, keep_missing_info=True)
    called = (g != 3)
    want = called.astype(np.int64) @ called.astype(np.int64).T
    got = np.asarray(pairwise_nonmissing(gm), np.int64)
    assert np.array_equal(got, want)
    use = np.zeros(500, bool)
    use[::3] = True
    want_u = called[:, use].astype(np.int64) @ called[:, use].astype(
        np.int64).T
    got_u = np.asarray(pairwise_nonmissing(gm, use=use), np.int64)
    assert np.array_equal(got_u, want_u)


def _gcta_oracle(g, pair_denominator):
    """Dense float64 GCTA --make-grm estimator: per-SNP standardized,
    missing entries contribute 0; denominator = co-called count per pair
    (pair_denominator) or the global used-SNP count."""
    called = (g != 3)
    x = np.where(called, g, 0).astype(np.float64)
    p = called.sum(axis=0).astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        p = np.where(p > 0, x.sum(axis=0) / (2.0 * p), 0.0)
    pq2 = 2.0 * p * (1.0 - p)
    use = pq2 > 1e-12
    zc = np.where(called, x - 2.0 * p[None, :], 0.0)[:, use]
    wt = 1.0 / pq2[use]
    num = (zc * wt[None, :]) @ zc.T
    if pair_denominator:
        cu = called[:, use].astype(np.int64)
        nij = cu @ cu.T
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(nij > 0, num / np.maximum(nij, 1), 0.0)
    return num / use.sum()


def test_grm_yang_missing_exact_global_m():
    """grm_yang on a missing-heavy panel == the dense f64 mean-imputed
    GCTA estimator with the global SNP count (missing entries contribute
    exactly 0 via the sparse correction terms)."""
    from miraculix_tpu.ops.grm import grm_yang

    g = bed.simulate_genotypes(110, 600, seed=35, missing_rate=0.05)
    g[:, 7] = 0  # monomorphic: weight 0, not NaN
    gm = mx.from_dense(g, keep_missing_info=True)
    want = _gcta_oracle(g, pair_denominator=False)
    got = np.asarray(grm_yang(gm), np.float64)
    assert np.abs(got - want).max() / np.abs(want).max() < 5e-6
    np.testing.assert_allclose(got, got.T)


def test_grm_yang_pair_denominator_gcta_interop():
    """grm_yang(pair_denominator=True) == gcta --make-grm's published
    estimator (each pair / its own co-called SNP count) on a 5%-missing
    panel, elementwise."""
    from miraculix_tpu.ops.grm import grm_yang

    g = bed.simulate_genotypes(110, 600, seed=36, missing_rate=0.05)
    gm = mx.from_dense(g, keep_missing_info=True)
    want = _gcta_oracle(g, pair_denominator=True)
    got = np.asarray(grm_yang(gm, pair_denominator=True), np.float64)
    assert np.abs(got - want).max() / np.abs(want).max() < 5e-6


def test_grm_pair_denominator_plink_make_rel():
    """grm(pair_denominator=True) == plink --make-rel missingness
    semantics: pair numerator over co-called SNPs divided by the pair's
    own Σ 2p_sq_s (dense f64 oracle)."""
    g = bed.simulate_genotypes(100, 500, seed=37, missing_rate=0.08)
    gm = mx.from_dense(g, keep_missing_info=True)
    called = (g != 3)
    x = np.where(called, g, 0).astype(np.float64)
    p = np.asarray(gm.freq, np.float64)
    zc = np.where(called, x - 2.0 * p[None, :], 0.0)
    num = zc @ zc.T
    pq2 = 2.0 * p * (1.0 - p)
    den = called.astype(np.float64) @ (pq2[:, None] * called.astype(
        np.float64).T)
    with np.errstate(invalid="ignore", divide="ignore"):
        want = np.where(den > 0, num / den, 0.0)
    got = np.asarray(mx.grm(gm, pair_denominator=True), np.float64)
    assert np.abs(got - want).max() / np.abs(want).max() < 5e-6


def test_cli_grm_pair_denom(tmp_path):
    """cli grm --pair-denom writes the per-pair-denominator GRM for both
    methods (gcta/plink missingness semantics)."""
    from miraculix_tpu import cli
    from miraculix_tpu.io import bed as bedio

    g = bed.simulate_genotypes(60, 300, seed=41, missing_rate=0.05)
    p = str(tmp_path / "pd.bed")
    bedio.write_bed(p, g)
    out = str(tmp_path / "g.npy")
    assert cli.main(["grm", p, "--pair-denom", "-o", out]) == 0
    gm = mx.from_dense(g, keep_missing_info=True)
    want = np.asarray(mx.grm(gm, pair_denominator=True))
    np.testing.assert_allclose(np.load(out), want, rtol=1e-5, atol=1e-6)
    out2 = str(tmp_path / "gy.npy")
    assert cli.main(["grm", p, "--method", "yang", "--pair-denom",
                     "-o", out2]) == 0
    from miraculix_tpu.ops.grm import grm_yang

    want2 = np.asarray(grm_yang(gm, pair_denominator=True))
    np.testing.assert_allclose(np.load(out2), want2, rtol=1e-5, atol=1e-6)


def test_ld_prune_native_matches_python():
    """The native mx_ld_prune scan == the Python greedy loop (the
    semantics oracle) on random panels with duplicates and MAF ties."""
    from miraculix_tpu.io import native as mnative
    from miraculix_tpu.ops.grm import ld_windowed

    if mnative.get_lib() is None or not hasattr(mnative.get_lib(),
                                                "mx_ld_prune"):
        pytest.skip("native codec unavailable")
    rng = np.random.default_rng(19)
    for seed in (1, 2, 3):
        g = bed.simulate_genotypes(150, 500, seed=seed)
        g[:, 200:230] = g[:, 100:130]          # exact duplicates
        g[:, 301] = g[:, 300]                  # MAF tie pair
        gm = mx.from_dense(g)
        w, thr = 96, 0.4
        band2 = ld_windowed(gm, window=w, squared=True)
        f = np.asarray(gm.freq, np.float64)
        maf = np.minimum(f, 1.0 - f)
        # python oracle (the pre-native loop, verbatim semantics)
        keep = np.ones(500, bool)
        for s in range(500):
            if not keep[s]:
                continue
            hi = min(s + 1 + w, 500)
            part = np.arange(s + 1, hi)
            mask = keep[part] & (band2[s, : hi - s - 1] > thr)
            if not mask.any():
                continue
            bad = part[mask]
            drop_self = maf[s] < maf[bad]
            if drop_self.any():
                keep[s] = False
                keep[bad[~drop_self]] = False
                continue
            keep[bad] = False
        got = mnative.ld_prune(band2, maf, thr)
        assert np.array_equal(got, keep), f"seed {seed} diverged"


def test_ld_windowed_missing_correction_matches_full_ld():
    """Banded r with correct_missing == the corrected full ld()'s
    superdiagonals on a 5%-missing panel;
    uncorrected banded == uncorrected full."""
    g = bed.simulate_genotypes(120, 900, seed=51, missing_rate=0.05)
    gm = mx.from_dense(g, keep_missing_info=True)
    w = 48
    for correct in (True, False):
        full = np.asarray(mx.ld(gm, correct_missing=correct))
        band = mx.ld_windowed(gm, window=w, row_block=512,
                              correct_missing=correct)
        want = np.zeros((900, w), np.float32)
        for s in range(900):
            hi = min(s + 1 + w, 900)
            want[s, : hi - s - 1] = full[s, s + 1: hi]
        assert np.abs(band - want).max() < 1e-5, f"correct={correct}"
    # the correction must actually move something at 5% missing
    b0 = mx.ld_windowed(gm, window=w, row_block=512, correct_missing=False)
    b1 = mx.ld_windowed(gm, window=w, row_block=512, correct_missing=True)
    assert np.abs(b0 - b1).max() > 1e-3


def test_ld_score_missing_correction_shifts_scores():
    """LD scores on a missing panel change under the exact correction and
    match the corrected dense-oracle banded sum."""
    from miraculix_tpu import ld_score

    n, snps, w = 130, 400, 32
    g = bed.simulate_genotypes(n, snps, seed=52, missing_rate=0.06)
    gm = mx.from_dense(g, keep_missing_info=True)
    # dense f64 oracle: mean-imputed exact centering (missing -> 0 centered)
    called = (g != 3)
    x = np.where(called, g, 0).astype(np.float64)
    p = np.asarray(gm.freq, np.float64)
    zc = np.where(called, x - 2.0 * p[None, :], 0.0)
    d = np.sqrt((zc * zc).sum(axis=0))
    d[d == 0] = 1.0
    r = (zc.T @ zc) / np.outer(d, d)
    r2 = r * r
    r2adj = r2 - (1.0 - r2) / (n - 2)
    want = np.ones(snps)
    for s in range(snps):
        lo, hi = max(0, s - w), min(snps, s + w + 1)
        for t in range(lo, hi):
            if t != s:
                want[s] += r2adj[s, t]
    got = ld_score(gm, window=w, adjusted=True, correct_missing=True)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    got0 = ld_score(gm, window=w, adjusted=True, correct_missing=False)
    assert np.abs(got0 - want).max() > np.abs(got - want).max() * 5
