"""Segment-sum sparse x genotype path: O(nnz) gather
path must match the densified packed-matmul path and the numpy oracle, and serve
pedigree-incidence n_idx scales the dense path cannot."""
import numpy as np
import pytest

from miraculix_tpu import from_dense
from miraculix_tpu.io import bed
from miraculix_tpu.ops.sparse import (sparse_times_geno,
                                      sparse_times_geno_segsum)


@pytest.fixture()
def rng():
    return np.random.default_rng(11)


def _random_csr(rng, n_rows, n_cols, density=0.25):
    s = (rng.random((n_rows, n_cols)) < density) * rng.standard_normal(
        (n_rows, n_cols))
    ia = np.concatenate([[0], np.cumsum((s != 0).sum(axis=1))]) + 1
    ja = np.nonzero(s)[1] + 1
    return ia, ja, s[s != 0], s


@pytest.mark.parametrize("ts,tg", [("n", "n"), ("n", "t"),
                                   ("t", "n"), ("t", "t")])
def test_segsum_matches_dense_path(rng, ts, tg):
    g = bed.simulate_genotypes(40, 48, seed=9)
    gm = from_dense(g)
    contract = 40 if tg == "n" else 48
    n_idx = 6
    if ts == "n":
        ia, ja, a, s = _random_csr(rng, n_idx, contract)
        s_eff = s
    else:
        ia, ja, a, s = _random_csr(rng, contract, n_idx)
        s_eff = s.T
    dense = np.asarray(sparse_times_geno(
        gm, ia, ja, a, n_idx, trans_sparse=ts, trans_geno=tg,
        method="dense"))
    seg = np.asarray(sparse_times_geno_segsum(
        gm, ia, ja, a, n_idx, trans_sparse=ts, trans_geno=tg))
    z = g.astype(np.float64)
    want = s_eff @ (z if tg == "n" else z.T)
    np.testing.assert_allclose(seg, want, atol=1e-4)
    np.testing.assert_allclose(dense, want, atol=1e-4)


def test_auto_dispatch_large_nidx(rng):
    """n_idx = 20000 >> indiv: auto must take the segsum path (the dense
    path would build a 20000-column RHS) and match the oracle."""
    g = bed.simulate_genotypes(64, 32, seed=10)
    gm = from_dense(g)
    n_idx = 20000
    nnz = 60000
    rows = rng.integers(0, n_idx, nnz)
    cols = rng.integers(0, 64, nnz)
    vals = rng.standard_normal(nnz)
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    ia = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n_idx))]) + 1
    out = np.asarray(sparse_times_geno(gm, ia, cols + 1, vals, n_idx))
    want = np.zeros((n_idx, 32))
    np.add.at(want, rows, vals[:, None] * g.astype(np.float64)[cols])
    assert out.shape == (n_idx, 32)
    np.testing.assert_allclose(out, want, atol=1e-3)


def test_segsum_empty_rows_ok(rng):
    g = bed.simulate_genotypes(16, 16, seed=12)
    gm = from_dense(g)
    # CSR with empty rows at both ends
    ia = np.array([1, 1, 3, 3])
    ja = np.array([2, 5])
    a = np.array([1.0, -2.0])
    out = np.asarray(sparse_times_geno_segsum(gm, ia, ja, a, 3))
    want = np.zeros((3, 16))
    want[1] = 1.0 * g[1] - 2.0 * g[4]
    np.testing.assert_allclose(out, want, atol=1e-5)


def test_segsum_rejects_out_of_range_output_index(rng):
    """trans_sparse='t' puts the user's col indices on the OUTPUT axis,
    where JAX scatter-add silently DROPS out-of-bounds updates — the
    segsum path must raise like the dense path does (review finding)."""
    g = bed.simulate_genotypes(40, 48, seed=9)
    gm = from_dense(g)
    n_idx = 6
    ia, ja, a, s = _random_csr(rng, 40, n_idx)
    ja_bad = ja.copy()
    ja_bad[0] = n_idx + 1          # 1-based index past n_idx
    with pytest.raises(ValueError, match="out of range"):
        sparse_times_geno_segsum(gm, ia, ja_bad, a, n_idx,
                                 trans_sparse="t", trans_geno="n")


def test_auto_respects_explicit_precision(rng):
    """method='auto' must not silently downgrade an explicit f64 request
    to the f32 segsum path; method='segsum' + non-f32 tier raises."""
    g = bed.simulate_genotypes(24, 32, seed=3)
    gm = from_dense(g)
    n_idx = 5000                   # beyond the auto segsum threshold
    ia = np.arange(n_idx + 1) % 2
    ia = np.concatenate([[0], np.cumsum(ia[1:])]) + 1
    nnz = int(ia[-1] - 1)
    ja = (np.arange(nnz) % 24) + 1
    a = np.ones(nnz)
    dense64 = np.asarray(sparse_times_geno(
        gm, ia, ja, a, n_idx, precision="f64", method="dense"))
    auto64 = np.asarray(sparse_times_geno(
        gm, ia, ja, a, n_idx, precision="f64", method="auto"))
    np.testing.assert_array_equal(dense64, auto64)
    with pytest.raises(ValueError, match="segsum"):
        sparse_times_geno(gm, ia, ja, a, n_idx, precision="f64",
                          method="segsum")
