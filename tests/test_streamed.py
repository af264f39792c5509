"""Out-of-core streamed panel: chunked results must
equal the in-memory paths exactly (same kernels, same centering math)."""
import numpy as np
import pytest

from miraculix_tpu import from_dense
from miraculix_tpu.io import bed
from miraculix_tpu.ops.dgemm import dgemm
from miraculix_tpu.streamed import StreamedGeno


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sg") / "panel.bed")
    g = bed.simulate_genotypes(96, 700, seed=31)
    bed.write_bed(path, g)
    sg = StreamedGeno.from_bed(path, chunk_snps=256)  # 3 chunks, last ragged
    gm = from_dense(g)
    return g, sg, gm


def test_chunking_covers_panel(panel):
    g, sg, gm = panel
    assert sg.n_chunks == 3
    assert sg.bounds[-1] == (512, 700)
    np.testing.assert_allclose(sg.freq, np.asarray(gm.freq), atol=1e-6)


@pytest.mark.parametrize("trans", ["n", "t"])
@pytest.mark.parametrize("center", [True, False])
def test_streamed_dgemm_matches_memory(panel, trans, center):
    g, sg, gm = panel
    rng = np.random.default_rng(0)
    rows = 700 if trans == "n" else 96
    b = rng.standard_normal((rows, 8)).astype(np.float32)
    got = sg.dgemm(b, trans=trans, center=center)
    want = np.asarray(dgemm(gm, b, trans=trans, center=center))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_streamed_grm_matvec(panel):
    g, sg, gm = panel
    rng = np.random.default_rng(1)
    x = rng.standard_normal(96).astype(np.float32)
    got = sg.grm_matvec(x)
    f = np.asarray(gm.freq, np.float64)
    zc = g.astype(np.float64) - 2.0 * f[None, :]
    want = zc @ (zc.T @ x.astype(np.float64))
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4


def test_streamed_cg_converges(panel):
    g, sg, gm = panel
    rng = np.random.default_rng(2)
    y = rng.standard_normal(96)
    x, iters, rel = sg.cg_solve(y, lam=1.0, tol=1e-6, maxiter=300)
    f = np.asarray(gm.freq, np.float64)
    zc = g.astype(np.float64) - 2.0 * f[None, :]
    a = zc @ zc.T / sg.sigma2 + 1.0 * np.eye(96)
    resid = np.linalg.norm(a @ x - y) / np.linalg.norm(y)
    assert resid < 1e-4
    assert iters < 300


def test_cache_to_device_hybrid(tmp_path):
    """Hybrid resident/streamed: cached chunks give identical results and
    the budget caps how many chunks are pinned."""
    path = str(tmp_path / "p.bed")
    g = bed.simulate_genotypes(64, 520, seed=7)
    bed.write_bed(path, g)
    sg = StreamedGeno.from_bed(path, chunk_snps=256)
    assert sg.n_chunks == 3
    first = int(sg.chunks[0].zq_n.nbytes + sg.chunks[0].zq_t.nbytes)
    assert sg.cache_to_device(budget_bytes=first) == 1
    assert not isinstance(sg.chunks[0].zq_n, np.ndarray)  # device array now
    assert isinstance(sg.chunks[1].zq_n, np.ndarray)      # still host
    rng = np.random.default_rng(3)
    x = rng.standard_normal(64).astype(np.float32)
    got = sg.grm_matvec(x)
    gm = from_dense(g)
    f = np.asarray(gm.freq, np.float64)
    zc = g.astype(np.float64) - 2.0 * f[None, :]
    want = zc @ (zc.T @ x.astype(np.float64))
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4
    # idempotent; big-enough budget pins the rest
    assert sg.cache_to_device(budget_bytes=sg.nbytes()) == 3
    assert not isinstance(sg.chunks[2].zq_n, np.ndarray)
    got2 = sg.grm_matvec(x)
    np.testing.assert_allclose(got2, got, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("trans", ["n", "t"])
def test_streamed_colmeans_matches_memory(tmp_path, trans):
    """'colmeans' streams exactly: from_bed injects the WHOLE-panel
    pseudo-frequencies (combined from additive chunk sum/called stats,
    missing-aware) into every chunk, so the chunked accumulation equals
    the materialized GenoMatrix result."""
    path = str(tmp_path / "cm.bed")
    g = bed.simulate_genotypes(96, 700, seed=33, missing_rate=0.05)
    bed.write_bed(path, g)
    sg = StreamedGeno.from_bed(path, chunk_snps=256)
    gm = from_dense(g)
    # the injected global pseudo-freq must equal the materialized panel's
    np.testing.assert_allclose(sg.pseudo_freq, np.asarray(gm.pseudo_freq),
                               atol=1e-6)
    rng = np.random.default_rng(6)
    rows = 700 if trans == "n" else 96
    b = rng.standard_normal((rows, 4)).astype(np.float32)
    got = sg.dgemm(b, trans=trans, center="colmeans")
    want = np.asarray(dgemm(gm, b, trans=trans, center="colmeans"))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_streamed_user_center_vector(panel):
    """A per-SNP user centering vector restricts to each chunk's slice."""
    g, sg, gm = panel
    rng = np.random.default_rng(5)
    u = rng.uniform(0.0, 2.0, size=700)
    b = rng.standard_normal((700, 3)).astype(np.float32)
    got = sg.dgemm(b, trans="n", center=u)
    from miraculix_tpu.ops.dgemm import dgemm
    want = np.asarray(dgemm(gm, b, trans="n", center=u))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


_STREAMED_F64_SCRIPT = """
import jax
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")
import numpy as np
from miraculix_tpu.io import bed
from miraculix_tpu.streamed import StreamedGeno
import sys
g = bed.simulate_genotypes(64, 900, seed=11)
bed.write_bed(sys.argv[1], g)
sg = StreamedGeno.from_bed(sys.argv[1], chunk_snps=256)
b = np.random.default_rng(0).standard_normal((900, 2))
got = sg.dgemm(b, trans="n", center=True, precision="f64")
f = np.asarray(sg.freq, np.float64)
want = (g.astype(np.float64) - 2.0 * f[None, :]) @ b
rel = np.abs(got - want).max() / np.abs(want).max()
assert got.dtype == np.float64 and rel < 1e-12, rel
print("ok")
"""


def test_streamed_f64_tier_exact_under_x64(tmp_path):
    """precision='f64' streams without rounding through f32: the chunk
    accumulator and the RHS stay float64, so the exact integer-digit tier's
    ~1e-15 grade survives chunked accumulation (x64 subprocess, as in
    tests/test_dgemm.py)."""
    import subprocess
    import sys

    res = subprocess.run(
        [sys.executable, "-c", _STREAMED_F64_SCRIPT,
         str(tmp_path / "f64s.bed")],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "ok" in res.stdout


def test_streamed_grm_diag_and_pcg(panel):
    """Streamed exact diagonal (chunk-additive) matches the dense oracle;
    preconditioned streamed CG reaches the same solution."""
    g, sg, gm = panel
    f = np.asarray(gm.freq, np.float64)
    zc = g.astype(np.float64) - 2.0 * f[None, :]
    np.testing.assert_allclose(sg.grm_diag(), np.sum(zc * zc, axis=1),
                               rtol=1e-5)
    rng = np.random.default_rng(8)
    y = rng.standard_normal(96)
    x_p, it_p, rel_p = sg.cg_solve(y, lam=1.0, tol=1e-6, maxiter=300,
                                   precondition=True)
    a = zc @ zc.T / sg.sigma2 + np.eye(96)
    assert np.linalg.norm(a @ x_p - y) / np.linalg.norm(y) < 1e-4
