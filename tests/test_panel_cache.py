"""Packed-panel cache: repeated R-API / direct-PLINK calls must reuse the
device-resident pack."""
import numpy as np
import pytest

from miraculix_tpu import api
from miraculix_tpu.formats import Coding, CodedMatrix, encode
from miraculix_tpu.io import bed, codec
from miraculix_tpu.utils import panel_cache


@pytest.fixture(autouse=True)
def _fresh_cache():
    panel_cache.clear()
    yield
    panel_cache.clear()


def _plink_panel(indiv=64, snps=96, seed=1):
    g = bed.simulate_genotypes(indiv, snps, seed=seed)
    return codec.dense_to_plink(g), g


def test_dgemm_plink_reuses_pack():
    plink, g = _plink_panel()
    b = np.random.default_rng(0).standard_normal((g.shape[1], 4)).astype(np.float32)
    api.set_options()
    c1 = api.dgemm_plink("n", plink, None, g.shape[1], g.shape[0], None, B=b)
    assert panel_cache.misses == 1
    c2 = api.dgemm_plink("n", plink, None, g.shape[1], g.shape[0], None, B=b)
    assert panel_cache.hits == 1 and panel_cache.misses == 1
    np.testing.assert_allclose(c1, c2)


def test_cache_distinguishes_content():
    plink, g = _plink_panel(seed=1)
    plink2, g2 = _plink_panel(seed=2)
    b = np.ones((g.shape[1], 2), np.float32)
    api.set_options()
    api.dgemm_plink("n", plink, None, g.shape[1], g.shape[0], None, B=b)
    api.dgemm_plink("n", plink2, None, g2.shape[1], g2.shape[0], None, B=b)
    assert panel_cache.misses == 2 and panel_cache.hits == 0


def test_free_compressed_evicts():
    plink, g = _plink_panel()
    api.set_options()
    obj = api.plink2compressed(plink, None, g.shape[1], g.shape[0])
    api.free_compressed(obj)
    obj2 = api.plink2compressed(plink, None, g.shape[1], g.shape[0])
    assert obj2.zq_n is not None  # not the freed object served from cache
    assert panel_cache.misses == 2


def test_rapi_as_geno_cached():
    from miraculix_tpu import rapi

    g = bed.simulate_genotypes(32, 48, seed=3)
    m = CodedMatrix(encode(g, Coding.TWO_BIT), Coding.TWO_BIT,
                    g.shape[1], g.shape[0])
    v = np.ones(g.shape[1], np.float32)
    r1 = rapi.geno_vector(m, v)
    r2 = rapi.geno_vector(m, v)
    assert panel_cache.hits >= 1
    np.testing.assert_allclose(r1, r2)
