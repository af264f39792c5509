"""Test configuration: run everything on a virtual 8-device CPU mesh.

Tests run on CPU with the Pallas kernel interpreted and an 8-device virtual
mesh for sharding tests, per the multi-chip test plan in SURVEY.md §4
("1-chip vs N-chip equality").  With MIRACULIX_TPU_TEST_GPU=1 the platform
is left to JAX, so the ``gpu``-marked checks run compiled on a card:
``MIRACULIX_TPU_TEST_GPU=1 python -m pytest tests -m gpu``.
"""
import os

# CLI entry points invoked inside tests call enable_compilation_cache(),
# which flips jax's persistent cache on PROCESS-WIDE for every later
# compile in the suite; serializing one of the larger executables
# segfaulted jaxlib's cache writer mid-suite (observed r5: crash inside
# compilation_cache.put_executable_and_time at ~80%).  Tests gain nothing
# from a disk cache and should not write to ~/.cache — disable it via the
# documented env knob.
os.environ.setdefault("MIRACULIX_TPU_COMPILE_CACHE", "off")

ON_CARD = os.environ.get("MIRACULIX_TPU_TEST_GPU") == "1"
if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def rng():
    # function-scoped: every test draws from a fresh, identical stream so
    # test selection/order can never change another test's random data
    return np.random.default_rng(42)


@pytest.fixture()
def gpu():
    """Compiled-on-card checks: decided here, never at import time."""
    if jax.default_backend() != "gpu":
        pytest.skip("compiled-on-card check: needs a GPU (run with "
                    "MIRACULIX_TPU_TEST_GPU=1 python -m pytest tests -m gpu)")


@pytest.fixture()
def blocks(monkeypatch):
    """``blocks(module, NAME=value, ...)`` sets a packed op's trace-time
    block constants for one test, so small operands cross block
    boundaries.  Traces made with them are dropped before and after."""
    from miraculix_tpu.ops import dgemm, grm

    jitted = (dgemm.packed_matmul, dgemm.packed_matmul_int8,
              grm.packed_crossprod, grm.packed_crossprod_rect,
              grm.packed_crossprod_weighted)

    def set_blocks(module, **consts):
        for name, value in consts.items():
            monkeypatch.setattr(module, name, value)
        for f in jitted:
            f.clear_cache()

    yield set_blocks
    for f in jitted:
        f.clear_cache()
