"""Smoke-run every examples/*.py at tiny shapes in a subprocess — the
examples ARE the documentation (reference anchor:
examples/gblup/calculate_gblup.jl), so API drift must break CI, not a
user.  Sizes shrink via each script's argv flags or
the MX_EX_* env knobs; correctness is each script's own internal checks
(they print residuals/accuracies and exit nonzero on failure).
"""
import os
import subprocess
import sys

import pytest

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")

_CASES = {
    "exact_f64_solves.py": (["--snps", "1024", "--indiv", "256"], {}),
    "gblup_pipeline.py": (["--snps", "1536", "--indiv", "200",
                           "--pcs", "3"], {}),
    "grm_solve_cg.py": (["--snps", "1536", "--indiv", "200"], {}),
    "mixblup_sparse_solve.py": (["3000"], {}),
    "ssgblup_pipeline.py": ([], {"MX_EX_ANIM": "160", "MX_EX_GENO": "50",
                                 "MX_EX_SNPS": "512"}),
    "full_pipeline.py": ([], {"MX_EX_N": "150", "MX_EX_NEW": "40",
                              "MX_EX_SNPS": "1536"}),
}


def test_every_example_has_a_case():
    scripts = sorted(f for f in os.listdir(EXAMPLES) if f.endswith(".py"))
    assert scripts == sorted(_CASES), (
        "examples/ and the smoke-test table drifted apart")


@pytest.mark.parametrize("script", sorted(_CASES))
def test_example_runs(script):
    argv, env_extra = _CASES[script]
    env = dict(os.environ)
    env.update(env_extra)
    # subprocesses must land on the virtual CPU mesh like the suite itself
    env["JAX_PLATFORMS"] = "cpu"
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, script), *argv],
        capture_output=True, text=True, timeout=900, env=env)
    assert proc.returncode == 0, (
        f"{script} failed (rc={proc.returncode})\n"
        f"stdout:\n{proc.stdout[-3000:]}\nstderr:\n{proc.stderr[-3000:]}")
