"""Dispatch-level tests for the benchmark suite CLI.

The bench functions themselves need a GPU; these tests stub them
and check main()'s suite/panel routing — the layer that broke when a
grm-only panel name (ref_many_snps) crashed the dgemm branch.
"""
import json

import miraculix_tpu.benchmark as bm


def _run(monkeypatch, capsys, argv):
    calls = []

    def stub(name):
        def f(panel=None, **kw):
            calls.append((name, panel))
            return {"suite": name, "panel": panel}
        return f

    monkeypatch.setattr(bm, "bench_dgemm", stub("dgemm"))
    monkeypatch.setattr(bm, "bench_grm", stub("grm"))
    monkeypatch.setattr(bm, "bench_ld", stub("ld"))
    monkeypatch.setattr(bm, "bench_grm_ref_panel",
                        lambda **kw: calls.append(("ref", None))
                        or {"suite": "grm", "panel": "ref_many_snps"})
    monkeypatch.setattr(bm, "bench_scaling",
                        lambda **kw: {"suite": "scaling"})
    assert bm.main(argv) == 0
    out = [json.loads(line) for line in
           capsys.readouterr().out.strip().splitlines()]
    return calls, out


def test_suite_all_skips_grm_only_panels(monkeypatch, capsys):
    calls, out = _run(monkeypatch, capsys,
                      ["--suite", "all", "--panels", "small", "ref_many_snps"])
    # dgemm and ld must silently skip ref_many_snps, grm must run it
    assert ("dgemm", "small") in calls
    assert ("dgemm", "ref_many_snps") not in calls
    assert ("ld", "ref_many_snps") not in calls
    assert ("ref", None) in calls
    assert ("grm", "small") in calls
    assert any(o.get("suite") == "scaling" for o in out)


def test_single_suite_routing(monkeypatch, capsys):
    calls, out = _run(monkeypatch, capsys,
                      ["--suite", "grm", "--panels", "ref_many_snps"])
    assert calls == [("ref", None)]
    assert out == [{"suite": "grm", "panel": "ref_many_snps"}]


def test_ld_skip_row_for_oversized_panels():
    # real bench_ld short-circuits before any device work for panels whose
    # snps^2 output exceeds HBM — callable on CPU
    row = bm.bench_ld("small")
    assert row["suite"] == "ld" and "skipped" in row


def test_sparse_solve_suite_routing(monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(bm, "bench_sparse_solve",
                        lambda n: calls.append(n) or {"suite": "sparse_solve"})
    assert bm.main(["--suite", "sparse_solve", "--sparse-n", "1234"]) == 0
    assert calls == [1234]


def test_bench_sparse_solve_small_real():
    # the real row at toy size runs fine on CPU and self-checks its residual
    row = bm.bench_sparse_solve(n=300, ncol=2, iters=2)
    assert row["suite"] == "sparse_solve"
    assert row["rel_residual"] < 1e-4


def test_gblup_fullscale_suite_routing(monkeypatch, capsys):
    monkeypatch.setattr(bm, "bench_gblup_fullscale",
                        lambda: {"suite": "gblup_fullscale"})
    assert bm.main(["--suite", "gblup_fullscale"]) == 0
    assert "gblup_fullscale" in capsys.readouterr().out


def test_bench_gblup_fullscale_toy():
    row = bm.bench_gblup_fullscale(snps=4096, indiv=256, chunks=2,
                                   maxiter=200, tol=1e-3)
    assert row["converged"] and row["cg_iterations"] > 0


def test_dgemm_exact_suite_routing(monkeypatch, capsys):
    monkeypatch.setattr(bm, "bench_dgemm_exact",
                        lambda p, ncol: {"suite": "dgemm_exact", "panel": p})
    bm.main(["--suite", "dgemm_exact", "--panels", "small", "--ncol", "4"])
    out = capsys.readouterr().out
    assert '"dgemm_exact"' in out and '"small"' in out
