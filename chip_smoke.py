"""Smoke run of the packed genotype ops on the GPU, at the reference's
``medium_snps`` GRM panel: 250,000 SNPs x 21,000 individuals.

The panel is simulated from a fixed seed straight to a PLINK .bed fileset
(streamed; the dense panel is never held), ingested with ``mx.from_bed``,
and driven through the entry points a user calls: ``mx.dgemm`` on every
precision tier, ``snp_crossprod``, ``mx.grm``, ``ld_windowed``,
``solve.grm_cg_solve`` and ``gwas_linear``.  Every phase is checked against
a float64 numpy reference that reads the genotypes back from the .bed file
(``bed.read_bed_slice``), not from the device packing; the script exits
non-zero at the first failed check.

    python chip_smoke.py             # one GPU, all phases
    python chip_smoke.py --chips 4   # the sharded paths on 4 GPUs only

The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

import miraculix_tpu as mx
from miraculix_tpu.io import bed, codec

ROOT = os.path.dirname(os.path.abspath(__file__))
SNPS, INDIV = 250_000, 21_000          # reference medium_snps (BASELINE.md)
SAMPLE = 512                           # checked rows / block side
LD_WINDOW, LD_STRETCH = 512, 2048
GWAS_SNPS = 1024

# Limits, relative to max |reference| over the checked sample:
# - fast: B in two bf16 pieces (16 significant bits), f32 accumulation;
# - f32: three pieces (all 24 bits), only f32 accumulation rounds;
# - bf16: one piece, 8 bits of B (~2^-9 relative per element);
# - f64: exact int8 digit products, recombined in float64;
# - GRM / LD: exact int32 crossproduct, finished in f32;
# - solve: residual of the f32 CG, recomputed in float64;
# - GWAS: f32 't' passes feed a float64 host finish.
LIMITS = {"fast": 1e-5, "f32": 1e-5, "bf16": 5e-3, "f64": 1e-12,
          "grm": 1e-5, "ld": 1e-5, "solve": 1e-4, "gwas": 1e-4}


class CheckFailed(SystemExit):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(name: str, err: float, limit: float) -> None:
    ok = bool(np.isfinite(err)) and err <= limit
    log(f"  {name}: max err {err:.3e} (limit {limit:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise CheckFailed(f"check failed: {name}")


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    if got.shape != want.shape:
        raise CheckFailed(f"shape {got.shape} != reference {want.shape}")
    return float(np.abs(got - want).max() / np.abs(want).max())


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def timed(fn, *args, **kw):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kw))
    return out, time.perf_counter() - t0


def compiled(fn, *args):
    """AOT-compile ``fn`` for ``args``; returns (executable, seconds)."""
    import jax

    t0 = time.perf_counter()
    exe = jax.jit(fn).lower(*args).compile()
    return exe, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Reference: float64 numpy from the .bed file
# ---------------------------------------------------------------------------

class Reference:
    """One streaming pass over the .bed file: per-SNP frequencies, the
    per-individual Σz² and Σz·f (the crossproduct and GRM diagonals), and
    the genotype columns / rows every phase checks."""

    def __init__(self, path, n, snps, rows_ab, cols_t, ld0, cols_g,
                 chunk=8192):
        self.n, self.snps = n, snps
        self.freq = np.empty(snps)
        self.zsq = np.zeros(n)
        self.zf = np.zeros(n)
        self.z_ab = np.empty((len(rows_ab), snps), np.uint8)
        want = {"t": cols_t, "ld": np.arange(ld0, ld0 + LD_STRETCH
                                             + LD_WINDOW),
                "gwas": cols_g}
        self.cols = {k: np.empty((n, len(v)), np.uint8)
                     for k, v in want.items()}
        for s0 in range(0, snps, chunk):
            s1 = min(s0 + chunk, snps)
            plink, _, _ = bed.read_bed_slice(path, s0, s1)
            z = codec.plink_to_dense(plink, n)           # [n, width] uint8
            zf32 = z.astype(np.float32)
            f = z.sum(axis=0, dtype=np.int64) / (2.0 * n)
            self.freq[s0:s1] = f
            self.zsq += np.einsum("ij,ij->i", zf32, zf32, dtype=np.float64)
            self.zf += zf32.astype(np.float64) @ f
            self.z_ab[:, s0:s1] = z[rows_ab]
            for k, v in want.items():
                sel = (v >= s0) & (v < s1)
                if sel.any():
                    self.cols[k][:, sel] = z[:, v[sel] - s0]
        self.sigma2 = 2.0 * np.sum(self.freq * (1.0 - self.freq))

    def centered_cols(self, key, snp_idx):
        return (self.cols[key].astype(np.float64)
                - 2.0 * self.freq[snp_idx][None, :])


# ---------------------------------------------------------------------------
# One card
# ---------------------------------------------------------------------------

def run_one_card(path, seed) -> None:
    import jax
    import jax.numpy as jnp

    from miraculix_tpu import solve
    from miraculix_tpu.ops.grm import snp_crossprod

    rng = np.random.default_rng(seed)
    n, snps = INDIV, SNPS
    perm = rng.permutation(n)
    rows_a, rows_b = np.sort(perm[:SAMPLE]), np.sort(perm[SAMPLE:2 * SAMPLE])
    cols_t = np.sort(rng.choice(snps, SAMPLE, replace=False))
    ld0 = int(rng.integers(0, snps - LD_STRETCH - LD_WINDOW))
    cols_g = np.sort(rng.choice(snps, GWAS_SNPS, replace=False))

    t0 = time.perf_counter()
    gm = mx.from_bed(path)
    jax.block_until_ready(gm.zq_t)
    log(f"ingest: from_bed {time.perf_counter() - t0:.1f} s, zq_n "
        f"{tuple(gm.zq_n.shape)} zq_t {tuple(gm.zq_t.shape)}")
    t0 = time.perf_counter()
    ref = Reference(path, n, snps, np.concatenate([rows_a, rows_b]),
                    cols_t, ld0, cols_g)
    log(f"reference pass over the .bed: {time.perf_counter() - t0:.1f} s")
    f = ref.freq
    # dgemm centers with the panel's stored frequencies (f32): the f64
    # tier is checked against them, and they against the .bed (f32
    # storage rounds to half an ulp, 2^-24 relative to each entry)
    f_dev = np.asarray(gm.freq, np.float64)
    check("allele frequencies vs the .bed", rel_err(f_dev, f), 1e-7)
    za = ref.z_ab[:SAMPLE].astype(np.float64)            # Z[A, :]
    zb = ref.z_ab[SAMPLE:].astype(np.float64)            # Z[B, :]
    zt = (ref.cols["t"].astype(np.float64)
          - 2.0 * f_dev[cols_t][None, :])                # Zc[:, S]

    # -- dgemm -------------------------------------------------------------
    cases = [("fast", 1), ("fast", 32), ("fast", 128), ("f32", 32),
             ("bf16", 32), ("f64", 4)]
    for tier, ncol in cases:
        for trans in ("n", "t"):
            rows_b_ = snps if trans == "n" else n
            b = rng.standard_normal((rows_b_, ncol)).astype(np.float32)
            if trans == "n":
                want = (za - 2.0 * f_dev[None, :]) @ b.astype(np.float64)
                pick = rows_a
            else:
                want = zt.T @ b.astype(np.float64)
                pick = cols_t
            name = f"dgemm '{trans}' {tier} ncol={ncol}"
            log(f"{name}: B {b.shape}")
            if tier == "f64":
                c, secs = timed(mx.dgemm, gm, b, trans=trans,
                                precision="f64")
                log(f"  wall {secs:.2f} s (compile included)")
            else:
                bj = jnp.asarray(b)
                exe, csecs = compiled(functools.partial(
                    mx.dgemm, trans=trans, precision=tier), gm, bj)
                c, secs = timed(exe, gm, bj)
                _, warm = timed(exe, gm, bj)
                log(f"  compile {csecs:.2f} s, first call {secs:.4f} s, "
                    f"second call {warm:.4f} s")
                log(f"  memory_analysis: {exe.memory_analysis()}")
            check(name, rel_err(np.asarray(c)[pick], want), LIMITS[tier])

    # -- raw crossproduct and GRM -----------------------------------------
    log(f"snp_crossprod: Z Z^T [{n}, {n}] int32 over {snps} SNPs")
    m, secs = timed(snp_crossprod, gm)
    log(f"  wall {secs:.2f} s (compile included)")
    m_host = np.asarray(m)
    del m
    block = m_host[np.ix_(rows_a, rows_b)]
    want_block = np.rint(za @ zb.T).astype(np.int64)
    exact = (m_host.dtype == np.int32
             and np.array_equal(block.astype(np.int64), want_block)
             and np.array_equal(np.diagonal(m_host).astype(np.int64),
                                np.rint(ref.zsq).astype(np.int64)))
    log(f"  {SAMPLE}x{SAMPLE} off-diagonal block and full diagonal "
        f"bit-exact: {exact}")
    if not exact:
        raise CheckFailed("check failed: snp_crossprod")

    log("grm: VanRaden G")
    exe, csecs = compiled(lambda g: mx.grm(g), gm)
    log(f"  compile {csecs:.2f} s; memory_analysis: {exe.memory_analysis()}")
    g_dev, secs = timed(exe, gm)
    log(f"  wall {secs:.2f} s")
    g_blk = np.asarray(g_dev[rows_a][:, rows_b], np.float64)
    g_diag = np.asarray(jnp.diagonal(g_dev), np.float64)
    del g_dev
    za_f = za @ (2.0 * f)
    zb_f = zb @ (2.0 * f)
    c4 = 4.0 * np.sum(f * f)
    want_blk = (za @ zb.T - za_f[:, None] - zb_f[None, :] + c4) / ref.sigma2
    want_diag = (ref.zsq - 4.0 * ref.zf + c4) / ref.sigma2
    scale = max(np.abs(want_blk).max(), np.abs(want_diag).max())
    err = max(np.abs(g_blk - want_blk).max(),
              np.abs(g_diag - want_diag).max()) / scale
    check("grm block + diagonal", err, LIMITS["grm"])

    # -- banded LD ----------------------------------------------------------
    log(f"ld_windowed: window {LD_WINDOW}, all {snps} SNPs")
    band, secs = timed(mx.ld_windowed, gm, LD_WINDOW)
    log(f"  wall {secs:.2f} s (compile included)")
    idx = np.arange(ld0, ld0 + LD_STRETCH + LD_WINDOW)
    zl = ref.centered_cols("ld", idx)
    sd = np.sqrt((zl * zl).sum(axis=0))
    r = (zl.T @ zl) / np.outer(sd, sd)
    want = r[np.arange(LD_STRETCH)[:, None],
             np.arange(LD_STRETCH)[:, None] + 1
             + np.arange(LD_WINDOW)[None, :]]
    err = float(np.abs(band[ld0:ld0 + LD_STRETCH] - want).max())
    check(f"ld_windowed SNPs [{ld0}, {ld0 + LD_STRETCH}) (absolute)", err,
          LIMITS["ld"])

    # -- GBLUP solve ----------------------------------------------------------
    log("grm_cg_solve: (G + I) x = y, G = Zc Zc^T / sigma2")
    y = rng.standard_normal(n)
    res, secs = timed(solve.grm_cg_solve, gm, jnp.asarray(y, jnp.float32),
                      lam=1.0, scale=True, tol=float(1e-5 * np.linalg.norm(y)),
                      maxiter=500)
    x = np.asarray(res.x, np.float64)
    log(f"  wall {secs:.2f} s (compile included), {int(res.iterations)} "
        "iterations")
    # residual in float64 from the exact integer crossproduct:
    # Zc Zc^T = P M P with P the centering projector (f = column means)
    mf = m_host.astype(np.float64)
    del m_host
    px = x - x.mean()
    gx = mf @ px
    gx = (gx - gx.mean()) / ref.sigma2
    resid = y - (gx + x)
    check("grm_cg_solve relative residual",
          float(np.linalg.norm(resid) / np.linalg.norm(y)), LIMITS["solve"])
    del mf

    # -- linear GWAS ---------------------------------------------------------
    log("gwas_linear: y ~ 1 + z_s for every SNP")
    res, secs = timed(mx.gwas_linear, gm, y)
    log(f"  wall {secs:.2f} s (compile included)")
    zg = ref.cols["gwas"].astype(np.float64)
    zg = zg - zg.mean(axis=0)
    want = zg.T @ (y - y.mean()) / (zg * zg).sum(axis=0)
    check(f"gwas_linear beta on {GWAS_SNPS} SNPs",
          rel_err(res.beta[cols_g], want), LIMITS["gwas"])


# ---------------------------------------------------------------------------
# Four cards: the sharded paths against one card, in the same process
# ---------------------------------------------------------------------------

def run_four_cards(path, seed) -> None:
    import jax
    import jax.numpy as jnp

    from miraculix_tpu import parallel as par
    from miraculix_tpu import solve

    devs = jax.devices()
    if len(devs) < 4:
        raise CheckFailed(f"--chips 4 needs 4 GPUs, found {len(devs)}")
    rng = np.random.default_rng(seed)
    n, snps = INDIV, SNPS

    t0 = time.perf_counter()
    gm = mx.from_bed(path)                                 # device 0
    mesh1 = par.make_mesh(4)
    sg = par.shard_genotypes_from_bed(path, mesh1)
    mesh2 = par.make_mesh_2d(4, di=2)
    sg2 = par.shard_genotypes_2d_from_bed(path, mesh2)
    jax.block_until_ready((gm.zq_t, sg.zq_t, sg2.zq_t))
    log(f"ingest: one card + 1D + 2D sharded, "
        f"{time.perf_counter() - t0:.1f} s")
    for name, arr in (("1D zq_n", sg.zq_n), ("1D zq_t", sg.zq_t),
                      ("2D zq_n", sg2.zq_n), ("2D zq_t", sg2.zq_t)):
        shard_devs = sorted({s.device.id for s in arr.addressable_shards})
        log(f"  {name}: shards on devices {shard_devs}")
        if len(shard_devs) != 4:
            raise CheckFailed(f"check failed: {name} not spread over 4 "
                              "devices")

    def compare(name, got, want, limit):
        check(name, rel_err(got, np.asarray(want, np.float64)), limit)

    for trans in ("n", "t"):
        rows = snps if trans == "n" else n
        b = jnp.asarray(rng.standard_normal((rows, 32)), jnp.float32)
        one, s1 = timed(mx.dgemm, gm, b, trans=trans)
        many, s4 = timed(par.sharded_dgemm, sg, b, trans=trans)
        log(f"sharded_dgemm '{trans}' ncol=32: one card {s1:.2f} s, "
            f"1D mesh {s4:.2f} s (compile included)")
        compare(f"sharded_dgemm '{trans}' vs one card", many, one,
                LIMITS["fast"])
        if trans == "n":
            bp = jax.device_put(
                jnp.zeros((sg2.zq_t.shape[0], 32), jnp.float32)
                .at[:snps].set(b),
                jax.sharding.NamedSharding(
                    mesh2, jax.sharding.PartitionSpec(sg2.axes[1], None)))
            many2, s2 = timed(par.sharded_dgemm_2d, sg2, bp, trans="n")
            compare("sharded_dgemm_2d 'n' vs one card",
                    np.asarray(many2)[:n], one, LIMITS["fast"])
        else:
            bp = par.pad_indiv_vec(sg2, b, mesh2)
            many2, s2 = timed(par.sharded_dgemm_2d, sg2, bp, trans="t")
            compare("sharded_dgemm_2d 't' vs one card",
                    np.asarray(many2)[:snps], one, LIMITS["fast"])
        log(f"  2x2 mesh {s2:.2f} s (compile included)")

    sq1 = jax.jit(lambda z: mx.ops.common.packed_row_sq_stats(z))(gm.zq_t)
    sq4 = par.sharded_snp_sq_stats(sg)
    exact = np.array_equal(np.asarray(sq1)[:snps], np.asarray(sq4))
    log(f"sharded_snp_sq_stats vs one card bit-exact: {exact}")
    if not exact:
        raise CheckFailed("check failed: sharded_snp_sq_stats")

    g1, s1 = timed(mx.grm, gm)
    g4, s4 = timed(par.sharded_grm, sg)
    g2d, s2 = timed(par.sharded_grm_2d, sg2)
    log(f"grm: one card {s1:.2f} s, 1D mesh {s4:.2f} s, 2x2 mesh "
        f"{s2:.2f} s (compile included)")
    g1h = np.asarray(g1, np.float64)
    del g1
    compare("sharded_grm vs one card", g4, g1h, LIMITS["grm"])
    del g4
    compare("sharded_grm_2d vs one card", np.asarray(g2d)[:n, :n], g1h,
            LIMITS["grm"])
    del g2d, g1h

    y = jnp.asarray(rng.standard_normal(n), jnp.float32)
    tol = float(1e-5 * np.linalg.norm(np.asarray(y)))
    x1, s1 = timed(solve.grm_cg_solve, gm, y, lam=1.0, scale=True, tol=tol,
                   maxiter=500)
    x4, s4 = timed(par.sharded_cg_solve, sg, y, lam=1.0, scale=True,
                   tol=tol, maxiter=500)
    log(f"cg solve: one card {s1:.2f} s ({int(x1.iterations)} it), "
        f"1D mesh {s4:.2f} s ({int(x4.iterations)} it)")
    compare("sharded_cg_solve vs one card", x4.x, x1.x, LIMITS["solve"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    from miraculix_tpu.utils.compcache import enable_compilation_cache

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devs[0].platform}")
    enable_compilation_cache()
    log(card_line())
    log(f"jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}")

    work = os.path.join(ROOT, ".smoke_data")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    path = os.path.join(work, "medium_snps.bed")
    try:
        t0 = time.perf_counter()
        bed.simulate_bed(path, INDIV, SNPS, seed=args.seed, chunk_snps=8192)
        log(f"host set-up: simulate_bed {INDIV} x {SNPS} "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        if args.chips == 1:
            run_one_card(path, args.seed)
        else:
            run_four_cards(path, args.seed)
        log(f"phases: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    count = len(devs) if args.chips == 4 else 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
