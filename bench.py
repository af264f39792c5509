"""Benchmark: dgemm_compressed throughput on one card.

Metric: genotype-column-ops/s = snps * indiv * ncol / wall-second for the
centered dgemm_compressed ('n').  Baseline = the only quantitative number the
reference publishes: the 5codes CPU kernel at 150,000 SNPs x 150,000
individuals, repetV=32 columns, 10 cores, best row-chunk -> 5.1 s
(src/miraculix/5codesIntern.h:35-50) = 1.412e11 geno-col-ops/s.

Timing method: N iterations inside one jit via lax.scan with a data
dependence, host-transfer sync, and iters=1 vs iters=N+1 differencing over
interleaved pairs.  Prints ONE JSON line.
"""
import functools
import json
import time

import numpy as np

BASELINE_GENO_COL_OPS = 150_000 * 150_000 * 32 / 5.1  # = 1.412e11

# Panel: 4096 indiv x 65536 snps packed = 67 MB, ncol=32 (the baseline's
# repetV).
INDIV, SNPS, NCOL = 4096, 65536, 32


def main() -> None:
    from miraculix_tpu.utils.compcache import enable_compilation_cache

    enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    from miraculix_tpu.io import bed, codec
    from miraculix_tpu.ops.dgemm import packed_matmul
    from miraculix_tpu.utils.peaks import device_peaks

    # the centered 'n' path is a 2-piece bf16 split, i.e. 4 tensor-core
    # flops per geno-col-op: a reading above peak/4 is measurement error
    roofline_ops = device_peaks()["bf16_flops"] / 4.0
    g = bed.simulate_genotypes(INDIV, SNPS, seed=0)
    zq_n = jnp.asarray(codec.pack_planar16(g, row_mult=256))
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal((SNPS, NCOL)), jnp.float32)
    fvec = jnp.asarray(codec.allele_freq(g).astype(np.float32))

    def step(zq_n, b, f):
        c = packed_matmul(zq_n, b)
        return c - 2.0 * jnp.dot(f, b, precision="highest")[None, :]

    def make(iters):
        @jax.jit
        def many(zq_n, b, f):
            def body(bcur, _):
                out = step(zq_n, bcur, f)
                # scalar feed-forward: serializes iterations, costs nothing
                return bcur * (1 + out[0, 0] * 1e-30), None
            bfin, _ = jax.lax.scan(body, b, None, length=iters)
            return jnp.float32(bfin[0, 0])
        return functools.partial(many, zq_n, b, fvec)

    # INTERLEAVED base/full pairs, so device-speed drift cannot land between
    # the two measurements of one difference
    n_iters = 256
    f_base, f_full = make(1), make(n_iters + 1)
    float(f_base())  # compile both before any timing
    float(f_full())

    def once(fn):
        t0 = time.time()
        float(fn())  # host transfer = real sync
        return time.time() - t0

    # median of 9 pairwise differences (min is optimistically biased when
    # per-call noise rivals the differenced signal), with the quartile
    # spread of the pairwise estimates beside it
    import statistics
    diffs = sorted((once(f_full) - once(f_base)) / n_iters
                   for _ in range(9))
    per = statistics.median(diffs)
    if per <= 0:
        per = min(once(f_full) for _ in range(3)) / (n_iters + 1)
        diffs = [per]

    ops = INDIV * SNPS * NCOL / per
    q1, q3 = diffs[len(diffs) // 4], diffs[(3 * len(diffs)) // 4]
    spread_pct = round(100.0 * (q3 - q1) / per, 1) if per > 0 else None
    result = {
        "metric": "dgemm_compressed geno-col-ops/s (centered 'n', "
                  f"{SNPS}x{INDIV} ncol={NCOL}, 1 card)",
        "device": jax.devices()[0].device_kind,
        "value": round(ops / 1e12, 3),
        "unit": "Tera-ops/s",
        "vs_baseline": round(ops / BASELINE_GENO_COL_OPS, 2),
        "spread": spread_pct,          # interquartile range, % of median
        "n_pairs": len(diffs),
        "roofline_frac": round(ops / roofline_ops, 3),
    }
    if ops > roofline_ops:
        # physically impossible reading -> the measurement, not the
        # kernel, is wrong; flag instead of publishing silently
        result["roofline_warning"] = True
    print(json.dumps(result))


if __name__ == "__main__":
    main()
