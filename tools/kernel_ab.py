"""Time the packed ops on one GPU at the reference's ``medium_snps`` shape
(250,000 SNPs x 21,000 individuals, both packed orientations), on random
genotype words made on the device from a seed (fields in {0, 1, 2}; the
products do not depend on the distribution).

Measures, in one process and on one card:

1. ``packed_matmul`` (the Triton decode-matmul kernel), ``fast`` tier, both
   orientations, ncol in {1, 32, 128}: the median of ``--reps`` calls after
   warm-up, synced with ``block_until_ready``, with the error of 64 rows
   against float64 and a run-to-run determinism check.
2. With ``--sweep``: the kernel's block rows, block words, warps, stages
   and K chunk, each configuration checked the same way.
3. The K-blocked int8 crossproduct (the GRM engine) and its op rate.
4. Reference rates on this card: a large bf16 GEMM and a large copy.

Writes the results as JSON lines to stdout and to
``chiprun_out/kernel_ab.jsonl``; any failure ends the run with a non-zero
exit.

    python tools/kernel_ab.py [--reps 10] [--sweep] [--rehearse]
"""
from __future__ import annotations

import argparse
import functools
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SNPS, INDIV = 250_000, 21_000


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def _words(key, rows, kw):
    import jax
    import jax.numpy as jnp

    r = jax.random.bits(key, (rows, kw), jnp.uint32)
    a = r & jnp.uint32(0x55555555)
    b = (r >> 1) & jnp.uint32(0x55555555)
    return ((b & ~a) << 1) | (a & ~b)          # 2-bit fields in {0, 1, 2}


def _median_time(fn, args, reps):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args).block_until_ready()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _compile(fn, *args):
    import jax

    t0 = time.perf_counter()
    c = jax.jit(fn).lower(*args).compile()
    return c, time.perf_counter() - t0


def _check(f, zq, b, w64):
    """(relative error of the first 64 rows against float64, whether a
    second call gives the same bits)."""
    import numpy as np

    y = np.asarray(f(zq, b))
    err = float(np.abs(y[:64] - w64).max() / np.abs(w64).max())
    return err, bool(np.array_equal(y, np.asarray(f(zq, b))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sweep", action="store_true",
                    help="also sweep the kernel's block sizes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on whatever backend (CPU dry run)")
    args = ap.parse_args(argv)
    snps, indiv = (4000, 300) if args.rehearse else (SNPS, INDIV)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from miraculix_tpu.io import codec
    from miraculix_tpu.ops import dgemm as dg
    from miraculix_tpu.ops.grm import packed_crossprod

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.rehearse:
        raise SystemExit(f"kernel_ab needs a GPU, found {dev.platform}")
    card = _card() if dev.platform == "gpu" else "none"

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    log = open(os.path.join(ROOT, "chiprun_out", "kernel_ab.jsonl"), "w")

    def emit(rec):
        line = json.dumps({"card": card, "device_kind": dev.device_kind,
                           **rec})
        print(line, flush=True)
        log.write(line + "\n")
        log.flush()

    k1, k2 = jax.random.split(jax.random.PRNGKey(args.seed))
    ipad, kw_n = codec.planar16_dims(indiv, snps, row_mult=256)
    spad, kw_t = codec.planar16_dims(snps, indiv, row_mult=256)
    zq = {"n": _words(k1, ipad, kw_n), "t": _words(k2, spad, kw_t)}
    cols = {"n": snps, "t": indiv}
    rng = np.random.default_rng(args.seed)

    def ref_rows(trans, b):
        d64 = codec.unpack_planar16(np.asarray(zq[trans][:64]), 64,
                                    cols[trans]).astype(np.float64)
        return d64 @ np.asarray(b, np.float64)

    # 1. the kernel, fast tier
    for trans, ncol in itertools.product(("n", "t"), (1, 32, 128)):
        b = jnp.asarray(rng.standard_normal((cols[trans], ncol)),
                        jnp.float32)
        kern, ck = _compile(functools.partial(
            dg.packed_matmul, precision="fast"), zq[trans], b)
        err, same = _check(kern, zq[trans], b, ref_rows(trans, b))
        emit({"op": "dgemm_fast", "trans": trans, "ncol": ncol,
              "rows": int(zq[trans].shape[0]),
              "words": int(zq[trans].shape[1]),
              "kernel_s": _median_time(kern, (zq[trans], b), args.reps),
              "compile_s": ck, "rel_err_f64": err, "deterministic": same,
              "memory": str(kern.memory_analysis())})

    # 2. blocking sweep: the constants are read when the kernel is traced,
    # and every configuration compiles a fresh trace
    if args.sweep:
        names = ("BLOCK_ROWS", "BLOCK_WORDS", "NUM_WARPS", "NUM_STAGES",
                 "CHUNK_WORDS")
        defaults = tuple(getattr(dg, k) for k in names)
        configs = [(bm, bkw, warps, stages, dg.CHUNK_WORDS)
                   for bm, bkw, warps, stages in itertools.product(
                       (64, 128), (32, 64), (4, 8), (2, 3))]
        configs += [defaults[:4] + (cw,) for cw in (512, 2048, 1 << 20)]
        try:
            for trans, ncol in (("n", 32), ("t", 1)):
                b = jnp.asarray(rng.standard_normal((cols[trans], ncol)),
                                jnp.float32)
                w64 = ref_rows(trans, b)
                for cfg in configs:
                    for k, v in zip(names, cfg):
                        setattr(dg, k, v)
                    f, cs = _compile(functools.partial(
                        dg.packed_matmul.__wrapped__, precision="fast"),
                        zq[trans], b)
                    err, same = _check(f, zq[trans], b, w64)
                    emit({"op": "sweep", "trans": trans, "ncol": ncol,
                          **dict(zip(names, cfg)),
                          "seconds": _median_time(f, (zq[trans], b),
                                                  args.reps),
                          "compile_s": cs, "rel_err_f64": err,
                          "deterministic": same})
        finally:
            for k, v in zip(names, defaults):
                setattr(dg, k, v)

    # 3. the int8 crossproduct
    z = zq["n"]
    cross, cs = _compile(packed_crossprod, z)
    cross(z).block_until_ready()
    t = _median_time(cross, (z,), max(3, args.reps // 3))
    emit({"op": "crossprod", "rows": int(z.shape[0]),
          "words": int(z.shape[1]), "seconds": t, "compile_s": cs,
          "int8_ops_per_s": 2.0 * z.shape[0] ** 2 * 16 * z.shape[1] / t,
          "memory": str(cross.memory_analysis())})

    # 4. reference rates on this card: a large bf16 GEMM and a large copy
    side, words = (512, 1 << 20) if args.rehearse else (8192, 1 << 28)
    a = jnp.ones((side, side), jnp.bfloat16)
    mm = jax.jit(lambda x: jnp.dot(x, x, preferred_element_type=jnp.float32))
    mm(a).block_until_ready()
    tm = _median_time(mm, (a,), args.reps)
    xs = jnp.ones((words,), jnp.float32)
    cp = jax.jit(lambda x: x * 2.0)
    cp(xs).block_until_ready()
    tc = _median_time(cp, (xs,), args.reps)
    emit({"op": "reference_rates",
          "bf16_gemm_flops_per_s": 2.0 * side ** 3 / tm,
          "copy_bytes_per_s": 2.0 * xs.size * 4 / tc})
    log.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
