"""Multi-PROCESS distributed drive: the process-boundary proof for the
parallel layer.

Each invocation is ONE process of an N-process jax.distributed CPU cluster
(4 virtual devices per process).  The checklist crosses every process
boundary the single-process virtual mesh cannot:

1. ``parallel.init_distributed`` — the real bootstrap, not dead code.
2. ``shard_genotypes_from_bed`` — with READ INSTRUMENTATION asserting this
   process touched ONLY the SNP ranges of its own addressable devices.
3. ``sharded_dgemm`` both orientations — 'n' (replicated out) compared
   directly, 't' (row-sharded out, non-addressable) gathered via
   ``host_global`` — against oracle results the parent precomputed.
4. ``sharded_grm`` + preconditioned ``sharded_cg_solve`` vs the oracle.
5. ``save_sharded`` / ``load_sharded`` round trip (save gathers
   non-addressable shards collectively; only process 0 writes).
6. 2D layer: ``shard_genotypes_2d_from_bed`` + ``sharded_dgemm_2d`` +
   ``sharded_cg_solve_2d`` across the same process boundary.

Usage (spawned by parallel.mp_check.run_cluster — see tests/
test_multiprocess.py and __graft_entry__.dryrun_multichip):
    python -m miraculix_tpu.parallel._mp_worker <pid> <nproc> <port> <workdir>
The parent must first write <workdir>/panel.bed and <workdir>/oracle.npz
(mp_check.run_cluster is the oracle recipe).

The reference has no distributed layer at all (its device selection is a
single-GPU env-var pick, /root/reference/src/cuda/cuda_utils.cu:188-248);
this layer is new capability, proven here at the process level.
"""
import os
import sys


def main():
    pid, nproc, port, workdir = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4])
    # devices per process (default 4; mp_check's 4-process case uses 1)
    dpp = int(os.environ.get("MX_MP_DPP", "4"))
    # failure injection: this process index dies mid-drive (rc=3) right
    # before the first collective, so the SURVIVORS' behavior — fail with
    # a clear error, not a silent hang — is what the test observes
    fail_pid = int(os.environ.get("MX_MP_FAIL_PID", "-1"))
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={dpp}")
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")

    from miraculix_tpu import parallel

    got_pid = parallel.init_distributed(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc, process_id=pid)
    assert got_pid == pid == jax.process_index()
    assert len(jax.local_devices()) == dpp
    assert len(jax.devices()) == dpp * nproc

    import numpy as np

    from miraculix_tpu.io import bed as bedio

    bed_path = os.path.join(workdir, "panel.bed")
    oracle = np.load(os.path.join(workdir, "oracle.npz"))

    mesh = parallel.make_mesh()

    # -- 2. per-process ingestion with read instrumentation ----------------
    reads = []
    orig_read = bedio.read_bed_slice_payload

    def instrumented(path, s0, s1):
        reads.append((s0, s1))
        return orig_read(path, s0, s1)

    bedio.read_bed_slice_payload = instrumented
    try:
        sg = parallel.shard_genotypes_from_bed(bed_path, mesh)
        # device at mesh position j owns SNP range [j*spd, (j+1)*spd); THIS
        # process's addressable devices are positions dpp*pid..dpp*(pid+1)
        own = {j * sg.spd for j in range(dpp * pid, dpp * (pid + 1))}
        got = {s0 for s0, _ in reads}
        assert got, "no reads recorded — instrumentation failed"
        assert got <= own, (
            f"process {pid} read SNP ranges {sorted(got - own)} outside its "
            f"addressable devices' ranges {sorted(own)}")
        assert got == own, (
            f"process {pid} skipped its own ranges: {sorted(own - got)}")
    finally:
        bedio.read_bed_slice_payload = orig_read
    print(f"[{pid}] ingestion reads confined to own ranges: "
          f"{sorted(s0 for s0, _ in reads)}", flush=True)

    if pid == fail_pid:
        # failure injection: die BEFORE the first collective — every
        # surviving process is now waiting on a peer that will never
        # arrive and must surface a timeout error, not hang forever
        print(f"[{pid}] MP_FAIL_INJECTED — exiting before the first "
              "collective", flush=True)
        os._exit(3)

    # -- 3. sharded dgemm both orientations vs oracle ----------------------
    b_n = oracle["b_n"]
    b_t = oracle["b_t"]
    c_n = parallel.sharded_dgemm(sg, b_n, trans="n", center=True)
    assert c_n.is_fully_replicated           # replicated output
    np.testing.assert_allclose(parallel.host_global(c_n), oracle["c_n"],
                               rtol=2e-4, atol=2e-4)
    # the panel itself must be genuinely distributed: sharded over all 8
    # devices, most of them on the OTHER process
    assert not sg.zq_n.is_fully_addressable
    assert not sg.zq_n.is_fully_replicated
    c_t = parallel.sharded_dgemm(sg, b_t, trans="t", center=True)
    np.testing.assert_allclose(parallel.host_global(c_t)[: sg.snps],
                               oracle["c_t"], rtol=2e-4, atol=2e-4)
    print(f"[{pid}] sharded_dgemm n+t match oracle", flush=True)

    # -- 4. GRM + preconditioned CG vs oracle ------------------------------
    grm = parallel.sharded_grm(sg, scale=True)
    np.testing.assert_allclose(parallel.host_global(grm), oracle["grm"],
                               rtol=2e-4, atol=2e-4)
    lam = float(oracle["lam"])
    rhs = oracle["rhs"]
    res = parallel.sharded_cg_solve(sg, rhs, lam=lam, tol=1e-6,
                                    maxiter=400, precondition=True)
    x = parallel.host_global(res.x)
    gx = oracle["g_unscaled"] @ x + lam * x
    rel = np.linalg.norm(gx - rhs) / np.linalg.norm(rhs)
    assert rel < 1e-4, f"CG residual {rel}"
    print(f"[{pid}] sharded_cg_solve residual {rel:.2e} "
          f"in {int(res.iterations)} iters", flush=True)

    # -- 5. sharded checkpoint round trip ----------------------------------
    ckpt = os.path.join(workdir, "ckpt.npz")
    parallel.save_sharded(ckpt, sg)        # collective gather, rank-0 write
    sg_re = parallel.load_sharded(ckpt, mesh)
    c_re = parallel.sharded_dgemm(sg_re, b_n, trans="n", center=True)
    np.testing.assert_allclose(parallel.host_global(c_re),
                               parallel.host_global(c_n), rtol=1e-6)
    print(f"[{pid}] save/load_sharded round trip ok", flush=True)

    # -- 6. 2D layer across the process boundary ---------------------------
    mesh2 = parallel.make_mesh_2d()
    sg2 = parallel.shard_genotypes_2d_from_bed(bed_path, mesh2)
    c2 = parallel.sharded_dgemm_2d(
        sg2, parallel.pad_snp_vec(sg2, b_n), trans="n")
    np.testing.assert_allclose(parallel.host_global(c2)[: sg.indiv],
                               oracle["c_n"], rtol=2e-4, atol=2e-4)
    res2 = parallel.sharded_cg_solve_2d(sg2, rhs, lam=lam, tol=1e-6,
                                        maxiter=400, precondition=True)
    x2 = parallel.host_global(res2.x)[: sg.indiv]  # 1-D rhs -> squeezed x
    gx2 = oracle["g_unscaled"] @ x2 + lam * x2
    rel2 = np.linalg.norm(gx2 - rhs) / np.linalg.norm(rhs)
    assert rel2 < 1e-4, f"2D CG residual {rel2}"
    print(f"[{pid}] 2D dgemm + CG ok (residual {rel2:.2e})", flush=True)

    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("mp_drive_done")
    print(f"[{pid}] MP_DRIVE_OK", flush=True)


if __name__ == "__main__":
    main()
