"""REAL multi-process distributed execution.

Spawns 2 OS processes that form a jax.distributed CPU cluster (Gloo
collectives, 4 virtual devices each) and runs the full checklist in
miraculix_tpu/parallel/_mp_worker.py: per-process range-confined .bed
ingestion, sharded dgemm both orientations, GRM, preconditioned CG,
collective checkpoint save/load, and the 2D layer — all checked against a
dense f64 oracle.  This crosses the process boundaries a single-process
virtual mesh never exercises (addressable-shard index math, coordinator
bootstrap, non-addressable gathers in save_sharded).
"""
def test_two_process_cluster_full_drive():
    from miraculix_tpu.parallel import mp_check

    outs = mp_check.run_cluster(num_processes=2, timeout=1100)
    assert len(outs) == 2
    for i, out in enumerate(outs):
        assert "MP_DRIVE_OK" in out, f"process {i}:\n{out}"
        # the instrumentation line proves range confinement ran, not just
        # that nothing crashed
        assert "ingestion reads confined to own ranges" in out


def test_four_process_uneven_panel():
    """4 processes x 1 device each on an 8300-SNP panel: 8300 divides
    neither the device count nor the 2048 SNP-padding quantum, so some
    devices own partial ranges and one owns an empty range — the
    index-math edge cases of multi-host ingestion."""
    from miraculix_tpu.parallel import mp_check

    outs = mp_check.run_cluster(num_processes=4, timeout=1100,
                                snps=8300, devices_per_proc=1)
    assert len(outs) == 4
    for i, out in enumerate(outs):
        assert "MP_DRIVE_OK" in out, f"process {i}:\n{out}"
        assert "ingestion reads confined to own ranges" in out


def test_failure_injection_no_hang():
    """Kill one worker before its first collective: the survivor must
    terminate with a distributed-runtime error within the timeout, not
    hang or report success (production failure behavior)."""
    from miraculix_tpu.parallel import mp_check

    outs = mp_check.run_cluster(num_processes=2, timeout=600,
                                fail_process=1)
    assert "MP_FAIL_INJECTED" in outs[1]
    assert "MP_DRIVE_OK" not in outs[0]
