"""2D-sharded genotype linear algebra: individuals x SNPs over a 2D mesh.

The 1D layer (miraculix_tpu.parallel.sharded) shards only the SNP axis —
enough while one chip holds the full individual axis.  For the reference's
"large" panels (3.1M individuals x 50K SNPs, or 1M SNPs x 100K individuals,
utils/genotype_simulation_plink/Makefile:1-9) NEITHER axis fits, so this
layer shards both over a Mesh(("i", "k")):

- device (a, b) holds the planar16 packing of genotype block
  Z[i-range(a), k-range(b)] in both orientations;
- dgemm 'n' (C = Z B): B row-sharded over "k", local matmul, psum over "k"
  -> C row-sharded over "i".  No gathers.
- dgemm 't' (C = Zᵀ B): B row-sharded over "i", psum over "i" -> C
  row-sharded over "k".
- The GBLUP CG operator chains 't' into 'n' with exactly two psums per
  iteration and every vector stays sharded — nothing is ever replicated.
- GRM: all_gather of the row blocks along "i", one
  rectangular int8 crossproduct per device, psum over "k" -> G row-sharded
  over "i".

This is the distributed generalization the reference lacks entirely
(SURVEY.md §2.5: single device, OpenMP threads only).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..io import codec
from ..ops.grm import packed_crossprod_rect
from ..solve.cg import CGResult, cg
from ..ops.dgemm import packed_matmul
from .sharded import _round_up


def make_mesh_2d(
    n_devices: Optional[int] = None,
    di: Optional[int] = None,
    axes: Tuple[str, str] = ("i", "k"),
) -> Mesh:
    """2D device mesh: "i" over individuals, "k" over SNPs.  ``di`` defaults
    to the largest power-of-two <= sqrt(n) that divides n."""
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = devs[:n]
    if di is None:
        di = 1
        while (2 * di) ** 2 <= n and n % (2 * di) == 0:
            di *= 2
    dk = n // di
    return Mesh(np.array(devs).reshape(di, dk), axes)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ShardedGeno2D:
    """Genotype matrix block-sharded over a 2D mesh (see module docstring).

    - ``zq_n``: [di*ipd, dk*kw_k] int32, sharded P("i", "k"): device (a,b)'s
      block is the planar16 packing (SNP axis packed) of its Z block.
    - ``zq_t``: [dk*spd, di*kw_i], sharded P("k", "i"): the packed transpose
      of the same block.
    - ``freq``: [dk*spd] sharded P("k"); zero past the real SNP count.
    """

    snps: int
    indiv: int
    ipd: int                  # padded individuals per "i"-slice
    spd: int                  # padded snps per "k"-slice
    axes: Tuple[str, str]
    zq_n: jax.Array
    zq_t: jax.Array
    freq: jax.Array

    def tree_flatten(self):
        return (self.zq_n, self.zq_t, self.freq), (
            self.snps, self.indiv, self.ipd, self.spd, self.axes)

    @classmethod
    def tree_unflatten(cls, aux, children):
        snps, indiv, ipd, spd, axes = aux
        return cls(snps, indiv, ipd, spd, axes, *children)

    @property
    def sigma2(self) -> jax.Array:
        f = self.freq.astype(jnp.float32)
        return 2.0 * jnp.sum(f * (1.0 - f))


def shard_genotypes_2d(
    geno: np.ndarray,
    mesh: Mesh,
    freq: Optional[np.ndarray] = None,
) -> ShardedGeno2D:
    """Pack a dense genotype matrix [indiv, snps] into per-device 2D blocks.

    (Multi-host analogue: each host reads its (i, k) block ranges via
    io.bed.read_bed_slice and packs only those.)
    """
    geno = np.asarray(geno, dtype=np.uint8)
    n_indiv, n_snps = geno.shape
    ai, ak = mesh.axis_names
    di, dk = mesh.shape[ai], mesh.shape[ak]
    ipd = _round_up(-(-n_indiv // di), 2048)
    spd = _round_up(-(-n_snps // dk), 2048)

    if freq is None:
        freq = codec.allele_freq(geno, axis=0)
    freq_pad = np.zeros(dk * spd, dtype=np.float32)
    freq_pad[:n_snps] = np.asarray(freq, dtype=np.float32)

    n_rows, t_rows = [], []
    for a in range(di):
        n_cols_blocks, t_cols_blocks = [], []
        isl = geno[a * ipd: (a + 1) * ipd]
        for b in range(dk):
            blk = isl[:, b * spd: (b + 1) * spd]
            pad = np.zeros((ipd, spd), dtype=np.uint8)
            pad[: blk.shape[0], : blk.shape[1]] = np.where(blk == 3, 0, blk)
            n_cols_blocks.append(codec.pack_planar16(pad, row_mult=8))
            t_cols_blocks.append(codec.pack_planar16(
                np.ascontiguousarray(pad.T), row_mult=8))
        n_rows.append(np.concatenate(n_cols_blocks, axis=1))
        t_rows.append(t_cols_blocks)
    zq_n_host = np.concatenate(n_rows, axis=0)          # [di*ipd, dk*kw_k]
    # zq_t: rows grouped by k-slice, cols by i-slice
    zq_t_host = np.concatenate(
        [np.concatenate([t_rows[a][b] for a in range(di)], axis=1)
         for b in range(dk)], axis=0)                   # [dk*spd, di*kw_i]

    ni = NamedSharding(mesh, P(ai, ak))
    nt = NamedSharding(mesh, P(ak, ai))
    nf = NamedSharding(mesh, P(ak))
    return ShardedGeno2D(
        snps=n_snps, indiv=n_indiv, ipd=ipd, spd=spd, axes=(ai, ak),
        zq_n=jax.device_put(zq_n_host, ni),
        zq_t=jax.device_put(zq_t_host, nt),
        freq=jax.device_put(freq_pad, nf),
    )


def _mesh_of(sg: ShardedGeno2D) -> Mesh:
    sh = sg.zq_n.sharding
    if isinstance(sh, NamedSharding):
        return sh.mesh
    raise ValueError("pass mesh= explicitly")


def sharded_dgemm_2d(
    sg: ShardedGeno2D,
    b: jax.Array,
    trans: str = "n",
    center: bool = True,
    mesh: Optional[Mesh] = None,
) -> jax.Array:
    """dgemm over the 2D mesh.  Inputs/outputs are ROW-SHARDED (zero-padded
    to di*ipd / dk*spd rows):

    'n': B [dk*spd, n] sharded P("k"), returns C [di*ipd, n] sharded P("i").
    't': B [di*ipd, n] sharded P("i"), returns C [dk*spd, n] sharded P("k").

    Use :func:`pad_indiv_vec` / :func:`pad_snp_vec` to build inputs and
    slice ``[:indiv]`` / ``[:snps]`` after fetching.
    """
    mesh = mesh or _mesh_of(sg)
    ai, ak = sg.axes
    trans = trans.lower()
    if b.ndim == 1:
        b = b[:, None]

    if trans == "n":
        def body(zq_n_l, b_l, f_l):
            c = packed_matmul(zq_n_l, b_l)
            if center:
                c = c - 2.0 * jnp.dot(f_l.astype(c.dtype), b_l.astype(c.dtype),
                                precision=jax.lax.Precision.HIGHEST)[None, :]
            return jax.lax.psum(c, ak)

        return jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(ai, ak), P(ak, None), P(ak)),
            out_specs=P(ai, None), check_vma=False,
        )(sg.zq_n, b, sg.freq)

    def body_t(zq_t_l, b_l, f_l):
        c = packed_matmul(zq_t_l, b_l)
        c = jax.lax.psum(c, ai)
        if center:
            colsum = jax.lax.psum(jnp.sum(b_l.astype(c.dtype), axis=0), ai)
            c = c - 2.0 * f_l.astype(c.dtype)[:, None] * colsum[None, :]
        return c

    return jax.shard_map(
        body_t, mesh=mesh,
        in_specs=(P(ak, ai), P(ai, None), P(ak)),
        out_specs=P(ak, None), check_vma=False,
    )(sg.zq_t, b, sg.freq)


def sharded_grm_2d(
    sg: ShardedGeno2D,
    scale: bool = True,
    mesh: Optional[Mesh] = None,
) -> jax.Array:
    """GRM over the 2D mesh: ring all_gather of row blocks along "i", one
    rectangular int8 crossproduct per device, psum over "k".  Returns the
    GRM row-sharded P("i") with shape [di*ipd, di*ipd] (zero-padded)."""
    mesh = mesh or _mesh_of(sg)
    ai, ak = sg.axes
    n = sg.indiv
    if 4 * sg.snps >= 2 ** 31:
        # per-shard rect crossprods are exact int32, but the psum over the
        # "k" axis can wrap when the TOTAL SNP count exceeds the limit the
        # single-card path enforces (ops/grm.py) — raise, don't wrap
        raise ValueError(
            f"{sg.snps} total SNPs could overflow the exact int32 GRM "
            "accumulator across the psum (limit ~536M); chunk the SNP "
            "axis and sum f64 partials")

    def body(zq_n_l):
        z_all = jax.lax.all_gather(zq_n_l, ai, axis=0, tiled=True)
        m = packed_crossprod_rect(zq_n_l, z_all)
        return jax.lax.psum(m, ak)

    m = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(ai, ak),),
        out_specs=P(ai, None), check_vma=False,
    )(sg.zq_n)
    m = m.astype(jnp.float32)
    # Schlather finish on the padded row-sharded layout (padded rows/cols of
    # the raw crossproduct are exactly zero)
    mask = (jnp.arange(m.shape[1]) < n).astype(m.dtype)
    colsum = jnp.dot(m, mask, precision=jax.lax.Precision.HIGHEST)
    total_vec = jnp.dot(mask, m, precision=jax.lax.Precision.HIGHEST)
    total = jnp.sum(total_vec * mask)
    m = m - total_vec[None, :] / n - colsum[:, None] / n + total / (n * n)
    if scale:
        m = m / sg.sigma2.astype(m.dtype)
    rowmask = (jnp.arange(m.shape[0]) < n).astype(m.dtype)
    return m * rowmask[:, None] * mask[None, :]


def pad_indiv_vec(sg: ShardedGeno2D, v: jax.Array,
                  mesh: Optional[Mesh] = None) -> jax.Array:
    """Pad an [indiv(, k)] array to di*ipd rows and shard it P("i")."""
    mesh = mesh or _mesh_of(sg)
    if v.ndim == 1:
        v = v[:, None]
    out = jnp.zeros((sg.zq_n.shape[0], v.shape[1]), v.dtype).at[: v.shape[0]].set(v)
    return jax.device_put(out, NamedSharding(mesh, P(sg.axes[0], None)))


def pad_snp_vec(sg: ShardedGeno2D, v: jax.Array,
                mesh: Optional[Mesh] = None) -> jax.Array:
    """Pad a [snps(, k)] array to dk*spd rows and shard it P("k")."""
    mesh = mesh or _mesh_of(sg)
    if v.ndim == 1:
        v = v[:, None]
    out = jnp.zeros((sg.zq_t.shape[0], v.shape[1]), v.dtype).at[: v.shape[0]].set(v)
    return jax.device_put(out, NamedSharding(mesh, P(sg.axes[1], None)))


def sharded_grm_diag_2d(
    sg: ShardedGeno2D,
    center: bool = True,
    mesh: Optional[Mesh] = None,
) -> jax.Array:
    """diag(Z_c Z_cᵀ) over the 2D mesh, exactly — row-sharded P("i") like
    every other CG vector.  Σ z² comes from per-block packed-word stats
    (psum over "k"); Σ f z is one 'n' dgemm with the sharded frequency
    column; Σ f² is a replicated scalar."""
    mesh = mesh or _mesh_of(sg)
    ai, ak = sg.axes

    def body(zq_local):
        from ..ops.common import packed_row_sq_stats

        return jax.lax.psum(packed_row_sq_stats(zq_local), ak)

    zsq = jax.shard_map(
        body, mesh=mesh, in_specs=(P(ai, ak),), out_specs=P(ai),
        check_vma=False,
    )(sg.zq_n)
    if not center:
        return zsq
    fz = sharded_dgemm_2d(sg, sg.freq[:, None], trans="n", center=False,
                          mesh=mesh)[:, 0]
    f = sg.freq.astype(jnp.float32)
    return zsq - 4.0 * fz + 4.0 * jnp.sum(f * f)


def sharded_cg_solve_2d(
    sg: ShardedGeno2D,
    b: jax.Array,
    lam: float = 0.0,
    center: bool = True,
    tol: float = 1e-2,
    maxiter: int = 1000,
    mesh: Optional[Mesh] = None,
    precondition: bool = False,
) -> CGResult:
    """(G + lam I) x = b over the 2D mesh, G = Z_c Z_cᵀ.  Every CG vector is
    row-sharded P("i"); each iteration runs one 't' pass (psum over "i") and
    one 'n' pass (psum over "k") — two collectives, nothing replicated.

    ``b``: [indiv] or [indiv, k] (padded + sharded internally).  The
    returned ``x`` is the padded row-sharded array; slice ``[:indiv]``.
    """
    mesh = mesh or _mesh_of(sg)
    squeeze = b.ndim == 1
    bp = pad_indiv_vec(sg, b if not squeeze else b[:, None], mesh)
    res = _cg2d_jit(sg, bp, jnp.float32(lam), center, tol, maxiter, mesh,
                    precondition)
    x = res.x[:, 0] if squeeze else res.x
    return CGResult(x, res.iterations, res.residual_norm)


@functools.partial(jax.jit, static_argnames=("center", "tol",
                                             "maxiter", "mesh",
                                             "precondition"))
def _cg2d_jit(sg, bp, lam, center, tol, maxiter, mesh,
              precondition=False) -> CGResult:
    # lam is TRACED (see _cg_jit: REML lambda sweeps must not recompile)
    def op(v):
        zv = sharded_dgemm_2d(sg, v, trans="t", center=center, mesh=mesh)
        # centering subtracts a row-constant 2·fᵀB from EVERY 'n'-output row
        # including the padding; mask the padded rows so CG state stays
        # exactly zero there (only real rows carry the solve).
        snpmask = (jnp.arange(zv.shape[0]) < sg.snps).astype(zv.dtype)
        zv = zv * snpmask[:, None]
        gv = sharded_dgemm_2d(sg, zv, trans="n", center=center, mesh=mesh)
        rowmask = (jnp.arange(v.shape[0]) < sg.indiv).astype(v.dtype)
        gv = gv * rowmask[:, None]
        return gv + lam * v * rowmask[:, None]

    minv = None
    if precondition:
        from ..solve.cg import jacobi_minv

        minv = jacobi_minv(sharded_grm_diag_2d(sg, center=center, mesh=mesh) + lam)
    return cg(op, bp, tol=tol, maxiter=maxiter, minv=minv)


def shard_genotypes_2d_from_bed(
    path: str,
    mesh: Mesh,
    freq: Optional["np.ndarray"] = None,
) -> ShardedGeno2D:
    """Multi-host 2D ingestion: each PROCESS reads and packs only the
    (individual-range x SNP-range) blocks of its own addressable devices.

    .bed is SNP-major, so a block read is the byte subrange
    [i0/4, i1/4) of each SNP row in the shard's SNP range — a strided
    slice of the memory-mapped payload, never the full panel.
    """
    from ..io import bed as bedio
    from ..io import codec as _codec

    ai, ak = mesh.axis_names
    di, dk = mesh.shape[ai], mesh.shape[ak]
    payload, n_snps, n_indiv = bedio.read_bed_payload(path)  # mmap'd
    ipd = _round_up(-(-n_indiv // di), 2048)
    spd = _round_up(-(-n_snps // dk), 2048)

    if freq is None:
        # global per-SNP freq: one pass over the mmap'd payload per SNP
        # (cheap relative to packing; exact missing-aware)
        from ..io import native as _nat

        nat = _nat.bed_ingest(payload, n_snps, n_indiv,
                              _codec.round_up(n_snps, 256),
                              _codec.round_up(max((n_indiv + 15) // 16, 1),
                                              _codec.LANE),
                              ipd * di, spd // 16,
                              want_t=False, want_n=False, want_pfreq=False)
        if nat is not None:
            freq = nat[2]
        else:
            dense = _codec.plink_to_dense(
                np.ascontiguousarray(payload.T), n_indiv)
            freq = _codec.allele_freq(dense, axis=0)
    freq_pad = np.zeros(dk * spd, dtype=np.float32)
    freq_pad[:n_snps] = np.asarray(freq, dtype=np.float32)

    cache = {}

    def block_pack(a: int, bidx: int):
        """(zq_n block [ipd, spd/16], zq_t block [spd, ipd/16]) for device
        block (a, b) — reads only that block's bytes."""
        key = (a, bidx)
        if key in cache:
            return cache[key]
        s0, s1 = bidx * spd, min((bidx + 1) * spd, n_snps)
        i0, i1 = a * ipd, min((a + 1) * ipd, n_indiv)
        dense = np.zeros((ipd, spd), dtype=np.uint8)
        if s1 > s0 and i1 > i0:
            b0, b1 = i0 // 4, (i1 + 3) // 4
            chunk = np.ascontiguousarray(payload[s0:s1, b0:b1])  # block bytes
            dec = _codec.plink_to_dense(
                np.ascontiguousarray(chunk.T), (b1 - b0) * 4)
            dense[: i1 - i0, : s1 - s0] = np.where(
                dec[i0 - 4 * b0: i1 - 4 * b0] == 3, 0,
                dec[i0 - 4 * b0: i1 - 4 * b0])
        zqn = _codec.pack_planar16(dense, row_mult=8)
        zqt = _codec.pack_planar16(np.ascontiguousarray(dense.T), row_mult=8)
        cache[key] = (zqn, zqt)
        return cache[key]

    kwn = spd // 16
    kwt = ipd // 16

    zq_n = jax.make_array_from_callback(
        (di * ipd, dk * kwn), NamedSharding(mesh, P(ai, ak)),
        lambda idx: block_pack((idx[0].start or 0) // ipd,
                               (idx[1].start or 0) // kwn)[0])
    zq_t = jax.make_array_from_callback(
        (dk * spd, di * kwt), NamedSharding(mesh, P(ak, ai)),
        lambda idx: block_pack((idx[1].start or 0) // kwt,
                               (idx[0].start or 0) // spd)[1])
    freq_arr = jax.device_put(freq_pad, NamedSharding(mesh, P(ak)))
    return ShardedGeno2D(
        snps=n_snps, indiv=n_indiv, ipd=ipd, spd=spd, axes=(ai, ak),
        zq_n=zq_n, zq_t=zq_t, freq=freq_arr,
    )
