"""Multi-card / multi-host execution: SNP-sharded genotype linear algebra.

The reference is a single-node library (one GPU chosen by env var,
src/cuda/cuda_utils.cu:188-248; OpenMP threads on CPU) — its only "model
parallelism" is the K-axis column-blocking of the 5codes GEMM with a private
accumulator per block and a tree reduction (src/miraculix/5codesIntern.h:
57-99,321-342).  This module is the distributed generalization this package
adds as a first-class layer: the SNP axis is sharded across a
``jax.sharding.Mesh``, every device packs/owns its local planar16 shard, and
partial products merge with ``psum`` / ``psum_scatter`` collectives.

Sharding layout (mesh axis "k" over the SNP dimension):

- ``zq_n`` [indiv_pad, D*kw_local], axis 1 sharded: device d's block is the
  planar16 packing of its own SNP range — a concatenation of valid local
  packings, NOT a global packing split (planar16 is plane-local).
- ``zq_t`` [D*spd, kw_indiv], axis 0 sharded (spd = snps-per-device): rows
  are SNPs, so 't' products need no collective at all.
- dgemm 'n' (contract SNPs): local packed matmul + one psum.
- dgemm 't' (contract individuals): embarrassingly row-parallel.
- GRM: local crossproduct + psum (or psum_scatter for the row-sharded GRM).
- CG: the 't' output (sharded by SNPs) is exactly the 'n' input sharding —
  the GBLUP operator chains with ONE psum per iteration and never leaves
  the devices.

Multi-host ingestion: each host reads only its SNP range of the .bed file
(``plink_slice``), so no host ever materializes the full panel.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..io import codec
from ..ops.dgemm import packed_matmul
from ..ops.grm import packed_crossprod
from ..solve.cg import CGResult


_HIGHEST = jax.lax.Precision.HIGHEST


def make_mesh(n_devices: Optional[int] = None, axis: str = "k") -> Mesh:
    """1D device mesh over the SNP (contraction) axis."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ShardedGeno:
    """SNP-sharded genotype matrix across a mesh (see module docstring)."""

    snps: int
    indiv: int
    spd: int                 # padded snps per device (multiple of 2048)
    axis: str
    zq_n: jax.Array          # [indiv_pad, D*kw_local]  sharded on axis 1
    zq_t: jax.Array          # [D*spd, kw_indiv]        sharded on axis 0
    freq: jax.Array          # [D*spd]                  sharded, zero-padded

    def tree_flatten(self):
        return (self.zq_n, self.zq_t, self.freq), (
            self.snps, self.indiv, self.spd, self.axis)

    @classmethod
    def tree_unflatten(cls, aux, children):
        snps, indiv, spd, axis = aux
        return cls(snps, indiv, spd, axis, *children)

    @property
    def kw_local(self) -> int:
        return self.spd // 16

    @property
    def sigma2(self) -> jax.Array:
        f = self.freq.astype(jnp.float32)
        return 2.0 * jnp.sum(f * (1.0 - f))


def shard_genotypes(
    geno: np.ndarray,
    mesh: Mesh,
    freq: Optional[np.ndarray] = None,
    axis: str = "k",
    row_mult: int = 256,
) -> ShardedGeno:
    """Pack a dense genotype matrix [indiv, snps] into per-device SNP shards.

    Each device's zq_n block is an independent planar16 packing of its SNP
    range (multi-host analogue: each host packs the slice it read from disk).
    """
    geno = np.asarray(geno, dtype=np.uint8)
    n_indiv, n_snps = geno.shape
    d = mesh.shape[axis]
    # per-device SNP count, padded so kw_local is a lane multiple (128*16)
    spd = _round_up(-(-n_snps // d), 2048)
    if freq is None:
        freq = codec.allele_freq(geno, axis=0)
    freq_pad = np.zeros(d * spd, dtype=np.float32)
    freq_pad[:n_snps] = np.asarray(freq, dtype=np.float32)

    n_blocks, t_blocks = [], []
    for i in range(d):
        sl = geno[:, i * spd: (i + 1) * spd]
        pad = np.zeros((n_indiv, spd), dtype=np.uint8)
        pad[:, : sl.shape[1]] = np.where(sl == 3, 0, sl)
        n_blocks.append(codec.pack_planar16(pad, row_mult=row_mult))
        t_blocks.append(codec.pack_planar16(
            np.ascontiguousarray(pad.T), row_mult=8))
    zq_n_host = np.concatenate(n_blocks, axis=1)
    zq_t_host = np.concatenate(t_blocks, axis=0)

    sh1 = NamedSharding(mesh, P(None, axis))
    sh0 = NamedSharding(mesh, P(axis, None))
    shf = NamedSharding(mesh, P(axis))
    return ShardedGeno(
        snps=n_snps,
        indiv=n_indiv,
        spd=spd,
        axis=axis,
        zq_n=jax.device_put(zq_n_host, sh1),
        zq_t=jax.device_put(zq_t_host, sh0),
        freq=jax.device_put(freq_pad, shf),
    )


def shard_genotypes_from_bed(
    path: str,
    mesh: Mesh,
    freq: Optional[np.ndarray] = None,
    axis: str = "k",
    row_mult: int = 256,
) -> ShardedGeno:
    """Multi-host ingestion: build a ShardedGeno where EACH PROCESS reads
    and packs only the SNP ranges of its own addressable devices
    (``jax.make_array_from_callback`` + ``io.bed.read_bed_slice_payload``)
    — no process ever touches the full panel, and each shard goes through
    the fused native ingestion when available."""
    from ..io import bed as bedio
    from ..io import native as _native

    d = mesh.shape[axis]
    n_indiv = bedio._count_lines(path[:-4] + ".fam")
    n_snps = bedio._count_lines(path[:-4] + ".bim")
    spd = _round_up(-(-n_snps // d), 2048)
    kw_local = spd // 16
    ipad = codec.round_up(n_indiv, row_mult)
    kw_indiv = codec.round_up(max((n_indiv + 15) // 16, 1), codec.LANE)

    cache = {}

    def shard_pack(s0: int):
        """(zq_n block [ipad, kw_local], zq_t block [spd, kw_indiv], freq
        [spd]) for the SNP range starting at s0 — one disk read, cached so
        the three make_array callbacks share it."""
        if s0 in cache:
            return cache[s0]
        payload, _, _ = bedio.read_bed_slice_payload(path, s0, s0 + spd)
        width = payload.shape[0]
        nat = None
        if width and _native.get_lib() is not None and hasattr(
                _native.get_lib(), "mx_bed_ingest"):
            nat = _native.bed_ingest(payload, width, n_indiv,
                                     spd, kw_indiv, ipad, kw_local)
        if nat is not None:
            zqt, zqn, fr, _ = nat
            fpad = np.zeros(spd, dtype=np.float32)
            fpad[:width] = fr
        else:
            sl = codec.plink_to_dense(np.ascontiguousarray(payload.T),
                                      n_indiv) if width else \
                np.zeros((n_indiv, 0), np.uint8)
            pad = np.zeros((n_indiv, spd), dtype=np.uint8)
            pad[:, :width] = np.where(sl == 3, 0, sl)
            zqn = codec.pack_planar16(pad, row_mult=row_mult)
            zqt = codec.pack_planar16(np.ascontiguousarray(pad.T), row_mult=8)
            fpad = np.zeros(spd, dtype=np.float32)
            fpad[:width] = codec.allele_freq(sl, axis=0)
        cache[s0] = (zqn, zqt, fpad)
        return cache[s0]

    sh1 = NamedSharding(mesh, P(None, axis))
    sh0 = NamedSharding(mesh, P(axis, None))
    shf = NamedSharding(mesh, P(axis))

    zq_n = jax.make_array_from_callback(
        (ipad, d * kw_local), sh1,
        lambda idx: shard_pack((idx[1].start or 0) // kw_local * spd)[0])
    zq_t = jax.make_array_from_callback(
        (d * spd, kw_indiv), sh0,
        lambda idx: shard_pack(idx[0].start or 0)[1])
    if freq is None:
        freq_arr = jax.make_array_from_callback(
            (d * spd,), shf,
            lambda idx: shard_pack(idx[0].start or 0)[2])
    else:
        fpad = np.zeros(d * spd, np.float32)
        fpad[:n_snps] = np.asarray(freq, np.float32)
        freq_arr = jax.device_put(fpad, shf)

    return ShardedGeno(
        snps=n_snps, indiv=n_indiv, spd=spd, axis=axis,
        zq_n=zq_n, zq_t=zq_t, freq=freq_arr,
    )


def _pad_rows(b: jax.Array, rows: int) -> jax.Array:
    return jnp.zeros((rows, b.shape[1]), b.dtype).at[: b.shape[0]].set(b)


# ---------------------------------------------------------------------------
# Sharded ops (shard_map bodies take LOCAL blocks)
# ---------------------------------------------------------------------------

def sharded_dgemm(
    sg: ShardedGeno,
    b: jax.Array,
    trans: str = "n",
    center: bool = True,
    mesh: Optional[Mesh] = None,
    precision: str = "fast",
) -> jax.Array:
    """dgemm_compressed over the mesh.

    'n': B [snps, n] sharded by SNP rows, C [indiv, n] replicated (one psum).
    't': B [indiv, n] replicated, C [snps, n] sharded by rows (no psum).
    """
    mesh = mesh or _mesh_of(sg)
    ax = sg.axis
    trans = trans.lower()
    if b.ndim == 1:
        b = b[:, None]

    if trans == "n":
        b_pad = _pad_rows(b, sg.zq_t.shape[0])

        def body(zq_n_local, b_local, f_local):
            c = packed_matmul(zq_n_local, b_local, precision=precision)
            if center:
                c = c - 2.0 * jnp.dot(f_local.astype(c.dtype),
                                      b_local.astype(c.dtype),
                                      precision=_HIGHEST)[None, :]
            return jax.lax.psum(c, ax)

        out = jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(None, ax), P(ax, None), P(ax)),
            out_specs=P(None, None), check_vma=False,
        )(sg.zq_n, b_pad, sg.freq)
        return out[: sg.indiv]

    def body_t(zq_t_local, b_rep, f_local):
        c = packed_matmul(zq_t_local, b_rep, precision=precision)
        if center:
            colsum = jnp.sum(b_rep.astype(c.dtype), axis=0)
            c = c - 2.0 * f_local.astype(c.dtype)[:, None] * colsum[None, :]
        return c

    out = jax.shard_map(
        body_t, mesh=mesh,
        in_specs=(P(ax, None), P(None, None), P(ax)),
        out_specs=P(ax, None), check_vma=False,
    )(sg.zq_t, b, sg.freq)
    return out[: sg.snps]


def sharded_grm(
    sg: ShardedGeno,
    scale: bool = True,
    scatter: bool = False,
    mesh: Optional[Mesh] = None,
) -> jax.Array:
    """GRM over the mesh: local integer crossproduct of each SNP shard, then
    a psum merge (``scatter=True`` uses psum_scatter and returns the GRM
    row-sharded over the mesh — the layout a distributed solver wants; the
    rows beyond indiv are zero padding)."""
    mesh = mesh or _mesh_of(sg)
    ax = sg.axis
    n = sg.indiv
    if 4 * sg.snps >= 2 ** 31:
        # the per-shard kernels each pass their LOCAL exactness check, but
        # the int32 psum across shards can still wrap — enforce the global
        # invariant the single-chip path enforces (ops/grm.py)
        raise ValueError(
            f"{sg.snps} total SNPs could overflow the exact int32 GRM "
            "accumulator across the psum (limit ~536M); chunk the SNP "
            "axis and sum f64 partials")

    def body(zq_local):
        m = packed_crossprod(zq_local)
        if scatter:
            return jax.lax.psum_scatter(m, ax, scatter_dimension=0, tiled=True)
        return jax.lax.psum(m, ax)

    m = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(None, ax),),
        out_specs=P(ax, None) if scatter else P(None, None),
        check_vma=False,
    )(sg.zq_n)
    m = m.astype(jnp.float32)  # raw crossproduct is exact int32; finish in f32
    # Schlather finish (docs/grm.md:5-10) in plain XLA; works identically on
    # the replicated and the row-sharded (scatter) layout because padded
    # rows/cols of the raw crossproduct are exactly zero.
    mask = (jnp.arange(m.shape[1]) < n).astype(m.dtype)
    colsum = jnp.dot(m, mask, precision=_HIGHEST)      # [rows] real-col sums
    total_vec = jnp.dot(mask, m, precision=_HIGHEST)   # [cols] real-row sums
    total = jnp.sum(total_vec * mask)
    m = m - total_vec[None, :] / n - colsum[:, None] / n + total / (n * n)
    if scale:
        m = m / sg.sigma2.astype(m.dtype)
    if scatter:
        rowmask = (jnp.arange(m.shape[0]) < n).astype(m.dtype)
        return m * rowmask[:, None] * mask[None, :]  # row-sharded [pad, pad]
    return m[:n, :n]


def sharded_grm_matvec(
    sg: ShardedGeno,
    v: jax.Array,
    center: bool = True,
    mesh: Optional[Mesh] = None,
    snp_weights: Optional[jax.Array] = None,
) -> jax.Array:
    """G·v in ONE shard_map: 't' pass (row-parallel) chains directly into the
    'n' pass (one psum) — the sharded GBLUP operator.

    ``snp_weights`` (optional, [D*spd] sharded like ``sg.freq``, zero on
    padding): per-SNP weights w applied BETWEEN the passes, computing
    Σ_s w_s (z_s − 2f_s)(z_s − 2f_s)ᵀ v — with a 0/1 off-chromosome mask
    this is the exact LOCO operator with NO repacking (the masked rows of
    the 't' output vanish from both the product and its centering term)."""
    mesh = mesh or _mesh_of(sg)
    ax = sg.axis
    if v.ndim == 1:
        v = v[:, None]

    def body(zq_t_local, zq_n_local, f_local, v_rep, w_local):
        zv = packed_matmul(zq_t_local, v_rep)
        fl = f_local.astype(zv.dtype)
        if center:
            colsum = jnp.sum(v_rep.astype(zv.dtype), axis=0)
            zv = zv - 2.0 * fl[:, None] * colsum[None, :]
        if w_local is not None:
            zv = zv * w_local.astype(zv.dtype)[:, None]
        gv = packed_matmul(zq_n_local, zv)
        if center:
            gv = gv - 2.0 * jnp.dot(fl, zv, precision=_HIGHEST)[None, :]
        return jax.lax.psum(gv, ax)

    if snp_weights is None:
        out = jax.shard_map(
            functools.partial(body, w_local=None), mesh=mesh,
            in_specs=(P(ax, None), P(None, ax), P(ax), P(None, None)),
            out_specs=P(None, None), check_vma=False,
        )(sg.zq_t, sg.zq_n, sg.freq, v)
    else:
        out = jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(ax, None), P(None, ax), P(ax), P(None, None),
                      P(ax)),
            out_specs=P(None, None), check_vma=False,
        )(sg.zq_t, sg.zq_n, sg.freq, v, snp_weights)
    return out[: sg.indiv]


def sharded_snp_sq_stats(
    sg: ShardedGeno,
    mesh: Optional[Mesh] = None,
) -> jax.Array:
    """Per-SNP Σ_i z²_is = diag(ZᵀZ), exactly, across the mesh — rows of
    ``zq_t`` ARE SNPs, so this is embarrassingly row-parallel (no
    collective).  Returns [snps] (padding sliced off).  Feeds the GWAS
    per-SNP denominators d_s = z_sᵀ M z_s on a sharded panel."""
    from ..ops.common import packed_row_sq_stats

    mesh = mesh or _mesh_of(sg)
    ax = sg.axis

    out = jax.shard_map(
        packed_row_sq_stats, mesh=mesh,
        in_specs=(P(ax, None),), out_specs=P(ax), check_vma=False,
    )(sg.zq_t)
    return out[: sg.snps]


def sharded_indicator2_dgemm_t(
    sg: ShardedGeno,
    b: jax.Array,
    mesh: Optional[Mesh] = None,
) -> jax.Array:
    """I₂ᵀ b with I₂ the packed genotype==2 indicator panel
    (ops.common.packed_indicator2) — row-parallel like the ordinary 't'
    pass, no collective.  Feeds Σ_i w_i z²_is = (Zᵀw)_s + 2 (I₂ᵀw)_s on a
    sharded panel (logistic GWAS score denominators)."""
    from ..ops.common import packed_indicator2

    mesh = mesh or _mesh_of(sg)
    ax = sg.axis
    if b.ndim == 1:
        b = b[:, None]

    def body(zq_t_local, b_rep):
        return packed_matmul(packed_indicator2(zq_t_local), b_rep)

    out = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(ax, None), P(None, None)),
        out_specs=P(ax, None), check_vma=False,
    )(sg.zq_t, b)
    return out[: sg.snps]


def sharded_weighted_grm_diag(
    sg: ShardedGeno,
    snp_weights: jax.Array,
    mesh: Optional[Mesh] = None,
) -> jax.Array:
    """diag of the SNP-weighted centered operator, exactly:

        d_i = Σ_s w_s (z_is − 2 f_s)²
            = Σ w z² − 4 Σ w f z + 4 Σ w f²,
        Σ_s w_s z²_is = (Z w)_i + 2 (I₂ w)_i

    with I₂ the packed genotype==2 indicator (``packed_indicator2`` is a
    pure bit transform of the planar16 words, so its product rides the
    same packed kernel).  Three skinny 'n'-type local matmuls + one psum —
    the Jacobi preconditioner of the sharded LOCO solver."""
    from ..ops.common import packed_indicator2

    mesh = mesh or _mesh_of(sg)
    ax = sg.axis

    def body(zq_n_local, f_local, w_local):
        wl = w_local.astype(jnp.float32)
        fl = f_local.astype(jnp.float32)
        rhs = jnp.stack([wl, wl * fl], axis=1)              # [spd, 2]
        rows = zq_n_local.shape[0]
        zw = packed_matmul(zq_n_local, rhs)[:rows]
        iw = packed_matmul(packed_indicator2(zq_n_local), wl[:, None])[:rows]
        const = jnp.sum(wl * fl * fl)
        d = zw[:, 0] + 2.0 * iw[:, 0] - 4.0 * zw[:, 1] + 4.0 * const
        return jax.lax.psum(d, ax)

    out = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(None, ax), P(ax), P(ax)),
        out_specs=P(None), check_vma=False,
    )(sg.zq_n, sg.freq, snp_weights)
    return out[: sg.indiv]


def sharded_grm_diag(
    sg: ShardedGeno,
    center: bool = True,
    mesh: Optional[Mesh] = None,
) -> jax.Array:
    """diag(Z_c Z_cᵀ) across the mesh, exactly (solve.grm_diag distributed):
    Σ z² and Σ f z are additive over each device's SNP shard, merged with
    one psum.  Feeds the sharded Jacobi PCG."""
    from ..ops.common import packed_row_sq_stats

    mesh = mesh or _mesh_of(sg)
    ax = sg.axis
    f_pad = _pad_rows(sg.freq[:, None], sg.zq_t.shape[0])

    def body(zq_n_local, f_pad_local, f_local):
        d = packed_row_sq_stats(zq_n_local)
        if center:
            fz = packed_matmul(zq_n_local, f_pad_local)[:, 0]
            fl = f_local.astype(jnp.float32)
            d = d - 4.0 * fz + 4.0 * jnp.sum(fl * fl)
        return jax.lax.psum(d, ax)

    out = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(None, ax), P(ax, None), P(ax)),
        out_specs=P(None), check_vma=False,
    )(sg.zq_n, f_pad, sg.freq)
    return out[: sg.indiv]


def sharded_cg_solve(
    sg: ShardedGeno,
    b: jax.Array,
    lam: float = 0.0,
    center: bool = True,
    tol: float = 1e-2,
    maxiter: int = 1000,
    mesh: Optional[Mesh] = None,
    precondition: bool = False,
    scale: bool = False,
) -> CGResult:
    """(G + lam I) x = b across the mesh — the fully on-device distributed
    GBLUP solve (BASELINE.json north star).  One psum per iteration
    (``precondition=True`` adds a one-time sharded exact-diagonal pass and
    an elementwise multiply per iteration; see solve.cg).  ``scale=True``
    divides G by sigma² = 2Σp(1−p) (VanRaden normalization), matching
    solve.grm_cg_solve's flag."""
    mesh = mesh or _mesh_of(sg)  # resolve outside jit (tracers lack .sharding)
    return _cg_jit(sg, b, jnp.float32(lam), center, tol, maxiter, mesh,
                   precondition, scale)


@functools.partial(jax.jit, static_argnames=("center", "tol",
                                             "maxiter", "mesh",
                                             "precondition", "scale"))
def _cg_jit(sg, b, lam, center, tol, maxiter, mesh,
            precondition=False, scale=False) -> CGResult:
    # lam is TRACED: REML sweeps a fresh lambda every AI iteration, and a
    # static lam recompiled the whole distributed CG per value (the
    # single-chip grm_cg_solve traces it for exactly this reason)
    from ..solve.cg import cg

    s2 = sg.sigma2 if scale else jnp.float32(1.0)

    def op(v):
        gv = sharded_grm_matvec(sg, v, center=center, mesh=mesh)
        return gv / s2 + lam * v

    minv = None
    if precondition:
        from ..solve.cg import jacobi_minv

        minv = jacobi_minv(sharded_grm_diag(sg, center=center, mesh=mesh) / s2 + lam)
    return cg(op, b, tol=tol, maxiter=maxiter, minv=minv)


@functools.partial(jax.jit, static_argnames=("tol", "maxiter", "mesh"))
def sharded_loco_cg_solve(
    sg: ShardedGeno,
    snp_weights: jax.Array,
    b: jax.Array,
    s2_loco: jax.Array,
    lam: jax.Array,
    *,
    tol: float,
    maxiter: int,
    mesh: Mesh,
) -> CGResult:
    """Distributed LOCO solve (G_w / s2_loco + lam I) x = b with G_w the
    off-chromosome-masked operator (``snp_weights`` = 0/1 mask, see
    sharded_grm_matvec) and the matching weighted-diagonal Jacobi
    preconditioner.  The mask is a TRACED [D*spd] argument, so every
    chromosome of a LOCO scan shares ONE compiled executable (the
    single-chip path compiles per chromosome SHAPE; here the shape never
    changes)."""
    from ..solve.cg import cg, jacobi_minv

    def op(v):
        gv = sharded_grm_matvec(sg, v, center=True, mesh=mesh,
                                snp_weights=snp_weights)
        return gv / s2_loco + lam * v

    minv = jacobi_minv(
        sharded_weighted_grm_diag(sg, snp_weights, mesh=mesh) / s2_loco + lam)
    return cg(op, b, tol=tol, maxiter=maxiter, minv=minv)


def _mesh_of(sg: ShardedGeno) -> Mesh:
    sharding = sg.zq_n.sharding
    if isinstance(sharding, NamedSharding):
        return sharding.mesh
    raise ValueError("ShardedGeno arrays carry no NamedSharding; pass mesh=")


def host_global(x: jax.Array) -> np.ndarray:
    """Fetch a (possibly cross-process-sharded) array to host numpy on EVERY
    process.  ``np.asarray`` raises on arrays with non-addressable shards
    (verified: RuntimeError under 2-process jax.distributed); the portable
    gather is one all_gather collective over all devices
    (``multihost_utils.process_allgather(tiled=True)``)."""
    if x.is_fully_addressable:
        return np.asarray(x)
    if x.is_fully_replicated:
        # every device (incl. a local one) holds the full value already
        return np.asarray(x.addressable_data(0))
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def save_sharded(path: str, sg: ShardedGeno) -> None:
    """Checkpoint a sharded panel (.npz).  Shards gather to host on save and
    re-shard onto the target mesh on load — the packed panel (2 bits per
    genotype) is the small representation, so this is cheap relative to
    re-ingesting .bed.  (The reference has no checkpointing at all,
    SURVEY.md §5.)

    Multi-process: the gather is a collective every process must enter;
    only process 0 writes the file, and a barrier holds the others until
    the write completes (so a following ``load_sharded`` sees the file)."""
    zq_n, zq_t, freq = (host_global(sg.zq_n), host_global(sg.zq_t),
                        host_global(sg.freq))
    if jax.process_index() == 0:
        np.savez_compressed(
            path, snps=sg.snps, indiv=sg.indiv, spd=sg.spd, axis=sg.axis,
            zq_n=zq_n, zq_t=zq_t, freq=freq,
        )
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("miraculix_save_sharded")


def load_sharded(path: str, mesh: Mesh) -> ShardedGeno:
    """Inverse of :func:`save_sharded`.

    The mesh must have the SAME device count the panel was saved with:
    ``zq_n`` is a concatenation of per-device planar16 packings (each
    plane-major within its own kw_local block), so splitting it differently
    would scramble the plane-to-SNP mapping that the wide matmul's RHS
    reorder assumes.  To change device counts, re-shard from the .bed or
    dense source."""
    z = np.load(path)
    axis = str(z["axis"])
    d = mesh.shape[axis]
    spd = int(z["spd"])
    total = z["zq_t"].shape[0]
    if total != d * spd:
        raise ValueError(
            f"panel was sharded over {total // spd} devices; it can only be "
            f"reloaded onto a {total // spd}-device mesh (got {d}) — "
            "re-shard from source to change device counts")
    return ShardedGeno(
        snps=int(z["snps"]), indiv=int(z["indiv"]), spd=spd, axis=axis,
        zq_n=jax.device_put(z["zq_n"], NamedSharding(mesh, P(None, axis))),
        zq_t=jax.device_put(z["zq_t"], NamedSharding(mesh, P(axis, None))),
        freq=jax.device_put(z["freq"], NamedSharding(mesh, P(axis))),
    )


def init_distributed(coordinator_address: str = None,
                     num_processes: int = None,
                     process_id: int = None) -> int:
    """Multi-host bootstrap: initialize jax.distributed and return this
    process's index.  On CPU/GPU clusters pass the arguments explicitly.
    Pair with shard_genotypes_from_bed (each process then reads only its
    own SNP ranges) — the distribution layer the reference never had
    (SURVEY.md §2.5)."""
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    return jax.process_index()
