"""GenoMatrix: the device-resident compressed genotype container.

The analogue of the reference's SEXP-compatible code container with
its transposed twin (``CompleteCodeVector`` + ``Next`` chaining,
src/miraculix/haplogeno.cc:250-480) and of the GPU storage object
(``GPU_gemm_storage``, src/cuda/dgemm_compressed_cuda.h:87-100): both packed
orientations live on device, plus the cached per-SNP statistics that the
reference keeps in the ``Precise`` attribute (getFreq,
src/miraculix/haplogeno.cc:1547-1661).

Storage is the planar16 packing (see miraculix_tpu.io.codec): uint32
words, 16 genotypes per word, plane-major so decode is shift/mask only.

Registered as a JAX pytree so it can be passed through jit/shard_map.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .io import codec
from .io import native as _native


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class GenoMatrix:
    """Compressed genotype matrix Z with shape (indiv, snps), values {0,1,2}.

    - ``zq_n``: int32 [indiv_pad, kw_snps] — planar16 over the SNP axis.
      Used for 'n' products Z @ B and for the GRM crossproduct Z Z^T.
    - ``zq_t``: int32 [snps_pad, kw_indiv] — planar16 over the individual
      axis (the transposed twin).  Used for 't' products Z^T @ B and LD.
    - ``freq``: f32 [snps] allele frequencies (external or computed).
    - ``pseudo_freq``: f32 [indiv] per-INDIVIDUAL frequencies (the
      reference's getPseudoFreq, haplogeno.cc:1503-1510) — the ColMeans
      centering vector and the vG normalization scale.
    - ``miss_rows_n/miss_cols_n``: optional int32 arrays of missing-entry
      coordinates in (indiv, snps) orientation, for centering corrections
      (reference Vector.matrix.D.cc:179-208).  None when ignore_missings.
    """

    snps: int
    indiv: int
    zq_n: jax.Array
    zq_t: jax.Array
    freq: jax.Array
    pseudo_freq: Optional[jax.Array] = None
    miss_rows_n: Optional[jax.Array] = None
    miss_cols_n: Optional[jax.Array] = None

    # -- pytree protocol ----------------------------------------------------
    def tree_flatten(self):
        children = (self.zq_n, self.zq_t, self.freq, self.pseudo_freq,
                    self.miss_rows_n, self.miss_cols_n)
        aux = (self.snps, self.indiv)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        snps, indiv = aux
        return cls(snps, indiv, *children)

    # -- properties ----------------------------------------------------------
    @property
    def kw_snps(self) -> int:
        return self.zq_n.shape[1]

    @property
    def kw_indiv(self) -> int:
        return self.zq_t.shape[1]

    @property
    def indiv_pad(self) -> int:
        return self.zq_n.shape[0]

    @property
    def snps_pad(self) -> int:
        return self.zq_t.shape[0]

    @property
    def sigma2(self) -> jax.Array:
        """sigma^2 = 2 * sum_s p_s (1 - p_s), the VanRaden scale
        (docs/grm.md:5-10; reference getSigmaSq, haplogeno.cc:1491)."""
        f = self.freq.astype(jnp.float32)
        return 2.0 * jnp.sum(f * (1.0 - f))

    @property
    def pseudo_sigma2(self) -> jax.Array:
        """2 * sum_i pf_i (1 - pf_i) over per-individual frequencies
        (reference getPseudoSigmaSq, haplogeno.cc:1534)."""
        if self.pseudo_freq is None:
            raise ValueError("GenoMatrix was built without pseudo_freq "
                             "(rebuild with from_dense/from_plink/from_bed)")
        pf = self.pseudo_freq.astype(jnp.float32)
        return 2.0 * jnp.sum(pf * (1.0 - pf))

    # -- frequency-cache derivatives (reference getFreq family,
    #    haplogeno.cc:1461-1661; computed on device via one packed matmul) --
    def snp_sums(self) -> jax.Array:
        """Per-SNP allele sums (reference getSum)."""
        from .ops.dgemm import dgemm

        ones = jnp.ones((self.indiv, 1), jnp.float32)
        return dgemm(self, ones, trans="t", center=False)[:, 0]

    def indiv_sums(self) -> jax.Array:
        """Per-individual allele sums (reference getPseudoSum)."""
        from .ops.dgemm import dgemm

        ones = jnp.ones((self.snps, 1), jnp.float32)
        return dgemm(self, ones, trans="n", center=False)[:, 0]

    def freq_sxi(self) -> jax.Array:
        """freqSxI[i] = sum_s freq[s] * Z[i, s] (reference getFreqSxI:
        one vectorGeno_raw pass, haplogeno.cc:1612)."""
        from .ops.dgemm import dgemm

        return dgemm(self, self.freq[:, None], trans="n", center=False)[:, 0]

    def pseudo_freq_sxi(self) -> jax.Array:
        """pseudoFreqSxI[s] = sum_i pf[i] * Z[i, s] (reference
        getPseudoFreqSxI: one genoVector_raw pass, haplogeno.cc:1652)."""
        from .ops.dgemm import dgemm

        if self.pseudo_freq is None:
            raise ValueError("pseudo_freq unavailable")
        return dgemm(self, self.pseudo_freq[:, None], trans="t",
                     center=False)[:, 0]

    def total_sum(self) -> jax.Array:
        """Sum of all genotype values (reference getTotalSum)."""
        return jnp.sum(self.snp_sums())

    @property
    def nbytes(self) -> int:
        return self.zq_n.nbytes + self.zq_t.nbytes

    def __repr__(self) -> str:  # keep dataclass from dumping arrays
        return (f"GenoMatrix(snps={self.snps}, indiv={self.indiv}, "
                f"packed={self.nbytes / 1e6:.1f} MB)")


def subset_snps(g: GenoMatrix, idx, freq: Optional[np.ndarray] = None
                ) -> GenoMatrix:
    """SNP-subset GenoMatrix built ON DEVICE from the packed words — no
    host decode, no dense intermediate (what the LOCO scan needs).

    - ``zq_t``: rows ARE SNPs, so the transposed packing of the subset is
      one row gather (+ zero rows of padding).
    - ``zq_n``: rebuilt with a vectorized 2-bit field gather — SNP s lives
      in word column s % kw at bit 2*(s // kw), so each of the 16 output
      planes is one column gather + per-column shift, recombined with
      plane shifts.  O(indiv_pad * |idx|) device work, vs a host
      decode's O(indiv * |idx|) single-core bytes + repack + H2D.

    ``freq`` defaults to the PARENT panel's frequencies at ``idx`` (what a
    leave-one-chromosome-out operator needs); pseudo-frequency caches are
    subset-dependent and dropped.  Missing coordinate lists are restricted
    to ``idx`` and remapped (duplicate indices in ``idx`` keep only the
    last occurrence's missing coordinates), so
    ``dgemm(ignore_missings=False)`` stays exact on the subset.
    """
    idx = np.asarray(idx, np.int64)
    if idx.ndim != 1 or (idx.size and (idx.min() < 0 or
                                       idx.max() >= g.snps)):
        raise ValueError("idx must be 1-D SNP indices within the panel")
    m = int(idx.size)
    if m == 0:
        raise ValueError("empty SNP subset")
    kw = g.kw_snps
    ipad = g.indiv_pad

    # transposed orientation: gather SNP rows, zero the padding rows
    spd_new = codec.round_up(m, 256)
    idx_pad = np.zeros(spd_new, np.int64)
    idx_pad[:m] = idx
    zq_t_new = jnp.take(jnp.asarray(g.zq_t), jnp.asarray(idx_pad), axis=0)
    zq_t_new = jnp.where((jnp.arange(spd_new) < m)[:, None], zq_t_new, 0)

    # n orientation: 2-bit field gather into a fresh planar16 layout
    kw2 = codec.round_up(-(-m // 16), codec.LANE)
    cap = 16 * kw2
    sidx = np.zeros(cap, np.int64)
    sidx[:m] = idx
    src_col = jnp.asarray(sidx % kw)
    src_shift = jnp.asarray((2 * (sidx // kw)).astype(np.uint32))
    valid = jnp.asarray((np.arange(cap) < m).astype(np.uint32))
    vals = ((jnp.take(jnp.asarray(g.zq_n), src_col, axis=1)
             >> src_shift[None, :]) & jnp.uint32(3)) * valid[None, :]
    plane_shift = jnp.asarray((2 * np.arange(16)).astype(np.uint32))
    zq_n_new = jnp.sum(
        vals.reshape(ipad, 16, kw2) << plane_shift[None, :, None],
        axis=1, dtype=jnp.uint32)

    fsub = (jnp.asarray(g.freq)[jnp.asarray(idx)] if freq is None
            else jnp.asarray(freq, jnp.float32))
    # missing coordinates restrict + remap to subset SNP positions — a
    # dropped list would make dgemm(ignore_missings=False) silently skip
    # its correction on the subset (the gate is `miss_rows_n is not None`)
    mr = mc = None
    if g.miss_rows_n is not None:
        mrows = np.asarray(g.miss_rows_n, np.int64)
        mcols = np.asarray(g.miss_cols_n, np.int64)
        newpos = np.full(g.snps, -1, np.int64)
        newpos[idx] = np.arange(m)
        sel = newpos[mcols] >= 0
        mr = jnp.asarray(mrows[sel].astype(np.int32))
        mc = jnp.asarray(newpos[mcols[sel]].astype(np.int32))
    return GenoMatrix(snps=m, indiv=g.indiv, zq_n=zq_n_new,
                      zq_t=zq_t_new, freq=fsub,
                      miss_rows_n=mr, miss_cols_n=mc)


def from_dense(
    geno: np.ndarray,
    freq: Optional[np.ndarray] = None,
    row_mult: int = 256,
    keep_missing_info: bool = False,
    device_put: bool = True,
) -> GenoMatrix:
    """Pack a dense genotype matrix [indiv, snps] (0/1/2, 3=missing) into a
    GenoMatrix (both orientations).

    Equivalent of the reference's ``plink2compressed``
    (src/miraculix/5codesAPI.c:80-96) with the packed transpose of
    compressed_operations.jl:45-66 fused in.
    """
    geno = np.asarray(geno, dtype=np.uint8)
    n_indiv, n_snps = geno.shape
    miss_rows = miss_cols = None
    if keep_missing_info:
        # ALWAYS store (possibly empty) arrays when tracking is requested:
        # miss_rows_n is the "info was tracked" marker the missing-aware
        # GRM/LD entry points gate on — a clean panel used to store None
        # and made grm(pair_denominator=True) falsely claim the panel was
        # built without keep_missing_info
        mr, mc = codec.missing_positions(geno)
        miss_rows, miss_cols = jnp.asarray(mr), jnp.asarray(mc)
    if freq is None:
        freq = codec.allele_freq(geno, axis=0)
    pseudo_freq = codec.allele_freq(geno, axis=1)
    zq_n = codec.pack_planar16(geno, row_mult=row_mult)
    gt = _native.transpose_u8(geno)  # blocked native transpose (cache-tiled)
    if gt is None:
        gt = np.ascontiguousarray(np.where(geno == 3, 0, geno).T)
    zq_t = codec.pack_planar16(gt, row_mult=row_mult)
    as_arr = jnp.asarray if device_put else (lambda x: x)
    return GenoMatrix(
        snps=n_snps,
        indiv=n_indiv,
        zq_n=as_arr(zq_n),
        zq_t=as_arr(zq_t),
        freq=jnp.asarray(np.asarray(freq, dtype=np.float32)),
        pseudo_freq=jnp.asarray(np.asarray(pseudo_freq, dtype=np.float32)),
        miss_rows_n=miss_rows,
        miss_cols_n=miss_cols,
    )


def from_plink(
    plink: np.ndarray,
    snps: int,
    indiv: int,
    freq: Optional[np.ndarray] = None,
    **kw: Any,
) -> GenoMatrix:
    """Build from raw PLINK packed bytes [ceil(indiv/4), snps] (the exact
    input contract of the reference's ``plink2compressed``)."""
    dense = codec.plink_to_dense(np.asarray(plink, dtype=np.uint8), indiv)
    return from_dense(dense, freq=freq, **kw)


def from_bed(path: str, freq: Optional[np.ndarray] = None, **kw: Any) -> GenoMatrix:
    """Build a GenoMatrix from a PLINK .bed fileset.

    Fast path: the fused native ingestion (io.native.bed_ingest) goes
    straight from the SNP-major .bed payload to planar16 words of BOTH
    orientations plus the frequency caches, never materializing the dense
    genotype matrix (8x the .bed size).  Falls back to decode+pack when the
    native codec is unavailable or missing-position tracking is requested.
    """
    from .io import bed

    # The fused native path hard-codes row_mult=256 and always device-puts;
    # honor from_dense-style kwargs by falling back when any are non-default.
    native_ok = (not kw.get("keep_missing_info")
                 and kw.get("row_mult", 256) == 256
                 and kw.get("device_put", True))
    if native_ok:
        res = _ingest_bed_native(path, freq)
        if res is not None:
            return res
    geno, computed_freq = bed.read_bed_genotypes(path)
    return from_dense(geno, freq=freq if freq is not None else computed_freq, **kw)


def _ingest_bed_native(path: str, freq: Optional[np.ndarray]) -> Optional[GenoMatrix]:
    from .io import bed

    if _native.get_lib() is None or not hasattr(_native.get_lib(), "mx_bed_ingest"):
        return None
    payload, n_snps, n_indiv = bed.read_bed_payload(path)
    ipad, kws = codec.planar16_dims(n_indiv, n_snps, row_mult=256)
    spad, kwi = codec.planar16_dims(n_snps, n_indiv, row_mult=256)
    out = _native.bed_ingest(payload, n_snps, n_indiv, spad, kwi, ipad, kws)
    if out is None:
        return None
    zqt, zqn, freq_c, pfreq = out
    return GenoMatrix(
        snps=n_snps,
        indiv=n_indiv,
        zq_n=jnp.asarray(zqn),
        zq_t=jnp.asarray(zqt),
        freq=jnp.asarray((freq_c if freq is None else np.asarray(freq))
                         .astype(np.float32)),
        pseudo_freq=jnp.asarray(pfreq.astype(np.float32)),
    )


def save(path: str, g: GenoMatrix) -> None:
    """Checkpoint the packed container (.npz): skips the PLINK decode + pack
    on reload — a capability the reference lacks entirely (SURVEY.md §5:
    'no checkpoint/resume anywhere')."""
    np.savez_compressed(
        path,
        snps=g.snps,
        indiv=g.indiv,
        miss_tracked=g.miss_rows_n is not None,
        zq_n=np.asarray(g.zq_n),
        zq_t=np.asarray(g.zq_t),
        freq=np.asarray(g.freq),
        pseudo_freq=(np.asarray(g.pseudo_freq)
                     if g.pseudo_freq is not None else np.zeros(0, np.float32)),
        miss_rows=(np.asarray(g.miss_rows_n)
                   if g.miss_rows_n is not None else np.zeros(0, np.int32)),
        miss_cols=(np.asarray(g.miss_cols_n)
                   if g.miss_cols_n is not None else np.zeros(0, np.int32)),
    )


def load(path: str) -> GenoMatrix:
    """Inverse of :func:`save`; buffers go straight to device."""
    z = np.load(path)
    # miss_tracked distinguishes "tracked, zero missing" (empty arrays)
    # from "not tracked" (None); absent in pre-round-4 checkpoints, where
    # non-empty arrays were the only tracked form
    has_miss = (bool(z["miss_tracked"]) if "miss_tracked" in z.files
                else z["miss_rows"].size > 0)
    has_pf = "pseudo_freq" in z.files and z["pseudo_freq"].size > 0
    return GenoMatrix(
        snps=int(z["snps"]),
        indiv=int(z["indiv"]),
        zq_n=jnp.asarray(z["zq_n"]),
        zq_t=jnp.asarray(z["zq_t"]),
        freq=jnp.asarray(z["freq"]),
        pseudo_freq=jnp.asarray(z["pseudo_freq"]) if has_pf else None,
        miss_rows_n=jnp.asarray(z["miss_rows"]) if has_miss else None,
        miss_cols_n=jnp.asarray(z["miss_cols"]) if has_miss else None,
    )
