"""Out-of-core genotype panels: SNP-chunked host-resident packing with
device-streamed compute (BASELINE config 5).

A 1M-SNP x 100K-individual panel is ~25 GB packed PER ORIENTATION; larger
panels outgrow one card's memory but fit host RAM or disk.  The reference
breaks the same dependence by streaming GRM tiles H2D
(src/cuda/snp_multiply_cuda.cu:194-340); our equivalent splits the SNP axis
into chunks, keeps each chunk as an ordinary (host-resident) GenoMatrix,
and streams chunks through the packed Pallas kernels, accumulating partial
products on device or host:

- ``dgemm(trans='t')``: per-chunk outputs are disjoint SNP row blocks.
- ``dgemm(trans='n')``: per-chunk partial sums accumulate.
- ``grm_matvec``: G x = Σ_ck Zc_ck (Zc_ckᵀ x) — ONE pass per matvec
  (column partition of Zc splits the product exactly; per-chunk centering
  with the chunk's frequency slice IS the global centering restricted to
  the chunk).
- ``cg_solve``: host-driven CG on the streamed operator (the reference's
  GBLUP CG is likewise a host loop over dgemm_compressed calls,
  examples/iterative_solver/grm_solve_cg.jl:109-134).

All four centering modes stream exactly: per-SNP modes (rowmeans / none /
user vector) restrict to chunk column slices, and 'colmeans' works because
``from_bed`` injects the WHOLE-PANEL pseudo-frequencies into every chunk
(combined from additive per-chunk sum/called stats — the chunk-local pfreq
ratios cannot be merged when missing counts differ per individual); each
chunk then subtracts pf·Σb over its own columns and the chunk sum
telescopes to the materialized-panel result.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .geno import GenoMatrix
from .io import bed as bedio
from .io import codec
from .io import native as _native


class StreamedGeno:
    """SNP-chunked packed panel; each chunk is a GenoMatrix whose buffers
    live in HOST memory (numpy) and transfer to device per use."""

    def __init__(self, chunks: List[GenoMatrix], bounds: List[tuple],
                 snps: int, indiv: int, freq: np.ndarray,
                 pseudo_freq: Optional[np.ndarray] = None):
        self.chunks = chunks
        self.bounds = bounds          # [(s0, s1)] per chunk
        self.snps = snps
        self.indiv = indiv
        self.freq = np.asarray(freq, np.float32)
        # whole-panel per-individual frequencies (colmeans centering);
        # injected into every chunk so per-chunk dgemm calls center with
        # the GLOBAL pseudo-freq — which makes the streamed accumulation
        # exactly the materialized-panel result (the chunk-local ratios
        # would not combine when missing counts differ per individual)
        self.pseudo_freq = (np.asarray(pseudo_freq, np.float32)
                            if pseudo_freq is not None else None)

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    def nbytes(self) -> int:
        return sum(int(c.zq_n.nbytes + c.zq_t.nbytes) for c in self.chunks)

    def cache_to_device(self, budget_bytes: Optional[int] = None) -> int:
        """Pin leading chunks' packings in device HBM until ``budget_bytes``
        is spent (default: 50% of reported free HBM, leaving headroom for
        kernel outputs and XLA scratch).  Cached chunks skip the per-pass
        H2D transfer; the rest keep streaming — the panel becomes a hybrid
        of GenoMatrix (fully resident) and pure streaming, so mid-size
        panels pay host bandwidth only for the overflow.  Returns the
        number of chunks cached.  Idempotent: already-cached chunks count
        against the budget but are not re-transferred."""
        import dataclasses

        import jax
        import jax.numpy as jnp

        if budget_bytes is None:
            try:
                stats = jax.devices()[0].memory_stats() or {}
                free = stats.get("bytes_limit", 0) - stats.get(
                    "bytes_in_use", 0)
            except Exception:  # pragma: no cover - backend without stats
                free = 0
            # a backend that reports no memory stats (the CPU) gets a zero
            # budget: every chunk keeps streaming, nothing is pinned
            budget_bytes = max(free, 0) // 2
        spent = cached = 0
        for i, c in enumerate(self.chunks):
            need = int(c.zq_n.nbytes + c.zq_t.nbytes)
            if spent + need > budget_bytes:
                break
            if isinstance(c.zq_n, np.ndarray) or isinstance(
                    c.zq_t, np.ndarray):
                self.chunks[i] = dataclasses.replace(
                    c, zq_n=jnp.asarray(c.zq_n), zq_t=jnp.asarray(c.zq_t))
            spent += need
            cached += 1
        return cached

    # -- construction ------------------------------------------------------
    @classmethod
    def from_bed(cls, path: str, chunk_snps: int = 65536,
                 verbose: bool = False) -> "StreamedGeno":
        """Ingest a .bed fileset chunk by chunk (each SNP range is one
        contiguous byte span of the file; the fused native codec packs both
        orientations without a dense intermediate)."""
        import dataclasses

        n_indiv = bedio._count_lines(path[:-4] + ".fam")
        n_snps = bedio._count_lines(path[:-4] + ".bim")
        chunks, bounds, freqs = [], [], []
        gsum = np.zeros(n_indiv, np.int64)
        gcalled = np.zeros(n_indiv, np.int64)
        for s0 in range(0, n_snps, chunk_snps):
            s1 = min(s0 + chunk_snps, n_snps)
            g, csum, ccalled = _ingest_slice(path, s0, s1, n_indiv)
            chunks.append(g)
            bounds.append((s0, s1))
            freqs.append(np.asarray(g.freq))
            gsum += csum
            gcalled += ccalled
            if verbose:
                print(f"  ingested snps [{s0}, {s1}) of {n_snps}",
                      flush=True)
        pf = (gsum / (2.0 * np.maximum(gcalled, 1))).astype(np.float32)
        chunks = [dataclasses.replace(c, pseudo_freq=pf) for c in chunks]
        return cls(chunks, bounds, n_snps, n_indiv, np.concatenate(freqs),
                   pseudo_freq=pf)

    # -- products ----------------------------------------------------------
    def dgemm(self, b: np.ndarray, trans: str = "n", center=True,
              precision: str = "fast") -> np.ndarray:
        """Streamed ``dgemm_compressed`` over all chunks (same semantics as
        ops.dgemm.dgemm for every centering mode; see module docstring)."""
        from .ops.dgemm import dgemm as _dgemm

        # the exact f64 tier must not round through f32 on the way in or
        # in the chunk accumulator
        acc_dtype = np.float64 if precision == "f64" else np.float32
        b = np.asarray(b, acc_dtype)
        if b.ndim == 1:
            b = b[:, None]
        trans = trans.lower()

        def _ck_center(s0, s1):
            return _slice_center(center, self.snps, s0, s1)

        if trans == "t":
            if b.shape[0] != self.indiv:
                raise ValueError("B rows must equal indiv for trans='t'")
            out = np.empty((self.snps, b.shape[1]), acc_dtype)
            for gck, (s0, s1) in zip(self.chunks, self.bounds):
                out[s0:s1] = np.asarray(
                    _dgemm(gck, b, trans="t", center=_ck_center(s0, s1),
                           precision=precision))
            return out
        if b.shape[0] != self.snps:
            raise ValueError("B rows must equal snps for trans='n'")
        acc = np.zeros((self.indiv, b.shape[1]), acc_dtype)
        for gck, (s0, s1) in zip(self.chunks, self.bounds):
            acc += np.asarray(
                _dgemm(gck, b[s0:s1], trans="n", center=_ck_center(s0, s1),
                       precision=precision))
        return acc

    def grm_matvec(self, x: np.ndarray, center=True) -> np.ndarray:
        """(Zc Zcᵀ) x in ONE streamed pass (each chunk chains 't' into 'n'
        before the next chunk loads — the K-split + accumulate pattern of
        the reference's tile loop)."""
        from .ops.dgemm import dgemm as _dgemm

        x = np.asarray(x, np.float32)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        acc = np.zeros((self.indiv, x.shape[1]), np.float32)
        for gck, (s0, s1) in zip(self.chunks, self.bounds):
            ck_center = _slice_center(center, self.snps, s0, s1)
            u = _dgemm(gck, x, trans="t", center=ck_center)
            acc += np.asarray(_dgemm(gck, u, trans="n", center=ck_center))
        return acc[:, 0] if squeeze else acc

    @property
    def sigma2(self) -> float:
        """2 Σ p(1-p) (VanRaden scale) — property, to duck-type
        GenoMatrix for the GBLUP pipeline."""
        f = self.freq.astype(np.float64)
        return float(2.0 * np.sum(f * (1.0 - f)))

    def grm_diag(self, center: bool = True) -> np.ndarray:
        """diag(Zc Zcᵀ) over the streamed panel — the per-chunk diagonals
        (solve.grm_diag, exact) are additive over SNP chunk slices."""
        from .solve.cg import grm_diag as _gd

        d = np.zeros(self.indiv, np.float64)
        for gck in self.chunks:
            d += np.asarray(_gd(gck, center=center), np.float64)
        return d

    def cg_solve(self, y: np.ndarray, lam: float = 0.0, center=True,
                 scale: bool = True, tol: float = 1e-4,
                 maxiter: int = 200, verbose: bool = False,
                 precondition: bool = False):
        """Host-driven CG on (G + lam I) x = y with G = Zc Zcᵀ (/ sigma² if
        ``scale``) — the streamed counterpart of solve.grm_cg_solve.
        ``precondition`` enables Jacobi PCG from the streamed exact
        diagonal (one extra pass over the chunks at setup)."""
        y = np.asarray(y, np.float64)
        squeeze = y.ndim == 1
        if squeeze:
            y = y[:, None]
        s2 = self.sigma2 if scale else 1.0

        def op(v):
            return self.grm_matvec(v.astype(np.float32),
                                   center=center).astype(np.float64) / s2 \
                + lam * v

        minv = None
        if precondition:
            d = self.grm_diag(center=bool(center)) / s2 + lam
            minv = np.where(d > 0, 1.0 / d, 1.0)[:, None]

        def precond(r):
            return r if minv is None else minv * r

        x = np.zeros_like(y)
        r = y.copy()     # x = 0 exactly; op(0) would stream the whole
        z = precond(r)   # out-of-core panel to multiply a zero vector
        p = z.copy()
        rs = (r * r).sum(axis=0)
        rz = (r * z).sum(axis=0)
        it = 0
        bnorm = np.maximum(np.sqrt((y * y).sum(axis=0)), 1e-30)
        while it < maxiter and (np.sqrt(rs) / bnorm > tol).any():
            ap = op(p)
            alpha = rz / np.maximum((p * ap).sum(axis=0), 1e-300)
            x += alpha * p
            r -= alpha * ap
            z = precond(r)
            rs = (r * r).sum(axis=0)
            rz_new = (r * z).sum(axis=0)
            p = z + (rz_new / np.maximum(rz, 1e-300)) * p
            rz = rz_new
            it += 1
            if verbose:
                print(f"  cg iter {it}: rel resid "
                      f"{float((np.sqrt(rs) / bnorm).max()):.3e}", flush=True)
        return (x[:, 0] if squeeze else x), it, np.sqrt(rs) / bnorm


def _slice_center(center, snps: int, s0: int, s1: int):
    """Restrict a per-SNP user centering vector to one chunk's SNP slice;
    every other centering spec (bool / mode string / per-indiv colmeans)
    passes through unchanged."""
    if isinstance(center, np.ndarray) and center.ndim == 1 \
            and center.shape[0] == snps:
        return center[s0:s1]
    return center


def _ingest_slice(path: str, s0: int, s1: int, n_indiv: int):
    """One SNP range of a .bed fileset as a host-resident GenoMatrix, plus
    the chunk's per-individual (genotype sum, called count) vectors — the
    additive ingredients from which ``from_bed`` combines the whole-panel
    pseudo-frequencies exactly (the chunk-local pfreq RATIOS cannot be
    merged when per-individual missing counts differ)."""
    import jax.numpy as jnp  # noqa: F401  (GenoMatrix arrays stay numpy here)

    payload, _, _ = bedio.read_bed_slice_payload(path, s0, s1)
    width = s1 - s0
    lib = _native.get_lib()
    if lib is not None and hasattr(lib, "mx_bed_ingest"):
        ipad, kws = codec.planar16_dims(n_indiv, width, row_mult=256)
        spad, kwi = codec.planar16_dims(width, n_indiv, row_mult=256)
        out = _native.bed_ingest(payload, width, n_indiv, spad, kwi, ipad,
                                 kws)
        stats = _native.bed_colstats(payload, width, n_indiv)
        if out is not None and stats is not None:
            zqt, zqn, freq_c, pfreq = out
            gm = GenoMatrix(snps=width, indiv=n_indiv, zq_n=zqn, zq_t=zqt,
                            freq=freq_c.astype(np.float32),
                            pseudo_freq=pfreq.astype(np.float32))
            return gm, stats[0], stats[1]
    # fallback: decode + pack on host
    from .geno import from_dense

    dense = codec.plink_to_dense(np.ascontiguousarray(payload.T), n_indiv)
    miss = dense == 3
    csum = np.where(miss, 0, dense).astype(np.int64).sum(axis=1)
    ccalled = (~miss).sum(axis=1).astype(np.int64)
    return from_dense(dense, device_put=False), csum, ccalled
