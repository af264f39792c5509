"""C-shaped API facade: 1:1 parity with the reference's stable "5codesAPI".

Every function mirrors one entry of src/miraculix/5codes.h:86-157 /
5codesAPI.c so that reference callers (and the reference's own tests)
translate mechanically.  State follows the reference's latch-then-call
model: ``set_options`` stores process-global options
(setOptions_compressed, 5codesAPI.c:43-70) which ``plink2compressed``
snapshots into the storage object.

The storage object replaces both the 5codes CPU container and the GPU
``GPU_gemm_storage`` (dgemm_compressed_cuda.h:87-100): packed planar16
buffers for both orientations, device-resident, plus the frequency cache.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import geno as _geno
from .options import Options, get_global_options, set_global_options
from .ops.dgemm import dgemm as _dgemm
from .ops.sparse import sparse_times_geno


def set_options(
    use_gpu: int | bool = False,
    cores: int = 0,
    floatLoop: int = 0,
    meanSubstract: int = 0,
    ignore_missings: int = 1,
    do_not_center: int = 0,
    do_normalize: int = 0,
    use_miraculix_freq: int = 0,
    variant: int = 0,
    print_details: int = 0,
) -> None:
    """``setOptions_compressed`` parity (5codesAPI.c:43-70).

    ``use_gpu`` is accepted for parity, like ``cores``, and ignored:
    kernels run on whatever backend jax selected.  ``floatLoop`` (0 ==
    use doubles in the reference) maps to the 'fast' bf16-split kernel in
    both settings: its f32-grade accuracy already exceeds the tolerances
    the reference's double path is tested to (1e-4 relative,
    tests/dgemm_compressed/test_5codesapi.f90); callers needing the
    exact f64 path use precision='f64' on the functional API.
    """
    set_global_options(Options(
        cores=cores,
        precision="fast",
        mean_subtract=bool(meanSubstract),
        ignore_missings=bool(ignore_missings),
        center=not do_not_center,
        normalize=bool(do_normalize),
        use_internal_freq=bool(use_miraculix_freq),
        variant=variant,
        verbose=print_details,
    ))


def plink2compressed(
    plink: np.ndarray,
    plink_transposed: Optional[np.ndarray],
    snps: int,
    indiv: int,
    f: Optional[np.ndarray] = None,
    max_n: int = 0,
) -> _geno.GenoMatrix:
    """``plink2compressed`` parity (5codesAPI.c:80-96): preprocess raw PLINK
    bytes (header-stripped .bed payload, [ceil(indiv/4), snps]) into the
    device-resident storage object.  ``plink_transposed`` is accepted for
    signature parity but not required — the packed transpose is derived
    internally (compressed_operations.jl:45-66 equivalent).  ``f`` overrides
    internally computed allele frequencies (external-freq mode)."""
    del plink_transposed, max_n  # both orientations derive from `plink`
    opts = get_global_options()
    keep_missing = not opts.ignore_missings
    # Content-hash cache: repeated dgemm_plink / sparse_times_plink calls on
    # the same buffer reuse the device-resident pack instead of re-ingesting
    # (the reference's direct-PLINK kernel exists to avoid conversion cost,
    # plink256.cc:54-61).
    from .utils import panel_cache

    key = ("plink", snps, indiv, keep_missing,
           panel_cache.digest_array(plink),
           None if f is None else panel_cache.digest_array(f))
    return panel_cache.get_or_build(
        key,
        lambda: _geno.from_plink(plink, snps, indiv, freq=f,
                                 keep_missing_info=keep_missing),
    )


def dgemm_compressed(
    trans: str,
    compressed: _geno.GenoMatrix,
    n: Optional[int] = None,
    B: np.ndarray = None,
    Ldb: int = 0,
    C: Optional[np.ndarray] = None,
    Ldc: int = 0,
):
    """``dgemm_compressed`` parity (5codesAPI.c:98-110).

    trans='N': C[indiv, n] = (Z - 2·1fᵀ) B with B [snps, n];
    trans='T': C[snps, n] = (Z - 2·1fᵀ)ᵀ B.  Options (centering,
    normalization, missing handling, precision) come from the latched
    global options.  If ``C`` (a numpy array) is given it is filled
    in-place and returned; otherwise a new array is returned.
    """
    del n, Ldb, Ldc  # shapes carry the information in Python
    opts = get_global_options()
    out = _dgemm(
        compressed,
        np.asarray(B),
        trans=trans,
        center=opts.center,
        normalize=opts.normalize,
        precision=opts.precision,
        ignore_missings=opts.ignore_missings,
    )
    out = np.asarray(out)
    if C is not None:
        C[...] = out
        return C
    return out


def dgemm_plink(
    trans: str,
    plink: np.ndarray,
    plink_transposed: Optional[np.ndarray],
    snps: int,
    indiv: int,
    f: Optional[np.ndarray],
    n: Optional[int] = None,
    B: np.ndarray = None,
    Ldb: int = 0,
    C: Optional[np.ndarray] = None,
    Ldc: int = 0,
):
    """``dgemm_plink`` parity (5codesAPI.c:112-130): multiply straight off
    raw PLINK bytes with no separate preprocessing call.  The reference's
    AVX2 path requires indiv % 32 == 0 and no centering (f == NULL,
    5codesChar.cc:495-523); the planar16 pack has neither restriction — packing
    IS the (cheap, fused) conversion."""
    obj = plink2compressed(plink, plink_transposed, snps, indiv, f=f)
    opts = get_global_options()
    # full latched-option parity with dgemm_compressed: dropping
    # normalize/ignore_missings here made the two facade entries disagree
    # under the same set_options state
    out = _dgemm(
        obj, np.asarray(B), trans=trans,
        center=opts.center and f is not None,
        normalize=opts.normalize,
        precision=opts.precision,
        ignore_missings=opts.ignore_missings,
    )
    out = np.asarray(out)
    if C is not None:
        C[...] = out
        return C
    return out


def sparse_times_plink(
    transsparse: str,
    transcompressed: str,
    plink: np.ndarray,
    plink_transposed: Optional[np.ndarray],
    snps: int,
    indiv: int,
    nIdx: int,
    rowIdxB: np.ndarray,
    colIdxB: np.ndarray,
    B: np.ndarray,
    C: Optional[np.ndarray] = None,
    Ldc: int = 0,
):
    """``sparse_times_plink`` parity (5codesAPI.c:135-157): CSR sparse S
    [nIdx, indiv] times genotype matrix, C [nIdx, snps] = S Z (1-based CSR
    indices as the Fortran callers supply).  transcompressed='T' swaps to
    Zᵀ; transsparse='T' treats the CSR triplets as Sᵀ storage."""
    del Ldc
    obj = plink2compressed(plink, plink_transposed, snps, indiv)
    out = np.asarray(sparse_times_geno(
        obj, rowIdxB, colIdxB, B, nIdx,
        trans_sparse=transsparse, trans_geno=transcompressed,
    ))
    if C is not None:
        C[...] = out
        return C
    return out


def get_compressed_freq(compressed: _geno.GenoMatrix,
                        f: Optional[np.ndarray] = None) -> np.ndarray:
    """``get_compressed_freq`` parity (5codesAPI.c:37-39)."""
    out = np.asarray(compressed.freq, dtype=np.float64)
    if f is not None:
        f[...] = out
        return f
    return out


def free_compressed(compressed: _geno.GenoMatrix) -> None:
    """``free_compressed`` parity (5codesAPI.c:159-161).  Drops the device
    buffers so the arrays can be reclaimed immediately rather than at GC."""
    from .utils import panel_cache

    panel_cache.evict_value(compressed)
    for name in ("zq_n", "zq_t", "freq"):
        arr = getattr(compressed, name, None)
        if arr is not None and hasattr(arr, "delete"):
            try:
                arr.delete()
            except Exception:
                pass
        setattr(compressed, name, None)
