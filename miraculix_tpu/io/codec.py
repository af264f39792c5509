"""Host-side genotype codecs: PLINK .bed <-> 2-bit <-> planar16 packing.

The reference (alexfreudenberg/miraculix) stores genotypes in PLINK 2-bit
codes and converts them into the CPU-friendly "5codes" base-3 byte format
(reference: src/miraculix/5codesUint.cc:55-101) or uploads raw PLINK bytes to
the GPU (src/cuda/dgemm_compressed_cuda.cu:43-170).  5codes exists because
CPUs have no 2-bit dot-product instruction; a tensor-core GEMM does not want
it either.

Our storage is the **16-way planar 32-bit packing** ("planar16"):
for a genotype matrix ``G[rows, cols]`` (entries 0/1/2, missing zeroed at pack
time), let ``Kw = ceil(cols/16)`` (lane-padded).  Word ``W[r, c]`` packs the
16 genotypes ``G[r, c + m*Kw]`` for ``m = 0..15`` at bit offsets ``2*m``:

    W[r, c] = sum_m  G[r, m*Kw + c] << (2*m)

The payoff: inside a kernel the decode is 16 shift-and-mask ops on 32-bit
words and a concatenation
of *contiguous* [rows, Kw] slabs that lands in natural column order
``G[:, 0:16*Kw]`` -- no byte extraction, no cross-lane shuffles, no gather of
the dense right-hand side.  The dense RHS ``B`` only needs the trivial
reshape ``B_padded.reshape(16, Kw, n)`` to follow the plane-major order.

PLINK .bed semantics (https://www.cog-genomics.org/plink/1.9/formats#bed,
cf. reference src/bindings/Julia/read_plink.jl:50-120):
  2-bit code 0b00 -> 0 (hom A1), 0b01 -> missing, 0b10 -> 1 (het),
  0b11 -> 2 (hom A2);  decode = max(code - 1, 0)  with missing -> 0
  (reference src/cuda/dgemm_compressed_cuda.h:259-267).
Bytes pack 4 individuals, low bits first; each SNP occupies
``ceil(indiv/4)`` bytes (SNP-major).

All functions here are pure numpy (a native C++ codec with the same contract
lives in miraculix_tpu/io/native and is used automatically when built).
"""
from __future__ import annotations

import numpy as np

from . import native as _native

# ---------------------------------------------------------------------------
# Lookup tables (built programmatically, like read_plink.jl:50-120)
# ---------------------------------------------------------------------------

_MISSING_SENTINEL = 3  # internal marker before zeroing; PLINK missing = 0b01


def _build_plink_decode_table() -> np.ndarray:
    """256 x 4 table: byte -> 4 genotype values with missing -> 3 (sentinel)."""
    tbl = np.zeros((256, 4), dtype=np.uint8)
    for byte in range(256):
        for i in range(4):
            code = (byte >> (2 * i)) & 0x3
            if code == 0b01:  # missing
                tbl[byte, i] = _MISSING_SENTINEL
            else:
                tbl[byte, i] = max(code - 1, 0)
    return tbl


def _build_geno_encode_table() -> np.ndarray:
    """genotype value {0,1,2, 3=missing} -> PLINK 2-bit code."""
    return np.array([0b00, 0b10, 0b11, 0b01], dtype=np.uint8)


_PLINK_DECODE = _build_plink_decode_table()  # [256, 4] genotype values
_GENO_ENCODE = _build_geno_encode_table()


# ---------------------------------------------------------------------------
# PLINK byte matrix <-> dense genotype matrix
# ---------------------------------------------------------------------------

def plink_to_dense(plink: np.ndarray, n_within: int) -> np.ndarray:
    """Unpack PLINK-coded bytes to genotype values.

    ``plink``: uint8 [ceil(n_within/4), n_major] -- e.g. the raw .bed payload
    reshaped so each column is one SNP (SNP-major) covering ``n_within``
    individuals.  Returns uint8 [n_within, n_major] with values 0/1/2 and 3
    for missing.
    """
    plink = np.asarray(plink, dtype=np.uint8)
    nat = _native.plink_to_dense(plink, n_within)
    if nat is not None:
        return nat
    nbytes, nmajor = plink.shape
    # [nbytes, nmajor, 4] -> interleave the within-byte axis
    vals = _PLINK_DECODE[plink]  # [nbytes, nmajor, 4]
    dense = vals.transpose(0, 2, 1).reshape(nbytes * 4, nmajor)
    return dense[:n_within]


def dense_to_plink(geno: np.ndarray) -> np.ndarray:
    """Pack genotype values 0/1/2 (3=missing) into PLINK bytes.

    ``geno``: [n_within, n_major] -> uint8 [ceil(n_within/4), n_major].
    """
    geno = np.asarray(geno, dtype=np.uint8)
    nat = _native.dense_to_plink(geno)
    if nat is not None:
        return nat
    n_within, nmajor = geno.shape
    nbytes = (n_within + 3) // 4
    padded = np.zeros((nbytes * 4, nmajor), dtype=np.uint8)
    padded[:n_within] = geno
    codes = _GENO_ENCODE[padded]  # 2-bit codes
    codes = codes.reshape(nbytes, 4, nmajor)
    out = (
        codes[:, 0, :].astype(np.uint16)
        | (codes[:, 1, :].astype(np.uint16) << 2)
        | (codes[:, 2, :].astype(np.uint16) << 4)
        | (codes[:, 3, :].astype(np.uint16) << 6)
    )
    return out.astype(np.uint8)


def plink_transpose_packed(plink: np.ndarray, n_within: int, n_major: int) -> np.ndarray:
    """Transpose a packed PLINK matrix without full decompression semantics
    change: [ceil(n_within/4), n_major] -> [ceil(n_major/4), n_within].

    Equivalent to reference compressed_operations.jl:45-66 (bit-block
    transpose); implemented via decode + re-encode which is equally fast in
    numpy.
    """
    dense = plink_to_dense(plink, n_within)  # [n_within, n_major]
    return dense_to_plink(dense.T)


# ---------------------------------------------------------------------------
# Allele frequencies / missing scan
# ---------------------------------------------------------------------------

def allele_freq(geno: np.ndarray, axis: int = 0) -> np.ndarray:
    """Allele frequency per SNP: f = sum(genotypes)/(2*n_called).

    ``geno`` has values 0/1/2 with 3 = missing; missing entries are excluded
    from both numerator and denominator (exact semantics; the reference's
    popcount shortcut read_plink.jl:198-204 counts missings as 1).
    """
    g = np.asarray(geno)
    if axis == 0 and g.dtype == np.uint8 and g.ndim == 2:
        nat = _native.allele_freq(np.ascontiguousarray(g))
        if nat is not None:
            return nat
    miss = g == _MISSING_SENTINEL
    vals = np.where(miss, 0, g).astype(np.int64)
    called = (~miss).sum(axis=axis)
    called = np.maximum(called, 1)
    return vals.sum(axis=axis) / (2.0 * called)


def missing_positions(geno: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Return (rows, cols) index arrays of missing entries (value 3)."""
    rows, cols = np.nonzero(np.asarray(geno) == _MISSING_SENTINEL)
    return rows.astype(np.int32), cols.astype(np.int32)


# ---------------------------------------------------------------------------
# planar16 packing (the compute storage)
# ---------------------------------------------------------------------------

LANE = 128          # packed word (minor) axis padded to this
SUBLANE = 8         # default row padding granularity


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def planar16_dims(rows: int, cols: int, lane: int = LANE, row_mult: int = SUBLANE):
    """Padded dims of the planar16 buffer for a rows x cols genotype matrix."""
    kw = round_up(max((cols + 15) // 16, 1), lane)
    rp = round_up(rows, row_mult)
    return rp, kw


def pack_planar16(
    geno: np.ndarray,
    lane: int = LANE,
    row_mult: int = SUBLANE,
    zero_missing: bool = True,
) -> np.ndarray:
    """Pack genotype matrix [rows, cols] (values 0/1/2, 3=missing) into
    uint32 planar16 words [rows_pad, Kw].

    Missing entries are zeroed (the reference's ``missingsFully0`` pack-time
    normalization, cf. src/miraculix/plinkUint.cc:155 missing scan); use
    :func:`missing_positions` beforehand to record corrections.
    """
    g = np.asarray(geno, dtype=np.uint8)
    rows, cols = g.shape
    rp, kw = planar16_dims(rows, cols, lane, row_mult)
    if zero_missing:
        nat = _native.pack_planar16(g, rp, kw)  # strided: works on .T views
        if nat is not None:
            return nat
        g = np.where(g == _MISSING_SENTINEL, 0, g)
    padded = np.zeros((rp, 16 * kw), dtype=np.uint8)
    padded[:rows, :cols] = g
    planes = padded.reshape(rp, 16, kw).astype(np.uint32)
    words = np.zeros((rp, kw), dtype=np.uint32)
    for m in range(16):
        words |= planes[:, m, :] << np.uint32(2 * m)
    return words


def unpack_planar16(words: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Inverse of :func:`pack_planar16` -> uint8 [rows, cols]."""
    w = np.asarray(words)
    rp, kw = w.shape
    planes = np.empty((rp, 16, kw), dtype=np.uint8)
    for m in range(16):
        planes[:, m, :] = ((w >> np.uint32(2 * m)) & np.uint32(3)).astype(np.uint8)
    dense = planes.reshape(rp, 16 * kw)
    return dense[:rows, :cols]


def unpack_planar16_cols(words: np.ndarray, rows: int,
                         col_idx: np.ndarray) -> np.ndarray:
    """Decode SELECTED columns from planar16 words without materializing
    the whole dense panel (which is 4x the packed bytes): column c lives
    in word c % Kw at bit offset 2*(c // Kw).  Returns uint8
    [rows, len(col_idx)]; missing entries were zeroed at pack time."""
    w = np.asarray(words)
    kw = w.shape[1]
    c = np.asarray(col_idx, np.int64)
    m = (c // kw).astype(np.uint32)
    k = c % kw
    return ((w[:rows][:, k] >> (np.uint32(2) * m)[None, :])
            & np.uint32(3)).astype(np.uint8)

