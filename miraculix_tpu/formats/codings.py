"""Coding registry: every genotype/haplotype storage coding the reference
supports, with host-side pack/unpack to a canonical dense matrix.

Mirrors the 32-value ``coding_type`` enum (src/miraculix/Automiraculix.h:
35-86) and the per-coding packing kernels (1bit*/2bit*/3bit*/plink*/5codes*/
OneByte*/4Byte* files).  Here there is exactly ONE compute coding —
planar16 (miraculix_tpu.io.codec) — so these codecs exist for
interoperability: ingesting foreign buffers, emitting them, and the
any-to-any Transform (miraculix_tpu.formats.transform).  The canonical
in-memory form is dense uint8 [indiv, snps] with values 0/1/2 and 3 =
missing; haplotype codings use [indiv, snps] PAIRS (allele1 + 2*allele2,
values 0..3).
"""
from __future__ import annotations

import enum
from typing import Callable, Dict, Tuple

import numpy as np

from ..io import codec


class Coding(enum.Enum):
    """User-facing codings (reference Automiraculix.h:35-86; the unused /
    purely-technical transposed entries collapse into the ``transpose``
    argument of Transform)."""

    AUTO = "auto"
    ONE_BIT = "one_bit"            # OneBitGeno: genotypes 0/1, 1 bit each
    TWO_BIT = "two_bit"            # TwoBitGeno: genotypes 0..2 verbatim
    THREE_BIT = "three_bit"        # ThreeBit
    PLINK = "plink"                # Plink / OrigPlink byte codes
    FIVE_CODES = "five_codes"      # FiveCodes: 5 genotypes base-3 per byte
    FOUR_BIT = "four_bit"          # FourBit (GPU-internal in the reference)
    ONE_BYTE = "one_byte"          # OneByteGeno (the reference's test oracle)
    FOUR_BYTE = "four_byte"        # FourByteGeno (R ints)
    PLANAR16 = "planar16"          # OUR compute coding
    ONE_BIT_HAPLO = "one_bit_haplo"
    TWO_BIT_HAPLO = "two_bit_haplo"
    ONE_BYTE_HAPLO = "one_byte_haplo"
    FOUR_BYTE_HAPLO = "four_byte_haplo"
    EIGHT_BYTE_HAPLO = "eight_byte_haplo"  # two int32 planes (allele1, allele2)


GENO_CODINGS = {
    Coding.ONE_BIT, Coding.TWO_BIT, Coding.THREE_BIT, Coding.PLINK,
    Coding.FIVE_CODES, Coding.FOUR_BIT, Coding.ONE_BYTE, Coding.FOUR_BYTE,
    Coding.PLANAR16,
}
HAPLO_CODINGS = {
    Coding.ONE_BIT_HAPLO, Coding.TWO_BIT_HAPLO, Coding.ONE_BYTE_HAPLO,
    Coding.FOUR_BYTE_HAPLO, Coding.EIGHT_BYTE_HAPLO,
}


# ---------------------------------------------------------------------------
# bit-packing helpers (within-byte, low bits first, per column — the layout
# every miraculix coding shares: entries packed along the individual axis)
# ---------------------------------------------------------------------------

def _pack_bits(values: np.ndarray, bits: int) -> np.ndarray:
    """Pack [n_within, n_major] small ints into bytes, ``bits`` per entry,
    low bits first along axis 0 -> [ceil(n_within*bits/8), n_major]."""
    n_within, n_major = values.shape
    per_byte = 8 // bits
    nbytes = -(-n_within // per_byte)
    padded = np.zeros((nbytes * per_byte, n_major), dtype=np.uint16)
    padded[:n_within] = values
    out = np.zeros((nbytes, n_major), dtype=np.uint16)
    for i in range(per_byte):
        out |= padded[i::per_byte] << (bits * i)
    return out.astype(np.uint8)


def _unpack_bits(packed: np.ndarray, bits: int, n_within: int) -> np.ndarray:
    nbytes, n_major = packed.shape
    per_byte = 8 // bits
    mask = (1 << bits) - 1
    out = np.zeros((nbytes * per_byte, n_major), dtype=np.uint8)
    for i in range(per_byte):
        out[i::per_byte] = (packed >> (bits * i)) & mask
    return out[:n_within]


# ---------------------------------------------------------------------------
# per-coding encode/decode (dense [indiv, snps] <-> packed buffer)
#
# Orientation conventions (validated byte-for-byte in
# tests/test_coding_golden.py against the reference layout definitions):
# - TwoBit/ThreeBit/OneByte/FourByte store PER-INDIVIDUAL ROWS with the
#   SNPs packed along the row — the reference's UNIT_CODING loop writes
#   ``Ans + i*ldAns`` per individual i (bitUint.h:26-50), so reference
#   memory reshaped [indiv, lda] equals our buffer (at minimal lda).
# - Plink/FiveCodes pack 4 (resp. 5) INDIVIDUALS per byte within one SNP
#   column, [groups, snps] — the .bed orientation (plink2Geno5codes32
#   writes output byte (group j, snp i) at j*ldaByte + i,
#   5codesChar.cc:270-340).
# ---------------------------------------------------------------------------

def _enc_two_bit(g):
    """Reference TwoBitGeno (2bitUint.cc:22-64): genotype value verbatim in
    2 bits (geno_code {0,1,2}; we keep 3 = missing as an extension), packed
    low-bits-first along the SNP axis, one row per individual."""
    return _pack_bits(g.T.astype(np.uint16), 2).T


def _dec_two_bit(buf, indiv, snps):
    return _unpack_bits(buf.T, 2, snps).T[:indiv]


def _enc_plink(g):
    return codec.dense_to_plink(g)


def _dec_plink(buf, indiv, snps):
    return codec.plink_to_dense(buf, indiv)


def _enc_one_bit(g):
    if (np.asarray(g) > 1).any():
        raise ValueError("OneBit coding holds genotypes 0/1 only")
    return _pack_bits(g.T.astype(np.uint16), 1).T


def _dec_one_bit(buf, indiv, snps):
    return _unpack_bits(buf.T, 1, snps).T[:indiv]


_THREE_BIT_LUT = np.array([0, 3, 3, 1, 3, 3, 2, 3], dtype=np.uint8)


def _three_bit_shifts(snps):
    """Bit offset of SNP s inside its 64-bit block: 5 codes per 16-bit
    part-unit with 1 pad bit (deltaBitsPartUnit, bitUint.h:36-39), 4
    part-units per block -> 20 codes per block."""
    s = np.arange(snps)
    return s // 20, (16 * ((s % 20) // 5) + 3 * (s % 5)).astype(np.uint64)


def _enc_three_bit(g):
    """Reference ThreeBit layout (3bitUint.cc:21-47, bitUint.h:26-50):
    per-individual rows of little-endian 64-bit blocks; genotype g stores
    as the 3-bit code 3*g (geno_code {0,3,6} — field-wise addition then
    accumulates allele sums without carries), 5 codes per 16-bit part-unit
    (1 pad bit each), 20 codes per block.  Missing (3) stores as code 1,
    which the reference reserves as NA (rev_geno_code)."""
    g = np.asarray(g)
    indiv, snps = g.shape
    codes = np.where(g == 3, 1, 3 * g.astype(np.uint64)).astype(np.uint64)
    nblk = -(-snps // 20)
    padded = np.zeros((indiv, nblk * 20), np.uint64)
    padded[:, :snps] = codes
    _, shifts = _three_bit_shifts(nblk * 20)
    words = (padded << shifts[None, :]).reshape(indiv, nblk, 20).sum(
        axis=2, dtype=np.uint64)  # disjoint bit fields: sum == OR
    return words.astype("<u8").view(np.uint8).reshape(indiv, nblk * 8)


def _dec_three_bit(buf, indiv, snps):
    nblk = buf.shape[1] // 8
    words = np.ascontiguousarray(buf[:indiv]).reshape(indiv, nblk, 8).view(
        "<u8")[..., 0]
    blk, shifts = _three_bit_shifts(snps)
    vals = (words[:, blk] >> shifts[None, :]) & np.uint64(7)
    return _THREE_BIT_LUT[vals.astype(np.uint8)]


def _enc_four_bit(g):
    return _pack_bits(g.T.astype(np.uint16), 4).T


def _dec_four_bit(buf, indiv, snps):
    return _unpack_bits(buf.T, 4, snps).T[:indiv]


_POW3 = np.array([1, 3, 9, 27, 81], dtype=np.uint16)


def _enc_five_codes(g):
    """5 genotypes base-3 per byte (reference 5codesUint.cc:55-101 tables;
    3^5 = 243 <= 256).  Missing packs as 0 (no missing support, matching
    tuning.missingsFully0)."""
    g = np.where(np.asarray(g) == 3, 0, np.asarray(g)).astype(np.uint16)
    indiv, snps = g.shape
    gt = g.T  # [snps, indiv]: pack along individuals
    nbytes = -(-indiv // 5)
    padded = np.zeros((snps, nbytes * 5), dtype=np.uint16)
    padded[:, :indiv] = gt
    vals = (padded.reshape(snps, nbytes, 5) * _POW3[None, None, :]).sum(-1)
    return vals.astype(np.uint8).T  # [nbytes, snps]


def _dec_five_codes(buf, indiv, snps):
    b = buf.T.astype(np.uint16)  # [snps, nbytes]
    digits = []
    for p in range(5):
        digits.append((b // _POW3[p]) % 3)
    out = np.stack(digits, axis=-1).reshape(snps, -1)[:, :indiv]
    return out.astype(np.uint8).T


def _enc_one_byte(g):
    """Reference OneByteGeno: one byte per genotype, per-individual rows
    (coding_OneByte_end writes pAns = Ans + i*ldAns, OneByteUint.cc:49-66)."""
    return np.ascontiguousarray(np.asarray(g, dtype=np.uint8))  # [indiv, snps]


def _dec_one_byte(buf, indiv, snps):
    return buf[:indiv, :snps].astype(np.uint8)


def _enc_four_byte(g):
    """Reference FourByteGeno: plain ints, R column-major [snps x indiv]
    = per-individual contiguous chunks = numpy [indiv, snps] rows."""
    return np.ascontiguousarray(np.asarray(g, dtype=np.int32))


def _dec_four_byte(buf, indiv, snps):
    return buf[:indiv, :snps].astype(np.uint8)


# haplo byte/word codings: one value per ALLELE, per-individual rows, with
# the allele-2 twin plane a whole lda*individuals block after plane 1
# (reference getHaploIncr, HaploUint.cc:41-47: *delta = lda*individuals)
def _dec_haplo_plane_blocks(buf, indiv, snps):
    half = buf.shape[0] // 2
    a1 = buf[:half][:indiv, :snps].astype(np.uint8)
    a2 = buf[half:][:indiv, :snps].astype(np.uint8)
    return (a1 + 2 * a2).astype(np.uint8)


def _enc_planar16(g):
    return codec.pack_planar16(np.asarray(g, dtype=np.uint8))


def _dec_planar16(buf, indiv, snps):
    return codec.unpack_planar16(buf, indiv, snps)


# haplotype codings: canonical dense haplo = uint8 [indiv, snps] with
# value = allele1 + 2*allele2 (each in {0,1})
def _enc_two_bit_haplo(h):
    return _pack_bits(h.T.astype(np.uint16), 2).T


def _dec_two_bit_haplo(buf, indiv, snps):
    return _unpack_bits(buf.T, 2, snps).T[:indiv]


def _enc_one_bit_haplo(h):
    """Two stacked 1-bit planes (allele1 block, then allele2 block) —
    reference OneBitHaplo (1bit.h:20-75)."""
    a1 = (h & 1).astype(np.uint16)
    a2 = ((h >> 1) & 1).astype(np.uint16)
    return np.concatenate(
        [_pack_bits(a1.T, 1).T, _pack_bits(a2.T, 1).T], axis=0)


def _dec_one_bit_haplo(buf, indiv, snps):
    half = buf.shape[0] // 2
    a1 = _unpack_bits(buf[:half].T, 1, snps).T[:indiv]
    a2 = _unpack_bits(buf[half:].T, 1, snps).T[:indiv]
    return (a1 + 2 * a2).astype(np.uint8)


def _enc_one_byte_haplo(h):
    """Reference OneByteHaplo: one byte per allele, row per individual,
    allele-2 twin plane block at lda*individuals (HaploUint.cc:41-47)."""
    h = np.asarray(h)
    a1 = (h & 1).astype(np.uint8)
    a2 = ((h >> 1) & 1).astype(np.uint8)
    return np.concatenate([a1, a2], axis=0).copy()


def _enc_four_byte_haplo(h):
    """Reference FourByteHaplo: like OneByteHaplo with 4-byte ints
    (HaploUint.cc:41-47 shares the OneByte/FourByte delta arm)."""
    h = np.asarray(h)
    a1 = (h & 1).astype(np.int32)
    a2 = ((h >> 1) & 1).astype(np.int32)
    return np.concatenate([a1, a2], axis=0).copy()


def _enc_eight_byte_haplo(h):
    """Reference EightByteHaplo: 8 bytes per code = ADJACENT (allele1,
    allele2) 4-byte ints per SNP within each individual's row
    (HaploUint.cc:54-58: nextHaploIncr = 2 units, twin delta = 1)."""
    h = np.asarray(h)
    n, s = h.shape
    out = np.empty((n, 2 * s), np.int32)
    out[:, 0::2] = h & 1
    out[:, 1::2] = (h >> 1) & 1
    return out


def _dec_eight_byte_haplo(buf, indiv, snps):
    a1 = buf[:indiv, 0:2 * snps:2].astype(np.uint8)
    a2 = buf[:indiv, 1:2 * snps:2].astype(np.uint8)
    return (a1 + 2 * a2).astype(np.uint8)


_CODECS: Dict[Coding, Tuple[Callable, Callable]] = {
    Coding.ONE_BIT: (_enc_one_bit, _dec_one_bit),
    Coding.TWO_BIT: (_enc_two_bit, _dec_two_bit),
    Coding.THREE_BIT: (_enc_three_bit, _dec_three_bit),
    Coding.PLINK: (_enc_plink, _dec_plink),
    Coding.FIVE_CODES: (_enc_five_codes, _dec_five_codes),
    Coding.FOUR_BIT: (_enc_four_bit, _dec_four_bit),
    Coding.ONE_BYTE: (_enc_one_byte, _dec_one_byte),
    Coding.FOUR_BYTE: (_enc_four_byte, _dec_four_byte),
    Coding.PLANAR16: (_enc_planar16, _dec_planar16),
    Coding.ONE_BIT_HAPLO: (_enc_one_bit_haplo, _dec_one_bit_haplo),
    Coding.TWO_BIT_HAPLO: (_enc_two_bit_haplo, _dec_two_bit_haplo),
    Coding.ONE_BYTE_HAPLO: (_enc_one_byte_haplo, _dec_haplo_plane_blocks),
    Coding.FOUR_BYTE_HAPLO: (_enc_four_byte_haplo, _dec_haplo_plane_blocks),
    Coding.EIGHT_BYTE_HAPLO: (_enc_eight_byte_haplo, _dec_eight_byte_haplo),
}


def encode(dense: np.ndarray, coding: Coding) -> np.ndarray:
    """Dense canonical matrix -> packed buffer in ``coding``."""
    if coding not in _CODECS:
        raise ValueError(f"coding {coding} has no codec")
    return _CODECS[coding][0](np.asarray(dense))


def decode(buf: np.ndarray, coding: Coding, indiv: int, snps: int) -> np.ndarray:
    """Packed buffer -> dense canonical matrix [indiv, snps]."""
    if coding not in _CODECS:
        raise ValueError(f"coding {coding} has no codec")
    return _CODECS[coding][1](np.asarray(buf), indiv, snps)


def haplo_to_geno(haplo: np.ndarray) -> np.ndarray:
    """Collapse a dense haplotype matrix (allele1 + 2*allele2) to genotypes
    (allele sums) — reference TwoBithaplo2geno* (src/miraculix/Haplo*)."""
    h = np.asarray(haplo)
    return ((h & 1) + ((h >> 1) & 1)).astype(np.uint8)
