"""Golden-buffer byte-layout fidelity tests.

Each expected buffer is HAND-CONSTRUCTED here with independent arithmetic
straight from the reference layout definitions — not by calling the codecs
under test — so these tests prove that a buffer coded by the reference
decodes here bit-exactly:

- TwoBitGeno: 2 bits/code, value = genotype, low-bits-first along SNPs,
  one row per individual (2bitUint.cc:22-64, bitUint.h:26-50).
- ThreeBit:   3 bits/code, value = 3*genotype (geno_code {0,3,6},
  3bitUint.cc:41-44), 5 codes per 16-bit part-unit with one pad bit
  (bitUint.h:36-39), little-endian 64-bit blocks, row per individual.
- Plink:      2-bit codes {00->0, 01->missing, 10->1, 11->2}
  (Automiraculix.h:44-48, PLINK2HUMAN MXinfo.h:143), 4 individuals/byte
  low-bits-first within one SNP column (.bed layout).
- FiveCodes:  5 consecutive individuals per byte, individual k weighted
  3^k (initiate_table5I, 5codesUint.cc:51-68: V0 = i0 + 3 i1 + ... + 81 i4).
- OneByteGeno: one byte per genotype, row per individual
  (OneByteUint.cc:49-66).
"""
import numpy as np
import pytest

from miraculix_tpu.formats import Coding, decode, encode


def _geno(rows):
    return np.array(rows, dtype=np.uint8)


# ---------------------------------------------------------------------------
# TwoBit
# ---------------------------------------------------------------------------

def test_two_bit_golden():
    g = _geno([[1, 0, 2, 1, 2, 0, 1],
               [2, 2, 0, 0, 1, 1, 0]])
    # byte b of individual i = sum over j<4 of g[i, 4b+j] << 2j
    want = np.zeros((2, 2), np.uint8)
    for i in range(2):
        for s in range(7):
            want[i, s // 4] |= g[i, s] << (2 * (s % 4))
    buf = encode(g, Coding.TWO_BIT)
    np.testing.assert_array_equal(buf, want)
    # a reference-coded buffer decodes here bit-exactly
    np.testing.assert_array_equal(decode(want, Coding.TWO_BIT, 2, 7), g)


# ---------------------------------------------------------------------------
# ThreeBit
# ---------------------------------------------------------------------------

def _three_bit_reference_words(row):
    """Independent construction: UNIT_CODING with BitsPerCode=3,
    CodesPerPartUnit=5, deltaBitsPartUnit=1 (shift 0,3,6,9,12 then +1 to
    16, ...), geno_code = {0: 0, 1: 3, 2: 6}."""
    geno_code = {0: 0, 1: 3, 2: 6}
    words, shift, current = [], 0, 0
    count = 0
    for v in row:
        current |= geno_code[int(v)] << shift
        shift += 3
        count += 1
        if count == 5:
            shift += 1  # pad bit per 16-bit part unit
            count = 0
        if shift >= 64:
            words.append(current)
            current, shift, count = 0, 0, 0
    if shift > 0:
        words.append(current)
    return np.array(words, dtype=np.uint64)


def test_three_bit_golden():
    rng = np.random.default_rng(0)
    g = rng.integers(0, 3, (3, 43), dtype=np.uint8)  # 43 codes -> 3 blocks
    buf = encode(g, Coding.THREE_BIT)
    assert buf.shape == (3, 3 * 8)  # 20 codes / 64-bit block
    for i in range(3):
        want_words = _three_bit_reference_words(g[i])
        got_words = np.ascontiguousarray(buf[i]).view("<u8")
        np.testing.assert_array_equal(got_words[: len(want_words)],
                                      want_words)
    # decode a reference-constructed buffer
    ref_bytes = np.zeros((3, 24), np.uint8)
    for i in range(3):
        w = _three_bit_reference_words(g[i])
        ref_bytes[i, : len(w) * 8] = w.astype("<u8").view(np.uint8)
    np.testing.assert_array_equal(decode(ref_bytes, Coding.THREE_BIT, 3, 43),
                                  g)


def test_three_bit_code_values():
    # the code for genotype g is 3*g so field sums accumulate allele counts
    g = _geno([[0, 1, 2, 0, 0]])
    word = int(np.ascontiguousarray(encode(g, Coding.THREE_BIT)[0]).view("<u8")[0])
    assert (word >> 0) & 7 == 0
    assert (word >> 3) & 7 == 3
    assert (word >> 6) & 7 == 6


# ---------------------------------------------------------------------------
# Plink
# ---------------------------------------------------------------------------

def test_plink_golden():
    # PLINK 2-bit codes: genotype {0,1,2}->{0b00,0b10,0b11}, missing->0b01
    enc_table = {0: 0b00, 1: 0b10, 2: 0b11, 3: 0b01}
    g = _geno([[0], [1], [2], [3], [2], [0]])  # 6 individuals, 1 snp
    want = np.zeros((2, 1), np.uint8)
    for i in range(6):
        want[i // 4, 0] |= enc_table[int(g[i, 0])] << (2 * (i % 4))
    buf = encode(g, Coding.PLINK)
    np.testing.assert_array_equal(buf, want)
    np.testing.assert_array_equal(decode(want, Coding.PLINK, 6, 1), g)


# ---------------------------------------------------------------------------
# FiveCodes
# ---------------------------------------------------------------------------

def test_five_codes_golden():
    g = _geno([[0, 2], [1, 1], [2, 0], [0, 2], [1, 1], [2, 0], [0, 1]])
    # byte (group j, snp s) = sum_k g[5j+k, s] * 3^k  (5codesUint.cc:51-68)
    want = np.zeros((2, 2), np.uint8)
    for s in range(2):
        for i in range(7):
            want[i // 5, s] += g[i, s] * 3 ** (i % 5)
    buf = encode(g, Coding.FIVE_CODES)
    np.testing.assert_array_equal(buf, want)
    np.testing.assert_array_equal(decode(want, Coding.FIVE_CODES, 7, 2), g)


def test_five_codes_table_identity():
    """CODING_TABLE5[i0..i4] = i0 + 3 i1 + 9 i2 + 27 i3 + 81 i4 — all 243."""
    from itertools import product

    for digits in product(range(3), repeat=5):
        g = np.array(digits, np.uint8)[:, None]  # 5 individuals, 1 snp
        byte = int(encode(g, Coding.FIVE_CODES)[0, 0])
        assert byte == sum(d * 3 ** k for k, d in enumerate(digits))


# ---------------------------------------------------------------------------
# OneByte / FourByte
# ---------------------------------------------------------------------------

def test_one_byte_golden():
    g = _geno([[0, 1, 2], [2, 1, 0]])
    buf = encode(g, Coding.ONE_BYTE)
    np.testing.assert_array_equal(buf, g)  # identical bytes, row-major
    assert buf.flags.c_contiguous
    np.testing.assert_array_equal(decode(g.copy(), Coding.ONE_BYTE, 2, 3), g)


def test_four_byte_golden():
    g = _geno([[0, 1, 2], [2, 1, 0]])
    buf = encode(g, Coding.FOUR_BYTE)
    assert buf.dtype == np.int32
    np.testing.assert_array_equal(buf, g.astype(np.int32))
    np.testing.assert_array_equal(decode(buf, Coding.FOUR_BYTE, 2, 3), g)


# ---------------------------------------------------------------------------
# cross-coding consistency after the layout fixes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coding", [Coding.ONE_BIT, Coding.TWO_BIT,
                                    Coding.THREE_BIT, Coding.PLINK,
                                    Coding.FIVE_CODES, Coding.FOUR_BIT,
                                    Coding.ONE_BYTE, Coding.FOUR_BYTE,
                                    Coding.PLANAR16])
def test_round_trip_all(coding):
    rng = np.random.default_rng(5)
    hi = 2 if coding in (Coding.ONE_BIT,) else 3
    g = rng.integers(0, hi, (13, 29), dtype=np.uint8)
    if coding in (Coding.THREE_BIT, Coding.PLINK):
        g[0, 0] = 3  # missing round-trips via the NA/missing code
    if coding == Coding.FIVE_CODES:
        g = np.where(g == 3, 0, g).astype(np.uint8)  # 5codes has no missing
    np.testing.assert_array_equal(
        decode(encode(g, coding), coding, 13, 29), g)


# ---------------------------------------------------------------------------
# Haplotype codings (layouts from getHaploIncr, HaploUint.cc:34-72, and the
# TwoBitHaplo packer Haplo2_Uint.cc:46-88)
# ---------------------------------------------------------------------------

def _haplo(rows):
    """Canonical haplo matrix: value = allele1 + 2*allele2, each in {0,1}."""
    return np.array(rows, dtype=np.uint8)


def test_two_bit_haplo_golden():
    # Haplo2_Uint.cc:70-74: field at shft = h1 | h2 << (shft+1), i.e. the
    # 2-bit field IS h1 + 2*h2, packed low-bits-first along SNPs per row.
    h = _haplo([[1, 0, 3, 2, 1],
                [2, 3, 0, 1, 0]])
    want = np.zeros((2, 2), np.uint8)
    for i in range(2):
        for s in range(5):
            h1, h2 = h[i, s] & 1, (h[i, s] >> 1) & 1
            want[i, s // 4] |= (h1 | (h2 << 1)) << (2 * (s % 4))
    buf = encode(h, Coding.TWO_BIT_HAPLO)
    np.testing.assert_array_equal(buf, want)
    np.testing.assert_array_equal(decode(want, Coding.TWO_BIT_HAPLO, 2, 5), h)


def test_one_bit_haplo_golden():
    # getHaploIncr: deltaCompressed = lda*individuals for doubled cols ->
    # plane-1 rows for ALL individuals, then the plane-2 block.
    h = _haplo([[1, 0, 3, 2, 1, 3, 0, 2, 1],
                [2, 3, 0, 1, 0, 1, 3, 2, 0]])
    want = np.zeros((4, 2), np.uint8)  # 2 indiv x 2 planes, 2 bytes/row
    for i in range(2):
        for s in range(9):
            want[i, s // 8] |= (h[i, s] & 1) << (s % 8)
            want[2 + i, s // 8] |= ((h[i, s] >> 1) & 1) << (s % 8)
    buf = encode(h, Coding.ONE_BIT_HAPLO)
    np.testing.assert_array_equal(buf, want)
    np.testing.assert_array_equal(decode(want, Coding.ONE_BIT_HAPLO, 2, 9), h)


def test_one_byte_haplo_golden():
    h = _haplo([[1, 3, 0], [2, 0, 1]])
    want = np.array([[1, 1, 0],   # indiv 0 allele1
                     [0, 0, 1],   # indiv 1 allele1
                     [0, 1, 0],   # indiv 0 allele2 (twin plane block)
                     [1, 0, 0]], np.uint8)
    buf = encode(h, Coding.ONE_BYTE_HAPLO)
    np.testing.assert_array_equal(buf, want)
    np.testing.assert_array_equal(decode(want, Coding.ONE_BYTE_HAPLO, 2, 3), h)


def test_four_byte_haplo_golden():
    h = _haplo([[1, 3, 0], [2, 0, 1]])
    want = np.array([[1, 1, 0], [0, 0, 1],
                     [0, 1, 0], [1, 0, 0]], np.int32)
    buf = encode(h, Coding.FOUR_BYTE_HAPLO)
    np.testing.assert_array_equal(buf, want)
    assert buf.dtype == np.int32
    np.testing.assert_array_equal(
        decode(want, Coding.FOUR_BYTE_HAPLO, 2, 3), h)


def test_eight_byte_haplo_golden():
    # HaploUint.cc:54-58: nextHaploIncr=2, delta=1 -> adjacent
    # (allele1, allele2) int pairs per SNP within each individual's row.
    h = _haplo([[1, 3, 0], [2, 0, 1]])
    want = np.array([[1, 0, 1, 1, 0, 0],
                     [0, 1, 0, 0, 1, 0]], np.int32)
    buf = encode(h, Coding.EIGHT_BYTE_HAPLO)
    np.testing.assert_array_equal(buf, want)
    np.testing.assert_array_equal(
        decode(want, Coding.EIGHT_BYTE_HAPLO, 2, 3), h)
