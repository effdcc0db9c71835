"""Bit-field tables of both MCRAW block codecs, frozen for the benchmark's
plain reference (a copy of the JAX package's NumPy tables, so that the
reference imports nothing of the program or of JAX).

Every decoded value in both codecs is a disjoint OR of at most three byte
fields of the form ``((payload[pos] >> rshift) & mask) << lshift``. These
tables enumerate those fields per (bit-width class, output index).

Modern codec (compressionType 7) layouts follow the reference decoder's
SIMD kernels (motioncam-decoder ``lib/RawData.cpp:112-408``): each ``Load``
reads 8 bytes into 8 uint16 lanes, so lane ``l`` of SIMD word ``p_k`` is
payload byte ``8*k + l``; the m-th ``Store`` writes outputs ``8*m .. 8*m+7``.
Legacy codec (compressionType 6) layouts follow its scalar kernels
(``lib/RawData_Legacy.cpp:38-370``).
"""

from __future__ import annotations

import numpy as np

# Number of output uint16 values per block.
MODERN_BLOCK = 64  # RawData.cpp:23 (ENCODING_BLOCK)
LEGACY_BLOCK = 16  # RawData_Legacy.cpp:8 (BLOCK_SIZE)

# Payload bytes per block, indexed by the 4-bit header `bits` value.
# RawData.cpp:27-45
MODERN_BLOCK_LENGTH = np.array(
    [0, 8, 16, 24, 32, 40, 48, 64, 64, 80, 80, 128, 128, 128, 128, 128, 128],
    dtype=np.int32,
)
# RawData_Legacy.cpp:13-32
LEGACY_BLOCK_LENGTH = np.array(
    [0, 2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 32, 32, 32, 32, 32, 32],
    dtype=np.int32,
)

MODERN_MAX_LENGTH = 128
LEGACY_MAX_LENGTH = 32

# Decode-class canonicalization: distinct decode routines, keyed by a
# representative bits value. RawData.cpp:424-458 switch; RawData_Legacy.cpp
# :401-439 switch (legacy `bits` is first clamped to <=16, :395).
MODERN_CLASS_OF_BITS = np.array(
    [0, 1, 2, 3, 4, 5, 6, 8, 8, 10, 10, 16, 16, 16, 16, 16, 16], dtype=np.int32
)
LEGACY_CLASS_OF_BITS = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 16, 16, 16, 16, 16, 16], dtype=np.int32
)

MODERN_CLASSES = (0, 1, 2, 3, 4, 5, 6, 8, 10, 16)
LEGACY_CLASSES = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 16)

MODERN_MAX_FIELDS = 3
LEGACY_MAX_FIELDS = 2


def _modern_field_lists() -> dict[int, list[list[tuple[int, int, int, int]]]]:
    """fields[cls][j] = [(pos, rshift, mask, lshift), ...] for output j."""
    t: dict[int, list[list[tuple[int, int, int, int]]]] = {}

    # class 0: all zeros (RawData.cpp:425-427)
    t[0] = [[] for _ in range(64)]

    # Decode1 (RawData.cpp:113-136): out[8m+l] = (b[l] >> m) & 1
    t[1] = [[] for _ in range(64)]
    for m in range(8):
        for l in range(8):
            t[1][8 * m + l] = [(l, m, 0x01, 0)]

    # Decode2 (RawData.cpp:139-162): two halves of 8 bytes each
    t[2] = [[] for _ in range(64)]
    for half in range(2):
        for m in range(4):
            for l in range(8):
                t[2][32 * half + 8 * m + l] = [(8 * half + l, 2 * m, 0x03, 0)]

    # Decode3 (RawData.cpp:165-199)
    t[3] = [[] for _ in range(64)]
    for l in range(8):
        t[3][l] = [(l, 0, 0x07, 0)]
        t[3][8 + l] = [(l, 3, 0x07, 0)]
        t[3][16 + l] = [(l, 6, 0x03, 0), (16 + l, 6, 0x01, 2)]
        t[3][24 + l] = [(8 + l, 0, 0x07, 0)]
        t[3][32 + l] = [(8 + l, 3, 0x07, 0)]
        t[3][40 + l] = [(8 + l, 6, 0x03, 0), (16 + l, 7, 0x01, 2)]
        t[3][48 + l] = [(16 + l, 0, 0x07, 0)]
        t[3][56 + l] = [(16 + l, 3, 0x07, 0)]

    # Decode4 (RawData.cpp:202-223): four sub-blocks of 8 bytes
    t[4] = [[] for _ in range(64)]
    for c in range(4):
        for m in range(2):
            for l in range(8):
                t[4][16 * c + 8 * m + l] = [(8 * c + l, 4 * m, 0x0F, 0)]

    # Decode5 (RawData.cpp:226-262)
    t[5] = [[] for _ in range(64)]
    for k in range(5):
        for l in range(8):
            t[5][8 * k + l] = [(8 * k + l, 0, 0x1F, 0)]
    for l in range(8):
        t[5][40 + l] = [(l, 5, 0x07, 0), (24 + l, 5, 0x03, 3)]
        t[5][48 + l] = [(8 + l, 5, 0x07, 0), (32 + l, 5, 0x03, 3)]
        t[5][56 + l] = [
            (16 + l, 5, 0x07, 0),
            (24 + l, 7, 0x01, 3),
            (32 + l, 7, 0x01, 4),
        ]

    # Decode6 (RawData.cpp:265-304). The duplicated OR term at :285-286 is a
    # no-op and intentionally not replicated.
    t[6] = [[] for _ in range(64)]
    for k in range(6):
        for l in range(8):
            t[6][8 * k + l] = [(8 * k + l, 0, 0x3F, 0)]
    for l in range(8):
        t[6][48 + l] = [(l, 6, 0x03, 0), (8 + l, 6, 0x03, 2), (16 + l, 6, 0x03, 4)]
        t[6][56 + l] = [
            (24 + l, 6, 0x03, 0),
            (32 + l, 6, 0x03, 2),
            (40 + l, 6, 0x03, 4),
        ]

    # Decode8 (RawData.cpp:307-326): raw bytes
    t[8] = [[(j, 0, 0xFF, 0)] for j in range(64)]

    # Decode10 (RawData.cpp:329-374)
    t[10] = [[] for _ in range(64)]
    for k in range(4):
        for l in range(8):
            t[10][8 * k + l] = [(8 * k + l, 0, 0xFF, 0), (32 + l, 2 * k, 0x03, 8)]
            t[10][32 + 8 * k + l] = [
                (40 + 8 * k + l, 0, 0xFF, 0),
                (72 + l, 2 * k, 0x03, 8),
            ]

    # Decode16 (RawData.cpp:377-408): native little-endian uint16
    t[16] = [[(2 * j, 0, 0xFF, 0), (2 * j + 1, 0, 0xFF, 8)] for j in range(64)]

    return t


def _legacy_field_lists() -> dict[int, list[list[tuple[int, int, int, int]]]]:
    t: dict[int, list[list[tuple[int, int, int, int]]]] = {}

    # class 0: zeros (RawData_Legacy.cpp:402-404)
    t[0] = [[] for _ in range(16)]

    # Decode1 (:38-68): MSB-first bits
    t[1] = [[(i, 7 - k, 0x01, 0)] for i in range(2) for k in range(8)]

    # Decode2 (:70-88)
    t[2] = [[(i, 6 - 2 * k, 0x03, 0)] for i in range(4) for k in range(4)]

    # Decode3 (:90-122): 2 iterations x 3 bytes -> 8 outputs
    t[3] = [[] for _ in range(16)]
    for i in range(2):
        b = 3 * i
        o = 8 * i
        t[3][o + 0] = [(b, 5, 0x07, 0)]
        t[3][o + 1] = [(b, 2, 0x07, 0)]
        t[3][o + 2] = [(b, 0, 0x03, 1), (b + 1, 7, 0x01, 0)]
        t[3][o + 3] = [(b + 1, 4, 0x07, 0)]
        t[3][o + 4] = [(b + 1, 1, 0x07, 0)]
        t[3][o + 5] = [(b + 1, 0, 0x01, 2), (b + 2, 6, 0x03, 0)]
        t[3][o + 6] = [(b + 2, 3, 0x07, 0)]
        t[3][o + 7] = [(b + 2, 0, 0x07, 0)]

    # Decode4 (:124-136)
    t[4] = [[] for _ in range(16)]
    for i in range(8):
        t[4][2 * i] = [(i, 4, 0x0F, 0)]
        t[4][2 * i + 1] = [(i, 0, 0x0F, 0)]

    # Decode5 (:138-176): 2 iterations x 5 bytes -> 8 outputs
    t[5] = [[] for _ in range(16)]
    for i in range(2):
        b = 5 * i
        o = 8 * i
        t[5][o + 0] = [(b, 3, 0x1F, 0)]
        t[5][o + 1] = [(b, 0, 0x07, 2), (b + 1, 6, 0x03, 0)]
        t[5][o + 2] = [(b + 1, 1, 0x1F, 0)]
        t[5][o + 3] = [(b + 1, 0, 0x01, 4), (b + 2, 4, 0x0F, 0)]
        t[5][o + 4] = [(b + 2, 0, 0x0F, 1), (b + 3, 7, 0x01, 0)]
        t[5][o + 5] = [(b + 3, 2, 0x1F, 0)]
        t[5][o + 6] = [(b + 3, 0, 0x03, 3), (b + 4, 5, 0x07, 0)]
        t[5][o + 7] = [(b + 4, 0, 0x1F, 0)]

    # Decode6 (:178-200): 4 iterations x 3 bytes -> 4 outputs
    t[6] = [[] for _ in range(16)]
    for i in range(4):
        b = 3 * i
        o = 4 * i
        t[6][o + 0] = [(b, 2, 0x3F, 0)]
        t[6][o + 1] = [(b, 0, 0x03, 4), (b + 1, 4, 0x0F, 0)]
        t[6][o + 2] = [(b + 1, 0, 0x0F, 2), (b + 2, 6, 0x03, 0)]
        t[6][o + 3] = [(b + 2, 0, 0x3F, 0)]

    # Decode7 (:202-244): 2 iterations x 7 bytes -> 8 outputs
    t[7] = [[] for _ in range(16)]
    for i in range(2):
        b = 7 * i
        o = 8 * i
        t[7][o + 0] = [(b, 1, 0x7F, 0)]
        t[7][o + 1] = [(b, 0, 0x01, 6), (b + 1, 2, 0x3F, 0)]
        t[7][o + 2] = [(b + 1, 0, 0x03, 5), (b + 2, 3, 0x1F, 0)]
        t[7][o + 3] = [(b + 2, 0, 0x07, 4), (b + 3, 4, 0x0F, 0)]
        t[7][o + 4] = [(b + 3, 0, 0x0F, 3), (b + 4, 5, 0x07, 0)]
        t[7][o + 5] = [(b + 4, 0, 0x1F, 2), (b + 5, 6, 0x03, 0)]
        t[7][o + 6] = [(b + 5, 0, 0x3F, 1), (b + 6, 7, 0x01, 0)]
        t[7][o + 7] = [(b + 6, 0, 0x7F, 0)]

    # Decode8 (:246-282)
    t[8] = [[(j, 0, 0xFF, 0)] for j in range(16)]

    # Decode9 (:284-330): 2 iterations x 9 bytes -> 8 outputs
    t[9] = [[] for _ in range(16)]
    for i in range(2):
        b = 9 * i
        o = 8 * i
        t[9][o + 0] = [(b, 0, 0xFF, 1), (b + 1, 7, 0x01, 0)]
        t[9][o + 1] = [(b + 1, 0, 0x7F, 2), (b + 2, 6, 0x03, 0)]
        t[9][o + 2] = [(b + 2, 0, 0x3F, 3), (b + 3, 5, 0x07, 0)]
        t[9][o + 3] = [(b + 3, 0, 0x1F, 4), (b + 4, 4, 0x0F, 0)]
        t[9][o + 4] = [(b + 4, 0, 0x0F, 5), (b + 5, 3, 0x1F, 0)]
        t[9][o + 5] = [(b + 5, 0, 0x07, 6), (b + 6, 2, 0x3F, 0)]
        t[9][o + 6] = [(b + 6, 0, 0x03, 7), (b + 7, 1, 0x7F, 0)]
        t[9][o + 7] = [(b + 7, 0, 0x01, 8), (b + 8, 0, 0xFF, 0)]

    # Decode10 (:332-358): 4 iterations x 5 bytes -> 4 outputs
    t[10] = [[] for _ in range(16)]
    for i in range(4):
        b = 5 * i
        o = 4 * i
        t[10][o + 0] = [(b, 0, 0xFF, 2), (b + 1, 6, 0x03, 0)]
        t[10][o + 1] = [(b + 1, 0, 0x3F, 4), (b + 2, 4, 0x0F, 0)]
        t[10][o + 2] = [(b + 2, 0, 0x0F, 6), (b + 3, 2, 0x3F, 0)]
        t[10][o + 3] = [(b + 3, 0, 0x03, 8), (b + 4, 0, 0xFF, 0)]

    # Decode16 (:360-370): big-endian uint16 (unlike the modern codec!)
    t[16] = [[(2 * j, 0, 0xFF, 8), (2 * j + 1, 0, 0xFF, 0)] for j in range(16)]

    return t


def _pack_tables(
    fields: dict[int, list[list[tuple[int, int, int, int]]]],
    classes: tuple[int, ...],
    block: int,
    max_fields: int,
):
    """Dense arrays (n_classes, block, max_fields) for pos/rsh/msk/lsh.

    Unused field slots get mask 0 (and pos 0, which is always in bounds).
    """
    n = len(classes)
    pos = np.zeros((n, block, max_fields), dtype=np.int32)
    rsh = np.zeros((n, block, max_fields), dtype=np.int32)
    msk = np.zeros((n, block, max_fields), dtype=np.int32)
    lsh = np.zeros((n, block, max_fields), dtype=np.int32)
    for ci, c in enumerate(classes):
        for j in range(block):
            fl = fields[c][j]
            assert len(fl) <= max_fields, (c, j, fl)
            for fi, (p, r, m, s) in enumerate(fl):
                pos[ci, j, fi] = p
                rsh[ci, j, fi] = r
                msk[ci, j, fi] = m
                lsh[ci, j, fi] = s
    return pos, rsh, msk, lsh


MODERN_FIELDS = _modern_field_lists()
LEGACY_FIELDS = _legacy_field_lists()

# Dense tables. Index 0 of axis 0 is class `CLASSES[0]`, etc.
MODERN_POS, MODERN_RSH, MODERN_MSK, MODERN_LSH = _pack_tables(
    MODERN_FIELDS, MODERN_CLASSES, MODERN_BLOCK, MODERN_MAX_FIELDS
)
LEGACY_POS, LEGACY_RSH, LEGACY_MSK, LEGACY_LSH = _pack_tables(
    LEGACY_FIELDS, LEGACY_CLASSES, LEGACY_BLOCK, LEGACY_MAX_FIELDS
)

# bits value (0..16) -> row index into the dense class tables
MODERN_CLASS_INDEX = np.array(
    [MODERN_CLASSES.index(int(c)) for c in MODERN_CLASS_OF_BITS], dtype=np.int32
)
LEGACY_CLASS_INDEX = np.array(
    [LEGACY_CLASSES.index(int(c)) for c in LEGACY_CLASS_OF_BITS], dtype=np.int32
)
