"""The benchmark's encoder: images -> MCRAW payloads.

Frozen here so that a later change to the program cannot move the inputs.
It writes the same bytes as the program's ``encode.encode_modern``,
``encode_legacy`` (canonical coding: each block's reference is its
minimum, capped to 12 bits, and its bits the least decode class that holds
the residuals), vectorized over the blocks so that a 3840x2160 frame
encodes in under a second. The tests hold the bytes
equal to the program's. NumPy only: it runs in the set-up's worker
processes.
"""

from __future__ import annotations

import struct

import numpy as np

from .ref import tables as T

REF_MAX = 0x0FFF  # a block header's reference is 12 bits (RawData.cpp:106-110)


def _canonical(blocks: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(bits, refs, residuals) of (N, BLOCK) int64 values."""
    refs = np.minimum(blocks.min(axis=1), REF_MAX)
    resid = blocks - refs[:, None]
    _, needed = np.frexp(resid.max(axis=1).astype(np.float64))  # bit length
    bits = np.where(needed <= 10, needed, 11).astype(np.int64)  # 11..15 decode as 16
    if np.any(needed > 16):
        raise ValueError("a value needs more than 16 bits")
    return bits, refs, resid


def _pack(resid: np.ndarray, bits: np.ndarray, modern: bool) -> tuple[np.ndarray, np.ndarray]:
    """((N, MAX_LENGTH) uint8 block bytes, (N,) lengths): each residual's
    fields ``((v >> lshift) & mask) << rshift`` put into byte ``pos``."""
    if modern:
        pos, rsh, msk, lsh = T.MODERN_POS, T.MODERN_RSH, T.MODERN_MSK, T.MODERN_LSH
        cls_index, lengths, max_len = T.MODERN_CLASS_INDEX, T.MODERN_BLOCK_LENGTH, \
            T.MODERN_MAX_LENGTH
    else:
        pos, rsh, msk, lsh = T.LEGACY_POS, T.LEGACY_RSH, T.LEGACY_MSK, T.LEGACY_LSH
        cls_index, lengths, max_len = T.LEGACY_CLASS_INDEX, T.LEGACY_BLOCK_LENGTH, \
            T.LEGACY_MAX_LENGTH
    ci = cls_index[bits]
    out = np.zeros((len(resid), max_len), np.int64)
    for c in np.unique(ci):  # one decode class at a time: its fields are fixed
        rows = np.flatnonzero(ci == c)
        r, o = resid[rows], np.zeros((len(rows), max_len), np.int64)
        for j, f in zip(*np.nonzero(msk[c])):
            o[:, pos[c, j, f]] |= ((r[:, j] >> lsh[c, j, f]) & msk[c, j, f]) << rsh[c, j, f]
        out[rows] = o
    return out.astype(np.uint8), lengths[bits].astype(np.int64)


def _join(parts: list[tuple[np.ndarray, np.ndarray]]) -> np.ndarray:
    """Rows of each (bytes (N, L), lengths (N,)) part side by side, each
    part's bytes cut to its length, concatenated in row order."""
    rows = np.concatenate([b for b, _ in parts], axis=1)
    cols = np.arange(rows.shape[1])[None, :]
    keep = np.zeros(rows.shape, dtype=bool)
    lo = 0
    for b, n in parts:
        keep |= (cols >= lo) & (cols < lo + np.asarray(n)[:, None])
        lo += b.shape[1]
    return rows[keep]


def _value_stream(values: np.ndarray) -> bytes:
    """A metadata stream's groups: 64 values a group, each an inline header
    (4-bit bits, 12-bit reference) and its block; a short last group is
    padded with its reference."""
    values = np.asarray(values, np.int64)
    groups = (len(values) + 63) // 64
    g = np.zeros((groups, 64), np.int64)
    g.reshape(-1)[: len(values)] = values
    tail = len(values) % 64
    if tail:
        g[-1, tail:] = min(int(values[-tail:].min()), REF_MAX)
    bits, refs, resid = _canonical(g)
    body, lengths = _pack(resid, bits, modern=True)
    head = np.stack([((bits & 0x0F) << 4) | ((refs >> 8) & 0x0F), refs & 0xFF], 1)
    return _join([(head.astype(np.uint8), np.full(groups, 2)), (body, lengths)]).tobytes()


def encode_modern(image: np.ndarray) -> bytes:
    """An (H, W) uint16 plane as a compressionType 7 payload: the width
    padded to a multiple of 64 and the height to one of 4, both by
    repeating the edge."""
    image = np.asarray(image, dtype=np.uint16)
    h, w = image.shape
    enc_w, rows = 64 * ((w + 63) // 64), 4 * ((h + 3) // 4)
    image = np.pad(image, ((0, rows - h), (0, enc_w - w)), mode="edge")
    ty, tx = rows // 4, enc_w // 64
    blocks = image.reshape(ty, 2, 2, tx, 32, 2).transpose(0, 3, 2, 5, 1, 4)
    blocks = blocks.reshape(-1, 64).astype(np.int64)
    bits, refs, resid = _canonical(blocks)
    body, lengths = _pack(resid, bits, modern=True)
    main = _join([(body, lengths)]).tobytes()
    bits_stream, refs_stream = _value_stream(bits), _value_stream(refs)
    bits_off = 16 + len(main)
    refs_off = bits_off + 4 + len(bits_stream)
    count = struct.pack("<I", 64 * ((len(blocks) + 63) // 64))
    return (struct.pack("<IIII", enc_w, h, bits_off, refs_off) + main + count + bits_stream
            + count + refs_stream)


def encode_legacy(image: np.ndarray) -> bytes:
    """An (H, W) uint16 plane as a compressionType 6 payload: the width
    padded to a multiple of 32 by repeating the edge, pairs of 16-value
    blocks (even and odd pixels) each behind its inline header, then a 0x00
    guard byte and the trailing table of chunk offsets ([u32 BE
    position][0xFF], one a quarter of the rows)."""
    image = np.asarray(image, dtype=np.uint16)
    h, w = image.shape
    pw = 32 * ((w + 31) // 32)
    image = np.pad(image, ((0, 0), (0, pw - w)), mode="edge")
    blocks = image.reshape(-1, 16, 2).transpose(0, 2, 1).reshape(-1, 16).astype(np.int64)
    bits, refs, resid = _canonical(blocks)
    body, lengths = _pack(resid, bits, modern=False)
    head = np.stack([((bits & 0x0F) << 4) | ((refs >> 8) & 0x0F), refs & 0xFF], 1)
    out = _join([(head.astype(np.uint8), np.full(len(blocks), 2)), (body, lengths)])
    starts = np.cumsum(2 + lengths) - (2 + lengths)
    per_row = (pw // 32) * 2
    chunk_rows = max(1, h // 4)
    table = b"".join(struct.pack(">I", int(starts[row * per_row])) + b"\xff"
                     for row in range(chunk_rows, h, chunk_rows))
    return out.tobytes() + b"\x00" + table


def encode(image: np.ndarray, codec: str) -> bytes:
    if codec == "modern":
        return encode_modern(image)
    if codec == "legacy":
        return encode_legacy(image)
    raise ValueError(f"unknown codec {codec!r}")
