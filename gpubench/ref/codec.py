"""Plain decoders of both MCRAW block codecs, from the payload bytes alone.

The benchmark's reference for the decode: the semantics of the reference
decoder's ``raw::Decode`` (``lib/RawData.cpp:528-612``, compressionType 7)
and ``raw::DecodeLegacy`` (``lib/RawData_Legacy.cpp:445-495``,
compressionType 6), written as plain torch operations that run on any
device, so that the check after a run's window takes seconds on the card.
It imports nothing of the program or of JAX and takes nothing that the
program made: it scans the headers, works out every block's bits,
reference and offset, and unpacks the blocks again.

- Modern: the two metadata streams are walked on the host (one inline
  header per 64 blocks); the main data's offsets are 16 + the exclusive
  prefix sum of the block lengths; each block is unpacked through the field
  tables and the Bayer phases de-interleaved.
- Legacy: every block has an inline header, so the chain of headers is
  serial. It is followed here by pointer doubling over every byte position
  (``next[p] = p + 2 + length(bits at p)``): after k rounds the first 2^k
  links are known. The walk raises where the serial walk would (a header
  or a payload reaching the end of the payload).

Planes come back as (height, width) int32 tensors on the payload's device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import tables as T

METADATA_OFFSET = 16  # RawData.cpp:25
HEADER_LENGTH = 2  # the inline block header, RawData.cpp:24


class DecodeError(ValueError):
    """A payload the reference decoder refuses."""


def _u32(data: np.ndarray, offset: int) -> int:
    return int.from_bytes(data[offset : offset + 4].tobytes(), "little")


def _tables(modern: bool, device) -> tuple[torch.Tensor, ...]:
    if modern:
        arrays = (T.MODERN_POS, T.MODERN_RSH, T.MODERN_MSK, T.MODERN_LSH, T.MODERN_CLASS_INDEX)
    else:
        arrays = (T.LEGACY_POS, T.LEGACY_RSH, T.LEGACY_MSK, T.LEGACY_LSH, T.LEGACY_CLASS_INDEX)
    return tuple(torch.as_tensor(np.asarray(a, np.int64), device=device) for a in arrays)


def unpack_blocks(windows: torch.Tensor, bits: torch.Tensor, modern: bool) -> torch.Tensor:
    """(N, BLOCK) int64 values of N blocks, references not added.

    windows: (N, MAX_LENGTH) uint8, each block's payload bytes, zero past
    its length; bits: (N,) int64 bit widths, 0..16."""
    pos, rsh, msk, lsh, cls_index = _tables(modern, windows.device)
    ci = cls_index[bits]
    p = pos[ci]  # (N, BLOCK, FIELDS)
    g = windows.to(torch.int64)[:, None, :].expand(-1, p.shape[1], -1)
    picked = torch.gather(g, 2, p)
    vals = ((picked >> rsh[ci]) & msk[ci]) << lsh[ci]
    out = vals[..., 0]
    for f in range(1, vals.shape[-1]):
        out = out | vals[..., f]
    return out


def _windows(data: torch.Tensor, offsets: torch.Tensor, length: int) -> torch.Tensor:
    """(N, length) bytes from each offset, zero past the payload's end."""
    padded = torch.zeros(data.numel() + length, dtype=torch.uint8, device=data.device)
    padded[: data.numel()] = data
    return padded[offsets[:, None] + torch.arange(length, device=data.device)]


def metadata_stream(data: np.ndarray, offset: int, device) -> torch.Tensor:
    """One modern metadata stream (``DecodeMetadata``, RawData.cpp:463-498):
    a u32 count of values, then groups of 64 values, each an inline header
    (4-bit bits, 12-bit reference) and its block. (count,) int64."""
    n = len(data)
    if offset + 4 > n:
        raise DecodeError("metadata stream header out of bounds")
    count = _u32(data, offset)
    offset += 4
    if count > 64 * max(0, n - offset) // 2:
        raise DecodeError("metadata stream declares an impossible count")
    groups = (count + 63) // 64
    bits = np.zeros(groups, np.int64)
    refs = np.zeros(groups, np.int64)
    windows = np.zeros((groups, T.MODERN_MAX_LENGTH), np.uint8)
    for g in range(groups):
        if offset + HEADER_LENGTH > n:
            raise DecodeError("metadata stream truncated (header)")
        b0, b1 = int(data[offset]), int(data[offset + 1])
        bits[g], refs[g] = (b0 >> 4) & 0x0F, ((b0 & 0x0F) << 8) | b1
        offset += HEADER_LENGTH
        length = int(T.MODERN_BLOCK_LENGTH[bits[g]])
        if offset + length > n:
            raise DecodeError("metadata stream truncated (payload)")
        windows[g, :length] = data[offset : offset + length]
        offset += length
    vals = unpack_blocks(torch.from_numpy(windows).to(device),
                         torch.from_numpy(bits).to(device), modern=True)
    vals = (vals + torch.from_numpy(refs).to(device)[:, None]) & 0xFFFF
    return vals.reshape(-1)[:count]


def decode_modern(payload: np.ndarray, width: int, height: int, device="cpu") -> torch.Tensor:
    """A compressionType 7 payload as a (height, width) int32 plane."""
    data = np.asarray(payload, dtype=np.uint8)
    n = len(data)
    if n < METADATA_OFFSET:
        raise DecodeError("payload too short for its header")
    enc_w, enc_h, bits_off, refs_off = (_u32(data, 4 * i) for i in range(4))
    if bits_off > n or refs_off > n:
        raise DecodeError("metadata offsets out of bounds")
    if enc_w % T.MODERN_BLOCK != 0 or enc_w < width:
        raise DecodeError("bad encoded width")
    tiles_y, tiles_x = (enc_h + 3) // 4, enc_w // T.MODERN_BLOCK
    nblk = 4 * tiles_y * tiles_x
    bits = metadata_stream(data, bits_off, device)
    refs = metadata_stream(data, refs_off, device)
    if bits.numel() < nblk or refs.numel() < nblk:
        raise DecodeError("metadata streams shorter than the block count")
    bits = bits[:nblk].clamp(max=16)
    lengths = torch.as_tensor(np.asarray(T.MODERN_BLOCK_LENGTH, np.int64), device=device)[bits]
    offsets = METADATA_OFFSET + torch.cumsum(lengths, 0) - lengths
    if nblk and int(offsets[-1] + lengths[-1]) > n:
        raise DecodeError("main data truncated")
    dev = torch.from_numpy(data.copy()).to(device)
    vals = unpack_blocks(_windows(dev, offsets, T.MODERN_MAX_LENGTH), bits, modern=True)
    vals = (vals + refs[:nblk, None]) & 0xFFFF
    # Per tile, blocks p0..p3 hold the Bayer phases: row 2h+q takes its even
    # columns from p[2q], its odd ones from p[2q+1], half h values [32h, 32h+32).
    img = vals.reshape(tiles_y, tiles_x, 2, 2, 2, 32).permute(0, 4, 2, 1, 5, 3)
    img = img.reshape(4 * tiles_y, 64 * tiles_x)[:height, :width]
    out = torch.zeros((height, width), dtype=torch.int32, device=device)
    out[: img.shape[0]] = img.to(torch.int32)  # rows past 4*tiles_y stay 0
    return out


def legacy_chain(data: torch.Tensor, nblk: int) -> torch.Tensor:
    """(nblk,) int64 byte position of every legacy block header, the serial
    walk of ``DecodeBlock`` (RawData_Legacy.cpp:377-442) by pointer
    doubling. Raises where the walk finds a header or a payload reaching
    the payload's end (its checks are ``>=``, :387, :398)."""
    n = data.numel()
    device = data.device
    lengths = torch.as_tensor(np.asarray(T.LEGACY_BLOCK_LENGTH, np.int64), device=device)
    step = HEADER_LENGTH + lengths[(data.to(torch.int64) >> 4).clamp(max=16)]
    nxt = torch.arange(n, device=device) + step
    # n is the sink: a link that reaches the end goes there, and stays.
    jump = torch.cat([torch.where(nxt >= n, n, nxt), torch.tensor([n], device=device)])
    chain = torch.zeros(1, dtype=torch.int64, device=device)
    while chain.numel() < nblk + 1:
        chain = torch.cat([chain, jump[chain]])
        jump = jump[jump]
    chain = chain[: nblk + 1]
    if n <= HEADER_LENGTH or int(chain[-1]) >= n:
        raise DecodeError("legacy stream truncated")
    return chain[:nblk]


def decode_legacy(payload: np.ndarray, width: int, height: int, device="cpu") -> torch.Tensor:
    """A compressionType 6 payload as a (height, width) int32 plane."""
    data = torch.from_numpy(np.asarray(payload, dtype=np.uint8).copy()).to(device)
    padded_width = 32 * ((width + 31) // 32)
    nblk = height * (padded_width // 32) * 2
    heads = legacy_chain(data, nblk)
    b0 = data[heads].to(torch.int64)
    bits = ((b0 >> 4) & 0x0F).clamp(max=16)
    refs = ((b0 & 0x0F) << 8) | data[heads + 1].to(torch.int64)
    vals = unpack_blocks(_windows(data, heads + HEADER_LENGTH, T.LEGACY_MAX_LENGTH), bits,
                         modern=False)
    vals = (vals + refs[:, None]) & 0xFFFF
    # Blocks alternate even and odd pixels of 32 columns (:483-486).
    img = vals.reshape(-1, 2, 16).transpose(1, 2).reshape(height, padded_width)
    return img[:, :width].to(torch.int32).contiguous()


def decode(payload: np.ndarray, codec: str, width: int, height: int, device="cpu"
           ) -> torch.Tensor:
    """The plane of one payload of `codec` ("modern" or "legacy")."""
    if codec == "modern":
        return decode_modern(payload, width, height, device)
    if codec == "legacy":
        return decode_legacy(payload, width, height, device)
    raise ValueError(f"unknown codec {codec!r}")
