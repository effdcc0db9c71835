"""The helpers of :mod:`mcraw.kernels.numpy_ref` that the port's host prep
uses, copied so that mcraw_torch imports nothing of mcraw: the modern
payload header and block geometry, the legacy padded width and the legacy
trailing chunk-offset table. tests/test_torch_standalone.py holds each
equal to its original.
"""

from __future__ import annotations

import numpy as np

from . import tables as T
from ..errors import DecodeError

METADATA_OFFSET = 16  # RawData.cpp:25


def read_metadata_header(data: np.ndarray) -> tuple[int, int, int, int]:
    """16-byte modern payload header. RawData.cpp:500-524."""
    if len(data) < METADATA_OFFSET:
        raise DecodeError("payload too short for metadata header")
    h = data[:16].view("<u4")
    return int(h[0]), int(h[1]), int(h[2]), int(h[3])


def modern_block_geometry(encoded_width: int, encoded_height: int) -> tuple[int, int, int]:
    """(tiles_y, tiles_x, num_blocks) for the modern main data."""
    tiles_y = (encoded_height + 3) // 4
    tiles_x = encoded_width // T.MODERN_BLOCK
    return tiles_y, tiles_x, tiles_y * tiles_x * 4


def legacy_padded_width(width: int) -> int:
    """Width padded to a multiple of 32. RawData_Legacy.cpp:34-36."""
    return 32 * ((width + 31) // 32)


def legacy_chunk_offsets(data: np.ndarray) -> list[int]:
    """Parse the trailing chunk-offset table (RawData_Legacy.cpp:452-469).

    Entries of [u32 BE pos][0xFF marker] are walked backwards from the last
    byte while the marker is 0xFF. The reference parses but never uses them;
    they enable parallel chunked decode.
    """
    out: list[int] = []
    n = len(data)
    if n == 0:
        return out
    i = n - 1
    while i >= 4 and data[i] == 0xFF:
        pos = (
            (int(data[i - 4]) << 24)
            | (int(data[i - 3]) << 16)
            | (int(data[i - 2]) << 8)
            | int(data[i - 1])
        )
        out.append(pos)
        i -= 5
    return out
