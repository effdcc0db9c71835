"""Both codecs' field tables as torch tensors.

The single source is :mod:`mcraw.kernels.tables`, which the JAX package
decodes from as well. Modern codec: per class (10) and value (64), up to
three little-endian word fields (widx, rsh, nbits, lsh), plus the 17-entry
bits -> class and bits -> block length lookups. Legacy codec: per class
(12) and value (16), up to two byte fields (pos, rsh, msk, lsh), plus the
17-entry clamped bits -> class row, field width and block length lookups.
The codec has no learned parameters; these tables are all that carries
across.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mcraw.kernels import tables as T


class ModernTables(NamedTuple):
    widx: torch.Tensor  # (10, 64, 3) int64 word index within the block
    rsh: torch.Tensor  # (10, 64, 3) int64 right shift within the word
    nbits: torch.Tensor  # (10, 64, 3) int64 field width; 0 = unused slot
    lsh: torch.Tensor  # (10, 64, 3) int64 left shift into the value
    packed: torch.Tensor  # (10, 64, 3) int32, the kernel's form
    class_index: torch.Tensor  # (17,) int64 clamped bits -> class row
    block_length: torch.Tensor  # (17,) int64 clamped bits -> payload bytes


def pack_descriptors() -> np.ndarray:
    """(10, 64, 3) int32: widx | rsh << 5 | nbits << 10 | lsh << 15."""
    widx, rsh, nb, lsh = T.MODERN_WIDX, T.MODERN_WRSH, T.MODERN_WNB, T.MODERN_WLSH
    if widx.max() > 31 or rsh.max() > 31 or nb.max() > 16 or lsh.max() > 15:
        raise ValueError("modern word-field table out of packing range")
    return (widx | (rsh << 5) | (nb << 10) | (lsh << 15)).astype(np.int32)


class LegacyTables(NamedTuple):
    pos: torch.Tensor  # (12, 16, 2) int64 byte within the block
    rsh: torch.Tensor  # (12, 16, 2) int64 right shift within the byte
    msk: torch.Tensor  # (12, 16, 2) int64 field mask; 0 = unused slot
    lsh: torch.Tensor  # (12, 16, 2) int64 left shift into the value
    class_index: torch.Tensor  # (17,) int64 clamped bits -> class row
    class_of_bits: torch.Tensor  # (17,) int64 clamped bits -> field width
    block_length: torch.Tensor  # (17,) int64 clamped bits -> payload bytes


_cache: dict[tuple[str, str], NamedTuple] = {}


def _put(a: np.ndarray, device, dtype=torch.int64) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


def modern_tables(device: torch.device | str = "cpu") -> ModernTables:
    """The modern tables on `device` (built once per device)."""
    key = ("modern", str(torch.device(device)))
    if key not in _cache:
        _cache[key] = ModernTables(
            widx=_put(T.MODERN_WIDX, device),
            rsh=_put(T.MODERN_WRSH, device),
            nbits=_put(T.MODERN_WNB, device),
            lsh=_put(T.MODERN_WLSH, device),
            packed=_put(pack_descriptors(), device, torch.int32),
            class_index=_put(T.MODERN_CLASS_INDEX, device),
            block_length=_put(T.MODERN_BLOCK_LENGTH, device),
        )
    return _cache[key]


def legacy_tables(device: torch.device | str = "cpu") -> LegacyTables:
    """The legacy tables on `device` (built once per device)."""
    key = ("legacy", str(torch.device(device)))
    if key not in _cache:
        _cache[key] = LegacyTables(
            pos=_put(T.LEGACY_POS, device),
            rsh=_put(T.LEGACY_RSH, device),
            msk=_put(T.LEGACY_MSK, device),
            lsh=_put(T.LEGACY_LSH, device),
            class_index=_put(T.LEGACY_CLASS_INDEX, device),
            class_of_bits=_put(T.LEGACY_CLASS_OF_BITS, device),
            block_length=_put(T.LEGACY_BLOCK_LENGTH, device),
        )
    return _cache[key]
