"""Modern-codec descriptor tables as torch tensors.

The single source is :mod:`mcraw.kernels.tables`, which the JAX package
decodes from as well: per class (10) and value (64), up to three
little-endian word fields (widx, rsh, nbits, lsh), plus the 17-entry
bits -> class and bits -> block length lookups. The codec has no learned
parameters; these tables are all that carries across.
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


_cache: dict[str, ModernTables] = {}


def modern_tables(device: torch.device | str = "cpu") -> ModernTables:
    """The tables on `device` (built once per device)."""
    key = str(torch.device(device))
    if key not in _cache:

        def put(a, dtype=torch.int64):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=device, dtype=dtype
            )

        _cache[key] = ModernTables(
            widx=put(T.MODERN_WIDX),
            rsh=put(T.MODERN_WRSH),
            nbits=put(T.MODERN_WNB),
            lsh=put(T.MODERN_WLSH),
            packed=put(pack_descriptors(), torch.int32),
            class_index=put(T.MODERN_CLASS_INDEX),
            block_length=put(T.MODERN_BLOCK_LENGTH),
        )
    return _cache[key]
