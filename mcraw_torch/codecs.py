"""The two codecs as host functions: a payload in host memory to an
(height, width) uint16 NumPy array, through the kernels' plain torch
versions on the CPU. The counterparts of ``mcraw.decode_modern`` and
``mcraw.decode_legacy`` (``mcraw.kernels.numpy_ref``); a payload those
reject raises :class:`~mcraw_torch.errors.DecodeError` here too.
"""

from __future__ import annotations

import numpy as np

from .kernels.legacy import decode_legacy as _decode_legacy
from .kernels.staging import Staging
from .pipeline import decode_modern_frame


def decode_modern(data, width: int, height: int) -> np.ndarray:
    """Decode a compressionType-7 payload to an (height, width) uint16
    plane."""
    payload = np.asarray(data, dtype=np.uint8)
    return decode_modern_frame(payload, width, height, Staging("cpu")).numpy()


def decode_legacy(data, width: int, height: int) -> np.ndarray:
    """Decode a compressionType-6 payload to an (height, width) uint16
    plane."""
    payload = np.asarray(data, dtype=np.uint8)
    return _decode_legacy(payload, width, height, Staging("cpu")).numpy()
