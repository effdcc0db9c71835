"""The two codecs as host functions: a payload in host memory to an
(height, width) uint16 NumPy array. The counterparts of
``mcraw.decode_modern`` and ``mcraw.decode_legacy``
(``mcraw.kernels.numpy_ref``), with their positional signature; a payload
those reject raises :class:`~mcraw_torch.errors.DecodeError` here too.
``device="cuda"`` (the default) decodes through the codec's kernel and
raises without a card; ``device="cpu"`` runs its plain torch version.

Each device has one kept :class:`~mcraw_torch.kernels.staging.Staging`,
grown to the largest payload decoded there (a new one a call costs new
host and device buffers each time); a lock lets one call at a time use
it, from the host prep to the copy of the result to the host.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .kernels.legacy import decode_legacy as _decode_legacy_frame
from .kernels.staging import Staging
from .kernels.unpack import decode_modern_frame
from .pipeline import resolve_device

_STAGINGS: dict[torch.device, Staging] = {}
_STAGINGS_LOCK = threading.Lock()


def _decode(decode_frame, data, width: int, height: int, device) -> np.ndarray:
    dev = resolve_device(device)
    payload = np.asarray(data, dtype=np.uint8)
    with _STAGINGS_LOCK:
        if dev not in _STAGINGS:
            _STAGINGS[dev] = Staging(dev)
        return decode_frame(payload, width, height, _STAGINGS[dev]).cpu().numpy()


def decode_modern(data, width: int, height: int, device="cuda") -> np.ndarray:
    """Decode a compressionType-7 payload to an (height, width) uint16
    plane."""
    return _decode(decode_modern_frame, data, width, height, device)


def decode_legacy(data, width: int, height: int, device="cuda") -> np.ndarray:
    """Decode a compressionType-6 payload to an (height, width) uint16
    plane."""
    return _decode(_decode_legacy_frame, data, width, height, device)
