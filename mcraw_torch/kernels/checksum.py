"""Wrap-around uint32 checksum of a device tensor.

Equals ``int(x.astype(np.int64).sum() & 0xFFFFFFFF)`` on the host. It gates
correctness where a decoded frame stays on the device: compare it with the
oracle's checksum instead of copying 25 MB back. The hand-written CUDA
kernel (``csrc/checksum.cu``) takes any shape of uint16 or uint32; CPU
tensors take :func:`checksum_plain`.
"""

from __future__ import annotations

import torch

from . import build

KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0

_ELEM_BYTES = {torch.uint16: 2, torch.uint32: 4}


def _check(x: torch.Tensor) -> None:
    if x.dtype not in _ELEM_BYTES:
        raise ValueError(f"checksum takes uint16 or uint32, got {x.dtype}")


def checksum_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain torch version: 0-d int64 tensor in [0, 2^32) on x's device."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    _check(x)
    # int64 holds the exact sum: at most 2^32 per element, < 2^31 elements.
    return x.to(torch.int64).sum() & 0xFFFFFFFF


def device_checksum(x: torch.Tensor) -> torch.Tensor:
    """0-d int64 tensor on x's device holding the uint32 wrap-around sum.

    CUDA tensors launch the kernel on the current stream (no host sync);
    CPU tensors take :func:`checksum_plain`; any other device raises."""
    global KERNEL_LAUNCHES
    if x.device.type == "cpu":
        return checksum_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no checksum kernel for device {x.device}")
    _check(x)
    x = x.contiguous()
    # The C entry zeroes the int64 and the kernel adds into its low 32-bit
    # word (the card is little-endian), so it holds the uint32 sum.
    out = torch.empty((), dtype=torch.int64, device=x.device)
    lib = build.lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mcraw_checksum(
            x.data_ptr(), x.numel(), _ELEM_BYTES[x.dtype], out.data_ptr(), stream
        )
    build.check(err, "mcraw_checksum")
    KERNEL_LAUNCHES += 1
    return out
