"""Wrap-around uint32 checksum of a device tensor.

Equals ``int(x.astype(np.int64).sum() & 0xFFFFFFFF)`` on the host. It gates
correctness where a decoded frame stays on the device: compare it with the
oracle's checksum instead of copying 25 MB back. The hand-written CUDA
kernel (``csrc/checksum.cu``) sums 16- or 32-bit elements of any shape; a
tensor of another integer dtype is first turned, on its device, into 32-bit
words with the same wrap-around sum (:func:`kernel_elements`). CPU tensors
take :func:`checksum_plain`.
"""

from __future__ import annotations

import torch

from .. import observe
from . import build

KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0

_INTEGER = (torch.uint8, torch.int8, torch.int16, torch.uint16, torch.int32,
            torch.uint32, torch.int64, torch.uint64)


def _check(x: torch.Tensor) -> None:
    if x.dtype not in _INTEGER:
        raise ValueError(f"checksum takes an integer tensor, got {x.dtype}")


def checksum_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain torch version: 0-d int64 tensor in [0, 2^32) on x's device,
    for any integer dtype (negative values count as their two's
    complement, as numpy's ``astype(np.int64).sum() & 0xFFFFFFFF``)."""
    global PLAIN_CALLS
    with build.COUNTER_LOCK:
        PLAIN_CALLS += 1
    _check(x)
    # The int64 sum is exact mod 2^64 (it wraps), so its low 32 bits are
    # the uint32 sum.
    return x.to(torch.int64).sum() & 0xFFFFFFFF


def kernel_elements(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """x as elements the kernel sums, and their size in bytes: a contiguous
    tensor whose wrap-around sum mod 2^32 is x's. uint16, int32 and uint32
    as they are; the 8-bit types and int16 widened to int32 (sign-extended
    where signed, so -v adds 2^32 - v); the 64-bit types as the low 32-bit
    word of each element (the card and the host are little-endian)."""
    _check(x)
    x = x.contiguous()
    if x.dtype == torch.uint16:
        return x, 2
    if x.dtype in (torch.int32, torch.uint32):
        return x, 4
    if x.dtype in (torch.uint8, torch.int8, torch.int16):
        return x.to(torch.int32), 4
    return x.reshape(-1).view(torch.int32)[0::2].contiguous(), 4


@observe.spanned("checksum")
def device_checksum(x: torch.Tensor) -> torch.Tensor:
    """0-d int64 tensor on x's device holding the uint32 wrap-around sum.

    CUDA tensors of any integer dtype launch the kernel on the current
    stream (no host sync), after :func:`kernel_elements` where the dtype is
    not one it sums; CPU tensors take :func:`checksum_plain`; any other
    device raises."""
    global KERNEL_LAUNCHES
    if x.device.type == "cpu":
        return checksum_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no checksum kernel for device {x.device}")
    x, elem_bytes = kernel_elements(x)
    # The C entry zeroes the int64 and the kernel adds into its low 32-bit
    # word (the card is little-endian), so it holds the uint32 sum.
    out = torch.empty((), dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.launch("mcraw_checksum", (x, out),
                     x.data_ptr(), x.numel(), elem_bytes, out.data_ptr(), stream)
    with build.COUNTER_LOCK:
        KERNEL_LAUNCHES += 1
    return out
