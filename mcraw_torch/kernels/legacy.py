"""Legacy-codec (compressionType 6) decode: host scan, upload, unpack.

The frame's path, as in the JAX package's single-frame device path
(``pallas_legacy.prepare_legacy_light`` + ``decode_legacy_device_v6``):

1. :func:`prepare_legacy` (host): walk the inline 2-byte header chain with
   the scan ladder of ``mcraw.kernels.unpack.prepare_legacy`` (C++ via
   :mod:`mcraw_torch.kernels.native`), giving every block's bits, reference
   and payload offset, and build the upload buffer.
2. :func:`upload` (H2D).
3. :func:`decode_legacy_device`: the hand-written CUDA kernel
   (``csrc/unpack_legacy.cu``) unpacks every block's MSB-first bitstream,
   adds its reference and writes the even/odd-interleaved rows of the
   (height, width) uint16 plane.

:func:`decode_legacy_plain` is the same function in plain torch, driven by
the byte-field tables. The wrapper takes it only for tensors on the CPU; a
CUDA tensor goes to the kernel or the call raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import build
from . import native
from . import numpy_ref as R
from .tables import legacy_tables

# mcraw.kernels.unpack.LEGACY_PARALLEL_MIN_BLOCKS (that module imports
# JAX): below this block count the serial scan is faster than dispatching
# the threads of a parallel one.
LEGACY_PARALLEL_MIN_BLOCKS = 1 << 16

# Zeroed bytes after the payload in the upload buffer. A value's window
# reaches past its block's last byte; the kernel and the plain version read
# 0 at or past the end of the buffer, so the tail is not needed for
# correctness, only kept as the layout the host prep uploads.
TAIL_BYTES = 4

# Launch counters: the kernel's launches and the plain version's calls.
KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0


class LegacyFrame(NamedTuple):
    """Host-side result of :func:`prepare_legacy` for one frame."""

    payload: np.ndarray  # (n + TAIL_BYTES,) uint8: payload + zeroed tail
    bits: np.ndarray  # (nblk,) int32 header bits
    refs: np.ndarray  # (nblk,) uint16 12-bit references
    offsets: np.ndarray  # (nblk,) int64 byte offset just past each header
    scan: str  # the scan that walked the chain: parallel, speculative, serial


def num_blocks(width: int, height: int) -> int:
    """Blocks in a frame: two 16-value blocks per 32 padded columns."""
    return height * (R.legacy_padded_width(width) // 32) * 2


def scan_chain(payload: np.ndarray, nblk: int):
    """Walk the header chain of `nblk` blocks: ((bits, refs, offsets), the
    name of the scan that did it).

    Large frames try the chunk-parallel scan over the trailing offset table,
    then the speculative parallel scan; either returns None where it cannot
    reproduce the serial walk (no or bogus table, truncation near the end,
    no convergence), and the serial walk then gives the result or its
    :class:`DecodeError`."""
    scanned, scan = None, "serial"
    if nblk >= LEGACY_PARALLEL_MIN_BLOCKS:
        chunks = R.legacy_chunk_offsets(payload)
        if chunks:
            scanned = native.legacy_scan_parallel(payload, nblk, chunks)
            scan = "parallel"
        if scanned is None:
            scanned = native.legacy_scan_speculative(payload, nblk)
            scan = "speculative"
    if scanned is None:
        scanned = native.legacy_scan(payload, nblk)
        scan = "serial"
    return scanned, scan


def prepare_legacy(payload: np.ndarray, width: int, height: int) -> LegacyFrame:
    """The header-chain scan (:func:`scan_chain`) and the upload buffer
    (host side)."""
    payload = np.asarray(payload, dtype=np.uint8)
    (bits, refs, offsets), scan = scan_chain(payload, num_blocks(width, height))

    n = len(payload)
    buf = np.zeros(n + TAIL_BYTES, dtype=np.uint8)
    buf[:n] = payload
    return LegacyFrame(buf, bits, refs, offsets, scan)


class DeviceLegacyFrame(NamedTuple):
    """A frame's inputs on the device, ready for the unpack."""

    payload: torch.Tensor  # (n + TAIL_BYTES,) uint8
    bits: torch.Tensor  # (nblk,) int32
    refs: torch.Tensor  # (nblk,) uint16
    offsets: torch.Tensor  # (nblk,) int64


def upload(frame: LegacyFrame, device: torch.device) -> DeviceLegacyFrame:
    """Copy a prepared frame's buffers to `device`."""

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    return DeviceLegacyFrame(
        put(frame.payload), put(frame.bits), put(frame.refs), put(frame.offsets)
    )


def _check_inputs(payload, bits, refs, offsets, nblk: int) -> None:
    for name, t, dtype in (
        ("payload", payload, torch.uint8),
        ("bits", bits, torch.int32),
        ("refs", refs, torch.uint16),
        ("offsets", offsets, torch.int64),
    ):
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous 1-D {dtype} tensor, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
        if t.device != payload.device:
            raise ValueError(f"{name} is on {t.device}, payload on {payload.device}")
    for name, t in (("bits", bits), ("refs", refs), ("offsets", offsets)):
        if t.numel() != nblk:
            raise ValueError(f"{name} has {t.numel()} entries, need {nblk}")


def decode_legacy_plain(
    payload: torch.Tensor,
    bits: torch.Tensor,
    refs: torch.Tensor,
    offsets: torch.Tensor,
    *,
    height: int,
    width: int,
) -> torch.Tensor:
    """Plain torch version of the legacy unpack kernel (any device).

    The semantics of ``numpy_ref.unpack_blocks(modern=False)`` +
    ``legacy_interleave`` and the crop: each value is the OR of at most two
    byte fields ``((payload[offset + pos] >> rsh) & msk) << lsh`` of its
    block's class (bits clamped to 0..16), plus the block's reference,
    wrapped to 16 bits. Bytes outside the payload read as 0. Computes in
    int64, since CPU uint16 tensors support neither ``>>`` nor ``+``, and
    casts at the end."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    pw = R.legacy_padded_width(width)
    _check_inputs(payload, bits, refs, offsets, num_blocks(width, height))
    dev = payload.device
    if height == 0 or width == 0:
        return torch.empty((height, width), dtype=torch.uint16, device=dev)
    tab = legacy_tables(dev)
    cls = tab.class_index[bits.to(torch.int64).clamp(0, 16)]  # (nblk,)
    idx = offsets[:, None, None] + tab.pos[cls]  # (nblk, 16, 2)
    n = payload.numel()
    inside = (idx >= 0) & (idx < n)
    byte = payload.to(torch.int64)[idx.clamp(0, max(n - 1, 0))]
    byte = torch.where(inside, byte, 0)
    f = ((byte >> tab.rsh[cls]) & tab.msk[cls]) << tab.lsh[cls]
    v = ((f[..., 0] | f[..., 1]) + refs.to(torch.int64)[:, None]) & 0xFFFF
    img = v.reshape(height * (pw // 32), 2, 16).transpose(1, 2)  # (pair, k, parity)
    return img.reshape(height, pw)[:, :width].to(torch.uint16)


def decode_legacy_device(
    payload: torch.Tensor,
    bits: torch.Tensor,
    refs: torch.Tensor,
    offsets: torch.Tensor,
    *,
    height: int,
    width: int,
) -> torch.Tensor:
    """Unpack + interleave + crop one legacy frame: (height, width) uint16.

    payload: (P,) uint8, the payload and its zeroed tail;
    bits, refs, offsets: (nblk,) int32 / uint16 / int64 from the host scan,
    nblk = :func:`num_blocks` (width, height).
    CUDA tensors launch the kernel on the current stream; CPU tensors take
    :func:`decode_legacy_plain`; any other device raises."""
    global KERNEL_LAUNCHES
    if payload.device.type == "cpu":
        return decode_legacy_plain(
            payload, bits, refs, offsets, height=height, width=width
        )
    if payload.device.type != "cuda":
        raise ValueError(f"no legacy unpack kernel for device {payload.device}")
    _check_inputs(payload, bits, refs, offsets, num_blocks(width, height))
    out = torch.empty((height, width), dtype=torch.uint16, device=payload.device)
    if height == 0 or width == 0:
        return out
    lib = build.lib()
    with torch.cuda.device(payload.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mcraw_unpack_legacy(
            payload.data_ptr(), payload.numel(),
            bits.data_ptr(), refs.data_ptr(), offsets.data_ptr(),
            out.data_ptr(), height, width, R.legacy_padded_width(width), stream,
        )
    build.check(err, "mcraw_unpack_legacy")
    KERNEL_LAUNCHES += 1
    return out


def decode_legacy(
    payload: np.ndarray, width: int, height: int, device: torch.device
) -> torch.Tensor:
    """One legacy payload -> (height, width) uint16 on `device`."""
    dev = upload(prepare_legacy(payload, width, height), device)
    return decode_legacy_device(
        dev.payload, dev.bits, dev.refs, dev.offsets, height=height, width=width
    )
