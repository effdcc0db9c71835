"""Legacy-codec (compressionType 6) decode: host scan, upload, unpack.

A batch of F frames of one geometry, as in the JAX package's device path
(``pallas_legacy.prepare_legacy_light`` + ``decode_legacy_device_v6``); a
single frame is the batch of one, at every step down to the launch:

1. :func:`prepare_legacy_batch` (host): walk each frame's inline 2-byte
   header chain with the scan ladder of the JAX package's
   ``unpack.prepare_legacy`` (C++ via :mod:`mcraw_torch.kernels.native`),
   which writes every block's bits, reference and payload offset straight
   into the frame's rows of a :class:`~mcraw_torch.kernels.staging.Staging`,
   beside the payload in its slot and its zeroed tail;
   :func:`stage_legacy_batch` adds the one H2D that sends them.
2. :func:`decode_legacy_batch_device`: one launch of the hand-written CUDA
   kernel (``csrc/unpack_legacy.cu``) with a frame axis; it unpacks every
   block's MSB-first bitstream, adds its reference and writes the
   even/odd-interleaved rows of each frame's (height, width) uint16 plane.

For one frame, :func:`prepare_legacy` and :func:`stage_legacy` give the
staged batch of one, :func:`unpack_legacy` is step 2 of it and returns its
plane, and :func:`decode_legacy` is both steps: the Decoder's single-frame
path.

:func:`decode_legacy_batch_plain` is the same function in plain torch,
driven by the byte-field tables. The wrapper takes it only for tensors on
the CPU; a CUDA tensor goes to the kernel or the call raises.
:func:`decode_legacy_device` and :func:`decode_legacy_plain` are the two on
one frame's loose tensors.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import observe
from . import build
from . import native
from . import numpy_ref as R
from .tables import legacy_tables
from .staging import (Staging, batch_of_one, check_batch_inputs, frame_spans, slot_bytes,
                      slot_layout)

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


def num_blocks(width: int, height: int) -> int:
    """Blocks in a frame: two 16-value blocks per 32 padded columns."""
    return height * (R.legacy_padded_width(width) // 32) * 2


def scan_chain(payload: np.ndarray, nblk: int, out=None):
    """Walk the header chain of `nblk` blocks: ((bits, refs, offsets), the
    name of the scan that did it). `out`, three (nblk,) int32 / uint16 /
    int64 arrays, receives the result in place of new ones.

    Large frames try the chunk-parallel scan over the trailing offset table,
    then the speculative parallel scan; either returns None where it cannot
    reproduce the serial walk (no or bogus table, truncation near the end,
    no convergence), and the serial walk then gives the result or its
    :class:`DecodeError`."""
    scanned, scan = None, "serial"
    if nblk >= LEGACY_PARALLEL_MIN_BLOCKS:
        chunks = R.legacy_chunk_offsets(payload)
        if chunks:
            scanned = native.legacy_scan_parallel(payload, nblk, chunks, out=out)
            scan = "parallel"
        if scanned is None:
            scanned = native.legacy_scan_speculative(payload, nblk, out=out)
            scan = "speculative"
    if scanned is None:
        scanned = native.legacy_scan(payload, nblk, out=out)
        scan = "serial"
    return scanned, scan


class DeviceLegacyBatch(NamedTuple):
    """A batch's inputs on the device, ready for the unpack."""

    payload: torch.Tensor  # (P,) uint8: every frame's slot, one after another
    bases: torch.Tensor  # (F,) int64 first byte of each frame's slot
    lengths: torch.Tensor  # (F,) int64 payload + TAIL_BYTES of each frame
    bits: torch.Tensor  # (F, nblk) int32
    refs: torch.Tensor  # (F, nblk) uint16
    offsets: torch.Tensor  # (F, nblk) int64, frame-local


def stage_legacy_batch(staging: Staging, payloads, width: int, height: int
                       ) -> DeviceLegacyBatch:
    """:func:`prepare_legacy_batch`, then the batch's inputs sent in one
    H2D."""
    prepare_legacy_batch(staging, payloads, width, height)
    return DeviceLegacyBatch(*staging.upload())


def prepare_legacy_batch(staging: Staging, payloads, width: int, height: int) -> None:
    """The host prep of a batch: its inputs laid out in `staging`, not yet
    sent: each payload straight into its 16-byte aligned slot, followed by
    its zeroed tail; each frame's :func:`scan_chain` straight into its
    rows. The scans are the span ``stage.scan``, the copies
    ``stage.layout``."""
    payloads = [np.asarray(p, dtype=np.uint8) for p in payloads]
    if not payloads:
        raise ValueError("a batch needs at least one frame")
    sizes = [slot_bytes(len(p), TAIL_BYTES) for p in payloads]
    starts, total = slot_layout(sizes)
    frames, nblk = len(payloads), num_blocks(width, height)
    buf, bases, lengths, bits, refs, offsets = staging.host(
        ((total,), np.uint8), ((frames,), np.int64), ((frames,), np.int64),
        ((frames, nblk), np.int32), ((frames, nblk), np.uint16), ((frames, nblk), np.int64))
    with observe.span("stage.scan"):
        for f, p in enumerate(payloads):
            scan_chain(p, nblk, out=(bits[f], refs[f], offsets[f]))
    with observe.span("stage.layout"):
        for p, lo, size in zip(payloads, starts.tolist(), sizes):
            buf[lo : lo + len(p)] = p
            buf[lo + len(p) : lo + size] = 0
        bases[:] = starts
        lengths[:] = [len(p) + TAIL_BYTES for p in payloads]


def prepare_legacy(staging: Staging, payload, width: int, height: int
                   ) -> Callable[[], DeviceLegacyBatch]:
    """The host prep of one frame, the batch of one of
    :func:`prepare_legacy_batch`; returns its upload: a call that sends the
    inputs in one H2D and gives them on the device."""
    prepare_legacy_batch(staging, [payload], width, height)
    return lambda: DeviceLegacyBatch(*staging.upload())


def stage_legacy(staging: Staging, payload, width: int, height: int) -> DeviceLegacyBatch:
    """One frame's inputs on the device, the batch of one:
    :func:`prepare_legacy`, then its upload."""
    return prepare_legacy(staging, payload, width, height)()


def _plain_into(out, payload, bits, refs, offsets, *, padded_width: int) -> None:
    """The plain unpack of one frame into its (height, width) plane."""
    height, width = out.shape
    if height == 0 or width == 0:
        return
    tab = legacy_tables(payload.device)
    cls = tab.class_index[bits.to(torch.int64).clamp(0, 16)]  # (nblk,)
    idx = offsets[:, None, None] + tab.pos[cls]  # (nblk, 16, 2)
    n = payload.numel()
    inside = (idx >= 0) & (idx < n)
    p = payload.to(torch.int64) if n else payload.new_zeros(1, dtype=torch.int64)
    byte = torch.where(inside, p[idx.clamp(0, max(n - 1, 0))], 0)
    f = ((byte >> tab.rsh[cls]) & tab.msk[cls]) << tab.lsh[cls]
    v = ((f[..., 0] | f[..., 1]) + refs.to(torch.int64)[:, None]) & 0xFFFF
    img = v.reshape(height * (padded_width // 32), 2, 16).transpose(1, 2)  # (pair, k, parity)
    out[:] = img.reshape(height, padded_width)[:, :width].to(torch.uint16)


def _check_legacy_batch(payload, bases, lengths, bits, refs, offsets, nblk) -> int:
    if payload.dtype != torch.uint8:
        raise ValueError(f"payload must be uint8, got {payload.dtype}")
    return check_batch_inputs(payload, bases, lengths, (
        ("bits", bits, torch.int32), ("refs", refs, torch.uint16),
        ("offsets", offsets, torch.int64)), nblk)


def decode_legacy_batch_plain(
    payload: torch.Tensor,
    bases: torch.Tensor,
    lengths: torch.Tensor,
    bits: torch.Tensor,
    refs: torch.Tensor,
    offsets: torch.Tensor,
    *,
    height: int,
    width: int,
) -> torch.Tensor:
    """Plain torch version of the legacy unpack kernel (any device): frame
    f is the semantics of ``numpy_ref.unpack_blocks(modern=False)`` +
    ``legacy_interleave`` and the crop on payload[bases[f] : bases[f] +
    lengths[f]] (clamped to the buffer) and row f of bits, refs and
    offsets; stacked into (F, height, width). Each value is the OR of at
    most two byte fields ``((payload[offset + pos] >> rsh) & msk) << lsh``
    of its block's class (bits clamped to 0..16), plus the block's
    reference, wrapped to 16 bits. Bytes outside the frame's payload read
    as 0. Computes in int64, since CPU uint16 tensors support neither
    ``>>`` nor ``+``, and casts at the end."""
    global PLAIN_CALLS
    with build.COUNTER_LOCK:
        PLAIN_CALLS += 1
    frames = _check_legacy_batch(payload, bases, lengths, bits, refs, offsets,
                                 num_blocks(width, height))
    out = torch.empty((frames, height, width), dtype=torch.uint16, device=payload.device)
    pw = R.legacy_padded_width(width)
    for f, (lo, hi) in enumerate(frame_spans(bases, lengths, payload.numel())):
        _plain_into(out[f], payload[lo:hi], bits[f], refs[f], offsets[f], padded_width=pw)
    return out


@observe.spanned("unpack.legacy")
def decode_legacy_batch_device(
    payload: torch.Tensor,
    bases: torch.Tensor,
    lengths: torch.Tensor,
    bits: torch.Tensor,
    refs: torch.Tensor,
    offsets: torch.Tensor,
    *,
    height: int,
    width: int,
) -> torch.Tensor:
    """Unpack + interleave + crop F legacy frames of one geometry in one
    launch: (F, height, width) uint16, frame f computed from its own inputs
    alone (a single frame is the batch of one).

    payload: (P,) uint8, every frame's slot; bases, lengths: (F,) int64
    bytes, frame f's payload and tail; bits, refs, offsets: (F, nblk) int32
    / uint16 / int64 frame-local, from the host scan. CUDA tensors launch
    the kernel once on the current stream; CPU tensors take
    :func:`decode_legacy_batch_plain`; any other device raises."""
    global KERNEL_LAUNCHES
    if payload.device.type == "cpu":
        return decode_legacy_batch_plain(
            payload, bases, lengths, bits, refs, offsets, height=height, width=width
        )
    if payload.device.type != "cuda":
        raise ValueError(f"no legacy unpack kernel for device {payload.device}")
    frames = _check_legacy_batch(payload, bases, lengths, bits, refs, offsets,
                                 num_blocks(width, height))
    out = torch.empty((frames, height, width), dtype=torch.uint16, device=payload.device)
    if height == 0 or width == 0 or frames == 0:
        return out
    with torch.cuda.device(payload.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.launch(
            "mcraw_unpack_legacy_batch", (payload, bits, refs, offsets, out, bases, lengths),
            payload.data_ptr(), payload.numel(), bases.data_ptr(), lengths.data_ptr(),
            frames, bits.data_ptr(), refs.data_ptr(), offsets.data_ptr(),
            out.data_ptr(), height, width, R.legacy_padded_width(width), stream,
        )
    with build.COUNTER_LOCK:
        KERNEL_LAUNCHES += 1
    return out


def unpack_legacy(frame: DeviceLegacyBatch, width: int, height: int) -> torch.Tensor:
    """The launch of a staged frame, the batch of one: its (height, width)
    uint16 plane."""
    return decode_legacy_batch_device(*frame, height=height, width=width)[0]


def decode_legacy(payload: np.ndarray, width: int, height: int, staging: Staging
                  ) -> torch.Tensor:
    """One legacy payload -> (height, width) uint16 on the staging's device:
    the Decoder's single-frame path, :func:`stage_legacy` then
    :func:`unpack_legacy`."""
    return unpack_legacy(stage_legacy(staging, payload, width, height), width, height)


def decode_legacy_batch(payloads, width: int, height: int, staging: Staging) -> torch.Tensor:
    """F legacy payloads of one geometry -> (F, height, width) uint16 on
    the staging's device, in one launch."""
    dev = stage_legacy_batch(staging, payloads, width, height)
    return decode_legacy_batch_device(*dev, height=height, width=width)


def decode_legacy_plain(payload, bits, refs, offsets, *, height: int, width: int
                        ) -> torch.Tensor:
    """:func:`decode_legacy_batch_plain` of one frame's loose tensors (as
    :func:`decode_legacy_device` takes them): its (height, width) plane."""
    return decode_legacy_batch_plain(*batch_of_one(payload, bits, refs, offsets),
                                     height=height, width=width)[0]


def decode_legacy_device(payload, bits, refs, offsets, *, height: int, width: int
                         ) -> torch.Tensor:
    """:func:`decode_legacy_batch_device` of one frame's loose tensors, the
    batch of one: (height, width) uint16.

    payload: (P,) uint8, the frame's payload and its zeroed tail, its whole
    window; bits, refs, offsets: (nblk,) int32 / uint16 / int64 from the
    host scan, nblk = :func:`num_blocks` (width, height)."""
    return decode_legacy_batch_device(*batch_of_one(payload, bits, refs, offsets),
                                      height=height, width=width)[0]
