"""Modern-codec (compressionType 7) decode: host prep, device prep, unpack.

A batch of F frames of one geometry, as in the JAX package's device path
(``pallas_unpack.prepare_modern_light`` + ``decode_modern_device_v6``); a
single frame is the batch of one, at every step down to the launch:

1. :func:`prepare_modern_batch` (host): read and validate each payload's
   16-byte header, run the two serial metadata-stream scans (C++ via
   :mod:`mcraw_torch.kernels.native`), lay each payload in its 16-byte
   aligned slot and the streams in their rows of a
   :class:`~mcraw_torch.kernels.staging.Staging`;
   :func:`stage_modern_batch` adds the one H2D that sends them.
2. :func:`block_offsets` (device): clamp each block's bit width to 16, map
   it to a byte length, and take ``16 + exclusive prefix sum`` in int64
   along each frame's row: the hand-written CUDA scan of
   :mod:`mcraw_torch.kernels.offsets` (``csrc/block_offsets.cu``).
3. :func:`decode_modern_batch_device`: one launch of the hand-written CUDA
   kernel (``csrc/unpack_modern.cu``) with a frame axis; it unpacks every
   block, adds its reference and writes Bayer-de-interleaved rows of each
   frame's (height, width) uint16 plane.

For one frame, :func:`prepare_modern` and :func:`stage_modern` give the
staged batch of one, :func:`unpack_modern` takes steps 2 and 3 of it and
returns its plane, and :func:`decode_modern_frame` is all three: the
Decoder's single-frame path.

:func:`decode_modern_batch_plain` is the same function in plain torch. The
wrapper takes it only for tensors on the CPU; a CUDA tensor goes to the
kernel or the call raises. :func:`decode_modern_device` and
:func:`decode_modern_plain` are the two on one frame's loose tensors.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import observe
from ..errors import DecodeError
from . import build
from . import numpy_ref as R
from . import offsets as O
from . import tables as T
from .native import decode_metadata_stream
from .staging import (SHARE_GEOMETRY, Staging, batch_of_one, check_batch_inputs, frame_spans,
                      slot_bytes, slot_layout)
from .tables import ModernTables, modern_tables

# Zeroed bytes after the payload: one maximal block, so no word load of the
# last block can leave the allocation, and the buffer reads as int32 words.
TAIL_BYTES = T.MODERN_MAX_LENGTH

# Launch counters: the kernel's launches and the plain version's calls.
KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0

# csrc/unpack_modern.cu kRunTiles: the consecutive tiles of a run, the
# unit a block of the kernel stages and unpacks.
RUN_TILES = 32


class ModernScan(NamedTuple):
    """The header checks' and metadata scans' result for one payload."""

    n: int  # payload bytes
    bits: np.ndarray  # (nblk,) uint16
    refs: np.ndarray  # (nblk,) uint16
    tiles_y: int
    tiles_x: int


def scan_modern(payload: np.ndarray, width: int, height: int) -> ModernScan:
    """Header checks + the two serial metadata scans (host side).

    Raises :class:`DecodeError` with the texts of the JAX package's
    ``prepare_modern_light``."""
    n = len(payload)
    enc_w, enc_h, bits_off, refs_off = R.read_metadata_header(payload)
    if bits_off > n or refs_off > n:
        raise DecodeError("metadata offsets out of bounds")
    if enc_w % T.MODERN_BLOCK != 0:
        raise DecodeError("encoded width not a multiple of 64")
    if enc_w < width:
        raise DecodeError("encoded width smaller than width")

    bits, _ = decode_metadata_stream(payload, bits_off)
    refs, _ = decode_metadata_stream(payload, refs_off)
    ty, tx, nblk = R.modern_block_geometry(enc_w, enc_h)
    if len(bits) < nblk or len(refs) < nblk:
        raise DecodeError("metadata streams shorter than block count")
    bits, refs = bits[:nblk], refs[:nblk]
    # mode="clip" is the codec's bits <= 16 clamp.
    total = int(T.MODERN_BLOCK_LENGTH.take(bits, mode="clip").sum(dtype=np.int64))
    if 16 + total > n:
        raise DecodeError("main data truncated")
    return ModernScan(n, bits, refs, ty, tx)


class DeviceBatch(NamedTuple):
    """A batch's inputs on the device, ready for the unpack."""

    words: torch.Tensor  # (P,) int32: every frame's slot, one after another
    bases: torch.Tensor  # (F,) int64 first word of each frame's slot
    lengths: torch.Tensor  # (F,) int64 words of each slot
    bits: torch.Tensor  # (F, nblk) uint16
    refs: torch.Tensor  # (F, nblk) uint16
    tiles_y: int
    tiles_x: int


def stage_modern_batch(staging: Staging, payloads, width: int, height: int) -> DeviceBatch:
    """:func:`prepare_modern_batch`, then the batch's inputs sent in one
    H2D."""
    tiles = prepare_modern_batch(staging, payloads, width, height)
    return DeviceBatch(*staging.upload(), *tiles)


def prepare_modern_batch(staging: Staging, payloads, width: int, height: int
                         ) -> tuple[int, int]:
    """The host prep of a batch: :func:`scan_modern` of each payload, then
    the batch's inputs laid out in `staging` (each payload straight into its
    16-byte aligned slot, followed by a zeroed tail of TAIL_BYTES), not yet
    sent; the (tiles_y, tiles_x) they share. Frames whose encoded geometry
    differs raise ValueError. The scans are the span ``stage.scan``, the
    layout ``stage.layout``."""
    payloads = [np.asarray(p, dtype=np.uint8) for p in payloads]
    if not payloads:
        raise ValueError("a batch needs at least one frame")
    scans = []
    with observe.span("stage.scan"):
        for p in payloads:
            scan = scan_modern(p, width, height)
            if scans and scan[3:] != scans[0][3:]:
                raise ValueError(SHARE_GEOMETRY)
            scans.append(scan)
    with observe.span("stage.layout"):
        sizes = [slot_bytes(sc.n, TAIL_BYTES) for sc in scans]
        starts, total = slot_layout(sizes)
        frames, nblk = len(scans), scans[0].bits.size
        words, bases, lengths, bits, refs = staging.host(
            ((total // 4,), np.int32), ((frames,), np.int64), ((frames,), np.int64),
            ((frames, nblk), np.uint16), ((frames, nblk), np.uint16))
        buf = words.view(np.uint8)
        for f, (p, sc, lo, size) in enumerate(zip(payloads, scans, starts.tolist(), sizes)):
            buf[lo : lo + sc.n] = p
            buf[lo + sc.n : lo + size] = 0
            bits[f], refs[f] = sc.bits, sc.refs
        bases[:], lengths[:] = starts // 4, np.asarray(sizes) // 4
    return scans[0].tiles_y, scans[0].tiles_x


def prepare_modern(staging: Staging, payload, width: int, height: int
                   ) -> Callable[[], DeviceBatch]:
    """The host prep of one frame, the batch of one of
    :func:`prepare_modern_batch`; returns its upload: a call that sends the
    inputs in one H2D and gives them on the device."""
    tiles = prepare_modern_batch(staging, [payload], width, height)
    return lambda: DeviceBatch(*staging.upload(), *tiles)


def stage_modern(staging: Staging, payload, width: int, height: int) -> DeviceBatch:
    """One frame's inputs on the device, the batch of one:
    :func:`prepare_modern`, then its upload."""
    return prepare_modern(staging, payload, width, height)()


def _unpack(batch: DeviceBatch, width: int, height: int) -> torch.Tensor:
    offsets = block_offsets(batch.bits, modern_tables(batch.words.device))
    return decode_modern_batch_device(
        batch.words, batch.bases, batch.lengths, batch.bits, batch.refs, offsets,
        ty=batch.tiles_y, tx=batch.tiles_x, height=height, width=width,
    )


def unpack_modern(frame: DeviceBatch, width: int, height: int) -> torch.Tensor:
    """The device prep and the launch of a staged frame, the batch of one:
    its (height, width) uint16 plane."""
    return _unpack(frame, width, height)[0]


def decode_modern_frame(payload, width: int, height: int, staging: Staging) -> torch.Tensor:
    """One modern payload -> (height, width) uint16 on the staging's device:
    the Decoder's single-frame path, :func:`stage_modern` then
    :func:`unpack_modern`."""
    return unpack_modern(stage_modern(staging, payload, width, height), width, height)


def decode_modern_batch(payloads, width: int, height: int, staging: Staging) -> torch.Tensor:
    """F modern payloads of one geometry -> (F, height, width) uint16 on
    the staging's device, in one launch."""
    return _unpack(stage_modern_batch(staging, payloads, width, height), width, height)


def block_offsets(bits: torch.Tensor, tables: ModernTables) -> torch.Tensor:
    """(..., nblk) int64 payload byte offset of every main-data block: 16 +
    the exclusive prefix sum of the clamped bits' block lengths, along the
    last axis (one frame's blocks, or each row of a batch's (F, nblk)):
    :func:`~mcraw_torch.kernels.offsets.block_offsets_device`, one kernel
    launch on a card, the plain version (with `tables`) on the CPU."""
    return O.block_offsets_device(bits, tables)


class UnpackLaunch(NamedTuple):
    """What the wrapper tells the kernel, from the frame's geometry."""

    rows: int  # rows written: min(height, 4 * ty); the rest stay zero
    tiles: int  # tiles that hold those rows: ceil(rows / 4) * tx


def unpack_launch(ty: int, tx: int, height: int, width: int) -> UnpackLaunch:
    """The kernel's launch arguments for a (height, width) crop of a frame
    of ty x tx tiles."""
    rows = min(height, 4 * ty)
    return UnpackLaunch(rows, -(-rows // 4) * tx if rows > 0 and width > 0 else 0)


class ModernGrid(NamedTuple):
    """A launch's persistent grid (csrc/unpack_modern.cu)."""

    runs: int  # frames x the runs of RUN_TILES tiles a frame
    grid: int  # blocks: min(runs, the blocks the card holds at once)
    ahead: int  # runs whose loads a block issues while it is on an earlier run


def modern_grid(frames: int, tiles: int, resident: int) -> ModernGrid:
    """The grid of a launch of `frames` frames of `tiles` tiles on a card
    that holds `resident` blocks of the kernel at once: one block a run
    where every run fits, else each block walks runs ``grid`` apart and
    loads each run after its first while it unpacks the one before."""
    if resident < 1:
        raise ValueError(f"the card holds no block of the unpack kernel ({resident})")
    runs = frames * -(-tiles // RUN_TILES)
    grid = min(runs, resident)
    return ModernGrid(runs, grid, runs - grid)


# Device index -> mcraw_unpack_modern_resident there, once a process.
_RESIDENT: dict[int, int] = {}


def _resident(device: torch.device) -> int:
    """The blocks of the kernel `device` holds at once; call it with
    `device` current."""
    index = torch.cuda.current_device() if device.index is None else device.index
    n = _RESIDENT.get(index)
    if n is None:
        n = build.lib().mcraw_unpack_modern_resident()
        build.check(max(-n, 0), "mcraw_unpack_modern_resident")
        _RESIDENT[index] = n
    return n


def _output(height: int, width: int, ty: int, device, frames: int):
    # Rows past 4*ty (a short encodedHeight) are never written: zero them.
    alloc = torch.zeros if height > 4 * ty else torch.empty
    return alloc((frames, height, width), dtype=torch.uint16, device=device)


def _plain_into(out, words, bits, refs, offsets, *, ty: int, tx: int) -> None:
    """The plain unpack of one frame into its (height, width) plane `out`,
    whose rows past 4*ty are already zero."""
    height, width = out.shape
    rows = min(height, 4 * ty)
    if rows == 0 or width == 0:
        return
    tab = modern_tables(words.device)
    n = words.numel()
    cls = tab.class_index[bits.to(torch.int64).clamp_(max=16)]  # (nblk,)
    wi = (offsets >> 2)[:, None, None] + tab.widx[cls]  # (nblk, 64, 3)
    inside = (wi >= 0) & (wi < n)
    w = words.to(torch.int64) if n else words.new_zeros(1, dtype=torch.int64)
    w = torch.where(inside, w[wi.clamp(0, max(n - 1, 0))] & 0xFFFFFFFF, 0)
    nb = tab.nbits[cls]
    f = ((w >> tab.rsh[cls]) & ((1 << nb) - 1)) << tab.lsh[cls]
    v = f[..., 0] | f[..., 1] | f[..., 2]  # disjoint fields
    v = (v + refs.to(torch.int64)[:, None]) & 0xFFFF  # (nblk, 64)
    img = v.reshape(ty, tx, 2, 2, 2, 32).permute(0, 4, 2, 1, 5, 3)
    img = img.reshape(4 * ty, 64 * tx)  # (ty, h, q, tx, k, c)
    out[:rows] = img[:rows, :width].to(torch.uint16)


def _check_modern_batch(words, bases, lengths, bits, refs, offsets, ty, tx) -> int:
    if words.dtype != torch.int32:
        raise ValueError(f"words must be int32, got {words.dtype}")
    return check_batch_inputs(words, bases, lengths, (
        ("bits", bits, torch.uint16), ("refs", refs, torch.uint16),
        ("offsets", offsets, torch.int64)), 4 * ty * tx)


def decode_modern_batch_plain(
    words: torch.Tensor,
    bases: torch.Tensor,
    lengths: torch.Tensor,
    bits: torch.Tensor,
    refs: torch.Tensor,
    offsets: torch.Tensor,
    *,
    ty: int,
    tx: int,
    height: int,
    width: int,
) -> torch.Tensor:
    """Plain torch version of the unpack kernel (any device): frame f is
    the semantics of ``numpy_ref.unpack_blocks`` + ``modern_deinterleave``
    and the crop on words[bases[f] : bases[f] + lengths[f]] (clamped to the
    buffer) and row f of bits, refs and offsets, rows past 4*ty zero;
    stacked into (F, height, width). Computes in int64, since CPU uint16
    tensors support neither ``>>`` nor ``+``, and casts at the end (int ->
    uint16 wraps mod 2^16)."""
    global PLAIN_CALLS
    with build.COUNTER_LOCK:
        PLAIN_CALLS += 1
    frames = _check_modern_batch(words, bases, lengths, bits, refs, offsets, ty, tx)
    out = _output(height, width, ty, words.device, frames)
    for f, (lo, hi) in enumerate(frame_spans(bases, lengths, words.numel())):
        _plain_into(out[f], words[lo:hi], bits[f], refs[f], offsets[f], ty=ty, tx=tx)
    return out


@observe.spanned("unpack.modern")
def decode_modern_batch_device(
    words: torch.Tensor,
    bases: torch.Tensor,
    lengths: torch.Tensor,
    bits: torch.Tensor,
    refs: torch.Tensor,
    offsets: torch.Tensor,
    *,
    ty: int,
    tx: int,
    height: int,
    width: int,
) -> torch.Tensor:
    """Unpack + de-interleave + crop F frames of one geometry in one
    launch: (F, height, width) uint16, frame f computed from its own inputs
    alone (a single frame is the batch of one).

    words: (P,) int32, every frame's payload slot; bases, lengths: (F,)
    int64 words, frame f's slot; bits, refs: (F, 4*ty*tx) uint16; offsets:
    (F, 4*ty*tx) int64 frame-local, from :func:`block_offsets`. CUDA tensors
    launch the kernel once on the current stream, its grid from
    :func:`modern_grid` (counters ``unpack.modern.runs`` and
    ``unpack.modern.runs_ahead``: the share of runs whose loads overlapped
    an earlier run's unpack); CPU tensors take
    :func:`decode_modern_batch_plain`; any other device raises."""
    global KERNEL_LAUNCHES
    if words.device.type == "cpu":
        return decode_modern_batch_plain(
            words, bases, lengths, bits, refs, offsets,
            ty=ty, tx=tx, height=height, width=width,
        )
    if words.device.type != "cuda":
        raise ValueError(f"no unpack kernel for device {words.device}")
    frames = _check_modern_batch(words, bases, lengths, bits, refs, offsets, ty, tx)
    if width > 64 * tx:
        raise ValueError(f"width {width} exceeds the encoded width {64 * tx}")
    tab = modern_tables(words.device)
    out = _output(height, width, ty, words.device, frames)
    launch = unpack_launch(ty, tx, height, width)
    if launch.tiles == 0 or frames == 0:
        return out
    with torch.cuda.device(words.device):
        grid = modern_grid(frames, launch.tiles, _resident(words.device))
        stream = torch.cuda.current_stream().cuda_stream
        build.launch(
            "mcraw_unpack_modern_batch",
            (words, bits, refs, offsets, tab.quads, tab.class_index, out, bases, lengths),
            words.data_ptr(), words.numel(), bases.data_ptr(), lengths.data_ptr(),
            frames, 4 * ty * tx, bits.data_ptr(), refs.data_ptr(), offsets.data_ptr(),
            tab.quads.data_ptr(), tab.class_index.data_ptr(), out.data_ptr(),
            height * width, tx, launch.tiles, launch.rows, width, grid.grid, stream,
        )
    observe.count("unpack.modern.runs", grid.runs)
    observe.count("unpack.modern.runs_ahead", grid.ahead)
    with build.COUNTER_LOCK:
        KERNEL_LAUNCHES += 1
    return out


def decode_modern_plain(words, bits, refs, offsets, *, ty: int, tx: int, height: int,
                        width: int) -> torch.Tensor:
    """:func:`decode_modern_batch_plain` of one frame's loose tensors (as
    :func:`decode_modern_device` takes them): its (height, width) plane."""
    return decode_modern_batch_plain(*batch_of_one(words, bits, refs, offsets), ty=ty, tx=tx,
                                     height=height, width=width)[0]


def decode_modern_device(words, bits, refs, offsets, *, ty: int, tx: int, height: int,
                         width: int) -> torch.Tensor:
    """:func:`decode_modern_batch_device` of one frame's loose tensors, the
    batch of one: (height, width) uint16.

    words: (P,) int32 payload words (payload + zeroed tail), the frame's
    whole window; bits, refs: (4*ty*tx,) uint16 raw metadata streams;
    offsets: (4*ty*tx,) int64 from :func:`block_offsets`."""
    return decode_modern_batch_device(*batch_of_one(words, bits, refs, offsets), ty=ty,
                                      tx=tx, height=height, width=width)[0]
