"""The upload of a frame's or a batch's inputs, shared by both codecs.

The host prep of either codec lays its arrays out in a :class:`Staging`
(one host buffer, 16-byte aligned slots), fills them in place — each
payload straight into its slot, the legacy scans straight into their rows
— and sends them to the device in one H2D. A single frame is a batch of
one. The buffers are kept and grown to the largest call, so a decoder that
keeps its Staging touches no new host memory after its first frames.

The layout of a batch's payloads (:func:`slot_bytes`, :func:`slot_layout`)
and the checks of a batched launch (:func:`check_batch_inputs`,
:func:`frame_spans`) are the same for both codecs and live here too.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import observe

# gridDim.y of the batched launches: one frame a row of blocks.
MAX_BATCH_FRAMES = 65535

SHARE_GEOMETRY = "all frames in a batch must share geometry"


def slot_bytes(n: int, tail: int) -> int:
    """Bytes of a payload of n bytes in the upload buffer: the payload, a
    zeroed tail of `tail` bytes, rounded up to 16 so that the next slot
    starts 16-byte aligned."""
    size = n + tail
    return size + (-size) % 16


def slot_layout(sizes) -> tuple[np.ndarray, int]:
    """(F,) int64 start of each slot of `sizes` bytes (each a multiple of
    16) in one buffer, and the buffer's size."""
    sizes = np.asarray(sizes, dtype=np.int64)
    starts = np.cumsum(sizes) - sizes
    return starts, int(sizes.sum())


class Staging:
    """A host buffer and a buffer on `device`, both grown to the largest
    call and reused. :meth:`host` lays arrays out in the host one and
    returns them for the caller to fill; :meth:`upload` sends what it laid
    out in one H2D and returns the same arrays on the device. A later
    :meth:`host` call overwrites them: a kernel that reads them runs on the
    stream the next upload is ordered behind."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self._host = torch.empty(0, dtype=torch.uint8)
        self._dev = torch.empty(0, dtype=torch.uint8, device=self.device)
        self._parts: list[tuple[int, np.ndarray]] = []
        self._used = 0

    def host(self, *parts) -> list[np.ndarray]:
        """parts: (shape, numpy dtype) of each array. Their host arrays,
        each 16-byte aligned, uninitialised."""
        sizes = [int(np.prod(shape)) * np.dtype(dtype).itemsize for shape, dtype in parts]
        starts, total = slot_layout([s + (-s) % 16 for s in sizes])
        if self._host.numel() < total:
            self._host = torch.empty(total, dtype=torch.uint8)
            self._dev = torch.empty(total, dtype=torch.uint8, device=self.device)
        buf = self._host.numpy()
        arrays = [buf[lo : lo + n].view(dtype).reshape(shape)
                  for (shape, dtype), lo, n in zip(parts, starts.tolist(), sizes)]
        self._parts = list(zip(starts.tolist(), arrays))
        self._used = total
        return arrays

    def upload(self, source: "Staging | None" = None) -> list[torch.Tensor]:
        """One H2D of the arrays of the last :meth:`host` call; each on the
        device, with its shape and dtype. With `source`, the arrays that
        `source` laid out go into this staging's device buffer: one host
        prep sent to several devices (a frame replicated over a mesh). The
        copy is the span ``stage.h2d``; its bytes count as ``h2d_bytes``."""
        src = self if source is None else source
        with observe.span("stage.h2d"):
            if self._dev.numel() < src._used:
                self._dev = torch.empty(src._used, dtype=torch.uint8, device=self.device)
            self._dev[: src._used].copy_(src._host[: src._used])
        observe.count("h2d_bytes", src._used)
        return [self._dev[lo : lo + a.nbytes].view(torch.from_numpy(a.reshape(-1)[:0]).dtype)
                .view(a.shape) for lo, a in src._parts]


def check_batch_inputs(data, bases, lengths, tensors, nblk: int) -> int:
    """Check a batch's inputs: `data` 1-D, `bases` and `lengths` (F,)
    int64, each of `tensors` ((name, tensor, dtype) triples) a contiguous
    (F, nblk) tensor, all on data's device; F, at most MAX_BATCH_FRAMES."""
    if data.dim() != 1 or not data.is_contiguous():
        raise ValueError(f"the payload buffer must be a contiguous 1-D tensor, got "
                         f"{tuple(data.shape)}")
    frames = bases.shape[0] if bases.dim() == 1 else -1
    for name, t, dtype, shape in (
        ("bases", bases, torch.int64, (frames,)),
        ("lengths", lengths, torch.int64, (frames,)),
        *((name, t, dtype, (frames, nblk)) for name, t, dtype in tensors),
    ):
        if t.dtype != dtype or t.dim() != len(shape) or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {dtype} tensor of shape {shape}, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
        if t.device != data.device:
            raise ValueError(f"{name} is on {t.device}, the payload on {data.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, need {shape}")
    if frames > MAX_BATCH_FRAMES:
        raise ValueError(f"{frames} frames in one launch; at most {MAX_BATCH_FRAMES}")
    return frames


def frame_spans(bases: torch.Tensor, lengths: torch.Tensor, total: int):
    """Each frame's [lo, hi) of the payload buffer: its base and length
    clamped to the buffer, as the kernels clamp them."""
    spans = []
    for base, n in zip(bases.tolist(), lengths.tolist()):
        lo = min(max(base, 0), total)
        spans.append((lo, lo + min(max(n, 0), total - lo)))
    return spans


def batch_of_one(data: torch.Tensor, *rows: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """One frame's loose tensors as the batch of one: `data`, its (1,)
    int64 base 0 and length (its whole size), made on data's device with no
    host sync, and each of `rows` as a (1, nblk) row."""
    bases = torch.zeros(1, dtype=torch.int64, device=data.device)
    lengths = torch.full((1,), data.numel(), dtype=torch.int64, device=data.device)
    return (data, bases, lengths, *(t.unsqueeze(0) for t in rows))
