"""Multi-device decode: frame data-parallel batches, one frame split into
row bands, and multi-clip decode.

The port of :mod:`mcraw.parallel`. Frames are independent (the container's
index gives every frame's payload), so a batch shards along its frame
axis: shard d of an n-entry :class:`Mesh` takes the contiguous frames
``[d*F/n, (d+1)*F/n)``, lays them out in its own Staging on its own device
and makes one batched launch of the codec's kernel. One frame splits into
n bands of output rows: its payload and block metadata are replicated on
every device, and each band is one launch of the codec's kernel on the
batch of one over a slice of the metadata, since both codecs lay their
blocks out in stream order.

What the JAX package needs to do this on a TPU has no counterpart here:
payloads padded into (F, rows, 128) slabs, base rows rebased per shard,
``shard_map`` and its jitted programs cached per geometry. The port's
Staging and batched launches already take F frames of any payload length.

A mesh is a tuple of devices, and an entry may repeat: ``("cpu",) * 8``
stands where the JAX package's tests put 8 virtual CPU devices, and
``(cuda:0,) * 4`` runs four shards on one card. Each entry has its own
Staging (two shards that shared one would overwrite each other's bytes)
and, on a card, its own stream; the caller's current stream waits for
every shard's before a result is returned.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .kernels import legacy as L
from .kernels import unpack as U
from .kernels.staging import SHARE_GEOMETRY, Staging
from .kernels.tables import modern_tables
from .pipeline import _uncompress_error_text, resolve_device


@dataclass(frozen=True)
class Mesh:
    """Devices along one axis: the counterpart of a 1-D
    ``jax.sharding.Mesh``. Each entry goes through
    :func:`~mcraw_torch.pipeline.resolve_device`, so a cuda entry with no
    card raises."""

    devices: tuple[torch.device, ...]
    axis: str = "frames"

    def __post_init__(self):
        devices = tuple(resolve_device(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devices)

    @property
    def size(self) -> int:
        return len(self.devices)


def default_mesh(axis: str = "frames") -> Mesh:
    """Every visible card, ``cuda:0 ... cuda:{n-1}``; raises without one."""
    resolve_device("cuda")
    return Mesh(tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count())), axis)


@dataclass(frozen=True)
class Sharded:
    """An array split along axis 0 over a mesh's entries: the counterpart of
    a sharded ``jax.Array``. ``shards[d]`` lies on ``devices[d]``, in
    order; ``shape`` is the whole array's."""

    shards: tuple[torch.Tensor, ...]
    devices: tuple[torch.device, ...]
    shape: tuple[int, ...]

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def cpu(self) -> torch.Tensor:
        """The whole array on the host."""
        return torch.cat([s.cpu() for s in self.shards])

    def numpy(self) -> np.ndarray:
        return self.cpu().numpy()

    def to(self, device: torch.device | str) -> torch.Tensor:
        """The whole array gathered on `device`."""
        device = resolve_device(device)
        return torch.cat([s.to(device) for s in self.shards])


class MeshStaging:
    """One Staging and, on a card, one stream for each entry of `mesh`, kept
    across calls: a new Staging a call touches new host memory each time.
    A Decoder keeps one per (mesh, codec, geometry)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.stagings = [Staging(dev) for dev in mesh.devices]
        self._streams = [torch.cuda.Stream(dev) if dev.type == "cuda" else None
                         for dev in mesh.devices]

    def run(self, fn: Callable[[int, Staging], torch.Tensor]) -> tuple[torch.Tensor, ...]:
        """fn(d, staging) for each entry d, on its stream (ordered after the
        caller's current stream); then the caller's current stream waits for
        each shard's, and each result is recorded as used on it."""
        outs = []
        for d, (staging, stream) in enumerate(zip(self.stagings, self._streams)):
            if stream is None:
                outs.append(fn(d, staging))
                continue
            stream.wait_stream(torch.cuda.current_stream(stream.device))
            with torch.cuda.stream(stream):
                outs.append(fn(d, staging))
        for out, stream in zip(outs, self._streams):
            if stream is not None:
                current = torch.cuda.current_stream(stream.device)
                current.wait_stream(stream)
                out.record_stream(current)
        return tuple(outs)


def _mesh_staging(mesh: Mesh, shards: MeshStaging | None) -> MeshStaging:
    if shards is None:
        return MeshStaging(mesh)
    if shards.mesh != mesh:
        raise ValueError("the MeshStaging belongs to another mesh")
    return shards


def decode_frames_batched(payloads, width: int, height: int, modern: bool,
                          mesh: Mesh | None = None, *, staging: Staging | None = None,
                          shards: MeshStaging | None = None):
    """F payloads of one codec and geometry -> (F, height, width) uint16.

    The counterpart of ``mcraw.parallel.decode_frames_batched``,
    ``decode_frames_pallas_mesh``, ``decode_frames_legacy_mesh``,
    ``decode_frames_v6_mesh`` and ``decode_frames_legacy_v6_mesh``. With
    ``mesh=None``, one launch of the codec's batched kernel through
    `staging` (a new one on the card when None): a tensor on its device.
    With a mesh, shard d takes frames ``[d*F/n, (d+1)*F/n)`` into its own
    Staging of `shards` (a new :class:`MeshStaging` when None) and makes
    one batched launch on its device: a :class:`Sharded` (F, height,
    width). F not a multiple of the mesh size raises ValueError."""
    decode = U.decode_modern_batch if modern else L.decode_legacy_batch
    if mesh is None:
        return decode(payloads, width, height, staging or Staging(resolve_device("cuda")))
    f, n = len(payloads), mesh.size
    if f % n != 0:
        raise ValueError(f"batch of {f} not divisible by {n} devices")
    per = f // n
    outs = _mesh_staging(mesh, shards).run(
        lambda d, st: decode(payloads[d * per : (d + 1) * per], width, height, st))
    return Sharded(outs, mesh.devices, (f, height, width))


def band_rows(rows: int, n: int) -> list[tuple[int, int]]:
    """n contiguous bands [lo, hi) of `rows` rows, in order, each non-empty
    (n <= rows)."""
    return [(d * rows // n, (d + 1) * rows // n) for d in range(n)]


def modern_band(words, bases, lengths, bits, refs, offsets, lo: int, hi: int, *, ty: int,
                tx: int, height: int, width: int) -> torch.Tensor:
    """Rows ``[4*lo, min(4*hi, height))`` of a modern frame of ty encoded
    tile rows, staged as the batch of one: its tile rows [lo, hi), one
    launch of the batch kernel on their slice of the frame's (1, nblk)
    blocks (bits, refs and the absolute offsets of
    :func:`~mcraw_torch.kernels.unpack.block_offsets` of the whole frame)
    against the frame's whole payload; rows past the encoded ones are
    zeros."""
    t = max(min(hi, ty) - lo, 0)  # encoded tile rows in the band
    b0, b1 = 4 * lo * tx, 4 * (lo + t) * tx
    return U.decode_modern_batch_device(
        words, bases, lengths, bits[:, b0:b1], refs[:, b0:b1], offsets[:, b0:b1], ty=t, tx=tx,
        height=min(4 * hi, height) - 4 * lo, width=width)[0]


def legacy_band(payload, bases, lengths, bits, refs, offsets, lo: int, hi: int, *,
                width: int) -> torch.Tensor:
    """Rows [lo, hi) of a legacy frame staged as the batch of one: one
    launch of the batch kernel on their slice of the frame's (1, nblk)
    blocks against the frame's whole payload."""
    per_row = L.num_blocks(width, 1)
    b0, b1 = lo * per_row, hi * per_row
    return L.decode_legacy_batch_device(payload, bases, lengths, bits[:, b0:b1],
                                        refs[:, b0:b1], offsets[:, b0:b1], height=hi - lo,
                                        width=width)[0]


def decode_frame_sharded(payload, width: int, height: int, modern: bool, mesh: Mesh, *,
                         shards: MeshStaging | None = None) -> Sharded:
    """One frame split over the mesh: the counterpart of
    ``mcraw.parallel.decode_frame_sharded`` and
    ``decode_frame_sharded_legacy``. Returns the (height, width) uint16
    frame as a row-:class:`Sharded`: device d decodes band d of the output
    rows (whole tile rows for the modern codec, image rows for the legacy
    one; :func:`modern_band`, :func:`legacy_band`) against the payload,
    which the host prepares once and every device receives. A modern band
    past the encoded rows (a short encodedHeight) is zeros, as in
    ``load_frame``. More devices than the frame has tile rows (modern) or
    rows (legacy) raise ValueError."""
    n = mesh.size
    rows = -(-height // 4) if modern else height
    if n > rows:
        unit = "tile rows" if modern else "rows"
        raise ValueError(f"a frame of {rows} {unit} cannot be split over {n} devices")
    shards = _mesh_staging(mesh, shards)
    first = shards.stagings[0]
    if modern:
        ty, tx = U.prepare_modern_batch(first, [payload], width, height)
    else:
        L.prepare_legacy_batch(first, [payload], width, height)
    bands = band_rows(rows, n)

    def band(d: int, staging: Staging) -> torch.Tensor:
        if modern:
            words, bases, lengths, bits, refs = staging.upload(first)
            offsets = U.block_offsets(bits, modern_tables(staging.device))
            return modern_band(words, bases, lengths, bits, refs, offsets, *bands[d], ty=ty,
                               tx=tx, height=height, width=width)
        return legacy_band(*staging.upload(first), *bands[d], width=width)

    return Sharded(shards.run(band), mesh.devices, (height, width))


def decode_clips(decoders: list, mesh: Mesh | None = None, frames_per_clip: int | None = None):
    """Several clips of one codec and geometry in one batch: the
    counterpart of ``mcraw.parallel.decode_clips``. Frames are interleaved
    round-robin (batch index ``frame * C + clip``), so each shard of a mesh
    takes a mix of clips. Returns ((C, F, H, W) uint16, metas [C][F]): on
    the first decoder's device, or with a mesh gathered on the mesh's first
    device. Unequal frame counts or mixed codecs raise ValueError, as in
    the JAX package; so do mixed geometries."""
    clips = []
    for dec in decoders:
        ts = dec.frames if frames_per_clip is None else dec.frames[:frames_per_clip]
        clips.append([dec._checked_frame(t) for t in ts])
    if len({len(c) for c in clips}) != 1:
        raise ValueError("clips must contribute equal frame counts")
    if len({modern for c in clips for *_, modern in c}) != 1:
        raise ValueError("mixed codecs across clips")
    if len({(fm.width, fm.height) for c in clips for _, _, fm, _ in c}) != 1:
        raise ValueError(SHARE_GEOMETRY)
    c, f = len(clips), len(clips[0])
    flat = [clips[ci][fi] for fi in range(f) for ci in range(c)]
    _, _, fm, modern = flat[0]
    with _uncompress_error_text(modern):
        imgs = decoders[0]._decode_payloads([p for p, *_ in flat], fm, modern, mesh)
    if mesh is not None:
        imgs = imgs.to(mesh.devices[0])
    # (F * C, H, W) -> (C, F, H, W); a stack, not a strided copy of uint16.
    out = torch.stack([imgs[fi * c + ci] for ci in range(c) for fi in range(f)])
    return out.reshape(c, f, fm.height, fm.width), [[meta for _, meta, *_ in cl] for cl in clips]
