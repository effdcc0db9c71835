"""Decoder facade on PyTorch: the surface of mcraw.Decoder.

    d = Decoder(path, device="cuda")
    d.frames                       # sorted timestamps
    d.container_metadata           # parsed container JSON
    img, meta = d.load_frame(ts)   # (H, W) uint16 numpy + frame JSON
    img, meta = d.load_frame_device(ts)  # (H, W) torch.uint16 on the device
    imgs, metas = d.decode_batch(timestamps)  # (F, H, W), one launch
    for imgs, metas in d.decode_batch_iter(chunk_frames=16): ...
    fd = d.make_frame_decoder(); img, meta = fd(ts)  # one staging per geometry
    mesh = parallel.Mesh(("cuda:0",) * 4)  # or parallel.default_mesh()
    imgs, metas = d.decode_batch(timestamps, mesh=mesh)  # a frame-Sharded batch
    img, meta = d.load_frame_sharded(ts, mesh)  # one frame in row bands
    d.load_audio() / d.audio_chunks() / d.load_audio_stream()
    d.timer = observe.StageTimer()  # "parse" / "unpack" of single frames

Modern-codec (compressionType 7) frames decode through
:mod:`mcraw_torch.kernels.unpack` (host scans, upload, device prep, the CUDA
modern unpack kernel), legacy-codec (compressionType 6) frames through
:mod:`mcraw_torch.kernels.legacy` (host header-chain scan, upload, the CUDA
legacy unpack kernel); a clip may mix both. A batch of frames of one codec
and one geometry is one launch of its codec's kernel with a frame axis. A
frame or a batch goes up in one H2D from the decoder's
:class:`~mcraw_torch.kernels.staging.Staging`, whose buffers it reuses.
``device="cpu"`` runs the kernels' plain torch versions. The container,
metadata and error model are the port's copies of the JAX package's
NumPy-only modules.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import numpy as np
import torch

from .container import COMPRESSION_TYPE, COMPRESSION_TYPE_LEGACY, ContainerReader
from .errors import DecodeError, IOException, MotionCamException
from .kernels import legacy as L
from .kernels import unpack as U
from .kernels.staging import SHARE_GEOMETRY, Staging
from .metadata import ContainerMetadata, FrameMetadata

AudioChunk = tuple[int, np.ndarray]  # (timestampNs or -1, interleaved int16)


# _modern_payload_rows and _uncompress_error_text are copies of
# mcraw.pipeline's, so that the port imports nothing of mcraw.


def _modern_payload_rows(payload) -> int:
    """Rows the reference's Decode writes: 4*ceil(encodedHeight/4) from the
    payload header (RawData.cpp:507-511, :571). 0 when the payload is too
    short to carry a header."""
    if len(payload) < 8:
        return 0
    enc_h = int(np.asarray(payload[4:8], dtype=np.uint8).view("<u4")[0])
    return 4 * ((enc_h + 3) // 4)


@contextlib.contextmanager
def _uncompress_error_text(modern: bool):
    """Wrap codec-level failures in the reference's exact loadFrame error
    text (Decoder.cpp:225-231 throws IOException("Failed to uncompress
    frame") / ("Failed to uncompress legacy frame") when raw::Decode{,Legacy}
    returns <= 0), so CLI stderr stays byte-identical to the C++ example on
    malformed payloads. The specific diagnosis stays on __cause__."""
    try:
        yield
    except DecodeError as e:
        raise IOException(
            "Failed to uncompress frame"
            if modern
            else "Failed to uncompress legacy frame"
        ) from e


def resolve_device(device: torch.device | str) -> torch.device:
    """`device` as a torch.device; a CUDA device must exist (no fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MotionCamException(
                f"device {str(dev)!r} requested but no CUDA device is "
                "available (torch.cuda.is_available() is false)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


# Per codec (modern?): the host prep of one frame, the batch of one, which
# returns its upload, and the device prep and batch launch of the staged
# frame.
_SINGLE_FRAME = {True: (U.prepare_modern, U.unpack_modern),
                 False: (L.prepare_legacy, L.unpack_legacy)}


class Decoder:
    def __init__(self, source, device: torch.device | str = "cuda"):
        """source: path, raw bytes, or open binary file object.
        device: "cuda" (the default; raises without a card) or "cpu"."""
        self._device = resolve_device(device)
        self._reader = ContainerReader(source)
        self._staging = Staging(self._device)
        self._mesh_stagings: dict[tuple, object] = {}  # parallel.MeshStaging per key
        self._audio_loader: AudioChunkLoader | None = None
        # Optional observe.StageTimer; when set, the single-frame paths
        # attribute their "parse" and "unpack" stages to it (export_clip
        # attaches one).
        self.timer = None

    def _stage(self, name: str):
        if self.timer is None:
            return contextlib.nullcontext()
        return self.timer.stage(name)

    @property
    def device(self) -> torch.device:
        return self._device

    # -- container surface ---------------------------------------------------

    @property
    def frames(self) -> list[int]:
        return self._reader.frames

    def get_frames(self) -> list[int]:
        return self._reader.frames

    @property
    def container_metadata(self) -> dict:
        return self._reader.container_metadata

    def get_container_metadata(self) -> dict:
        return self._reader.container_metadata

    @property
    def typed_metadata(self) -> ContainerMetadata:
        return ContainerMetadata(self._reader.container_metadata)

    def audio_sample_rate_hz(self) -> int:
        return self.typed_metadata.audio_sample_rate

    def num_audio_channels(self) -> int:
        return self.typed_metadata.audio_channels

    def close(self) -> None:
        self._reader.close()

    def __enter__(self) -> "Decoder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- frame decode ----------------------------------------------------------

    def load_frame(self, timestamp: int) -> tuple[np.ndarray, dict]:
        """Decode one frame to host memory: ((H, W) uint16, frame JSON)."""
        img, meta = self.load_frame_device(timestamp)
        return img.cpu().numpy(), meta

    def load_frame_device(self, timestamp: int) -> tuple[torch.Tensor, dict]:
        """Decode one frame; the (H, W) torch.uint16 result stays on the
        decoder's device."""
        return self._decode_frame(timestamp, lambda fm: self._staging)

    def _decode_frame(self, timestamp: int, staging_for) -> tuple[torch.Tensor, dict]:
        """One frame through the Staging `staging_for(FrameMetadata)` gives:
        ((H, W) uint16 on the device, frame JSON).

        Stages, when :attr:`timer` is set: "parse" is the container read,
        the frame JSON, the checks and the host prep into the staging;
        "unpack" is the H2D, the device prep and the launch. Both are host
        clocks: on a card "unpack" ends when the launch is queued, not when
        the kernel has run."""
        with self._stage("parse"):
            payload, meta, fm, modern = self._checked_frame(timestamp)
            prepare, unpack = _SINGLE_FRAME[modern]
            with _uncompress_error_text(modern):
                upload = prepare(staging_for(fm), payload, fm.width, fm.height)
        with self._stage("unpack"), _uncompress_error_text(modern):
            return unpack(upload(), fm.width, fm.height), meta

    def _checked_frame(self, timestamp: int):
        """(payload, frame JSON, FrameMetadata, modern) of one frame, its
        codec and geometry checked as load_frame_device checks them."""
        payload, meta = self._reader.frame_payload(timestamp)
        fm = FrameMetadata(meta)
        ct = fm.compression_type
        if ct not in (COMPRESSION_TYPE, COMPRESSION_TYPE_LEGACY):
            raise IOException("Invalid compression type")
        modern = ct == COMPRESSION_TYPE
        self._reference_return_check(payload, fm, modern)
        return payload, meta, fm, modern

    # -- batched decode ----------------------------------------------------------

    def decode_batch(self, timestamps: list[int] | None = None, mesh=None):
        """Decode frames of one codec and one geometry in one launch of the
        codec's kernel: ((F, H, W) uint16 on the decoder's device, [frame
        JSON, ...]). With a :class:`~mcraw_torch.parallel.Mesh` of n
        entries, the batch is frame data-parallel: shard d decodes frames
        [d*F/n, (d+1)*F/n) in one launch on its device, and the images come
        as a :class:`~mcraw_torch.parallel.Sharded`; F not a multiple of n
        raises ValueError. Mixed codecs raise IOException("mixed codecs in
        one batch"), mixed (width, height) or encoded geometry a
        ValueError, a bad frame what load_frame_device raises for it, and
        no frames an IndexError (as mcraw.Decoder.decode_batch on the CPU).
        The staging buffers keep the size of the largest batch decoded;
        for long clips use :meth:`decode_batch_iter`, which bounds that,
        and the output, to one chunk."""
        if timestamps is None:
            timestamps = self.frames
        if not timestamps:
            raise IndexError("decode_batch needs at least one frame")
        frames = [self._checked_frame(ts) for ts in timestamps]
        if len({modern for *_, modern in frames}) > 1:
            raise IOException("mixed codecs in one batch")
        if len({(fm.width, fm.height) for _, _, fm, _ in frames}) > 1:
            raise ValueError(SHARE_GEOMETRY)
        _, _, fm, modern = frames[0]
        with _uncompress_error_text(modern):
            imgs = self._decode_payloads([p for p, *_ in frames], fm, modern, mesh)
        return imgs, [meta for _, meta, *_ in frames]

    def _decode_payloads(self, payloads, fm: FrameMetadata, modern: bool, mesh):
        """A checked batch of one codec and geometry through
        parallel.decode_frames_batched: on the decoder's staging, or on the
        mesh's stagings kept for (mesh, codec, geometry)."""
        from .parallel import decode_frames_batched

        return decode_frames_batched(payloads, fm.width, fm.height, modern, mesh,
                                     staging=self._staging,
                                     shards=self._mesh_staging(mesh, modern, fm))

    def _mesh_staging(self, mesh, modern: bool, fm: FrameMetadata):
        """The MeshStaging kept for (mesh, codec, geometry); None without a
        mesh."""
        if mesh is None:
            return None
        from .parallel import MeshStaging

        key = (mesh, modern, fm.width, fm.height)
        if key not in self._mesh_stagings:
            self._mesh_stagings[key] = MeshStaging(mesh)
        return self._mesh_stagings[key]

    def load_frame_sharded(self, timestamp: int, mesh) -> tuple:
        """Decode one frame split across the mesh's entries, each decoding
        one band of its rows (parallel.decode_frame_sharded): ((H, W)
        row-:class:`~mcraw_torch.parallel.Sharded` uint16, frame JSON),
        with load_frame_device's codec and geometry checks and errors."""
        from .parallel import decode_frame_sharded

        payload, meta, fm, modern = self._checked_frame(timestamp)
        with _uncompress_error_text(modern):
            img = decode_frame_sharded(payload, fm.width, fm.height, modern, mesh,
                                       shards=self._mesh_staging(mesh, modern, fm))
        return img, meta

    def _homogeneous_runs(self, timestamps: list[int]) -> list[list[int]]:
        """Split a timestamp list at (codec, width, height) boundaries:
        maximal runs in stream order, one launch each (a homogeneous clip
        is one run). Only the frame JSON is parsed here."""
        runs: list[list[int]] = []
        key = None
        for ts in timestamps:
            _, meta = self._reader.frame_payload(ts)
            fm = FrameMetadata(meta)
            k = (fm.compression_type, fm.width, fm.height)
            if k != key:
                runs.append([])
                key = k
            runs[-1].append(ts)
        return runs

    def decode_batch_iter(
        self, timestamps: list[int] | None = None, chunk_frames: int = 16, mesh=None
    ) -> Iterator[tuple]:
        """Constant-memory batched decode: yields ((C, H, W) uint16 on the
        device, [frame JSON, ...]) per homogeneous run of up to
        `chunk_frames` frames, in stream order; a clip that switches codec
        or resolution mid-stream splits into one launch per run. With a
        mesh, chunk_frames rounds up to a multiple of its size and each run
        is a :meth:`decode_batch` on it; a run that does not divide over
        the mesh decodes unsharded on the decoder's own device."""
        if timestamps is None:
            timestamps = self.frames
        if chunk_frames <= 0:
            raise ValueError("chunk_frames must be positive")
        if mesh is not None:
            chunk_frames += (-chunk_frames) % mesh.size
        for lo in range(0, len(timestamps), chunk_frames):
            for run in self._homogeneous_runs(timestamps[lo : lo + chunk_frames]):
                sharded = mesh is not None and len(run) % mesh.size == 0
                yield self.decode_batch(run, mesh=mesh if sharded else None)

    def make_frame_decoder(self) -> "FrameDecoder":
        """Persistent single-frame decode loop (the latency path): see
        :class:`FrameDecoder`."""
        return FrameDecoder(self)

    @staticmethod
    def _reference_return_check(payload, fm: FrameMetadata, modern: bool) -> None:
        """The reference's outcomes for degenerate geometries
        (mcraw.pipeline.Decoder._reference_return_check): for the modern
        codec, zero encoded rows, zero width or zero height fail as "Failed
        to uncompress frame"; for the legacy codec, zero width or zero
        height fail as "Failed to uncompress legacy frame". A short modern
        encodedHeight (0 < rows < height) is not degenerate here: the kernel
        writes the rows that exist into a zeroed output."""
        if fm.width < 0 or fm.height < 0 or fm.width * fm.height > (1 << 31):
            raise DecodeError(f"invalid frame geometry {fm.width}x{fm.height}")
        if modern:
            if _modern_payload_rows(payload) == 0 or fm.width == 0 or fm.height == 0:
                raise IOException("Failed to uncompress frame")
        elif fm.width == 0 or fm.height == 0:
            raise IOException("Failed to uncompress legacy frame")

    # -- audio -----------------------------------------------------------------

    def load_audio(self) -> list[AudioChunk]:
        """Batch load; skips chunks with invalid offsets."""
        out = []
        for i in range(self._reader.num_audio_chunks):
            chunk = self._reader.audio_chunk(i)
            if chunk is not None:
                out.append(chunk)
        return out

    def audio_chunks(self) -> Iterator[AudioChunk]:
        """Streaming loader; stops at the first failed chunk."""
        for i in range(self._reader.num_audio_chunks):
            chunk = self._reader.audio_chunk(i)
            if chunk is None:
                return
            yield chunk

    def load_audio_stream(self) -> "AudioChunkLoader":
        """The persistent streaming loader: one :class:`AudioChunkLoader`
        per Decoder, returned by every call, so iteration state persists
        across calls (Decoder::loadAudio())."""
        if self._audio_loader is None:
            self._audio_loader = AudioChunkLoader(self._reader)
        return self._audio_loader


class AudioChunkLoader:
    """Stateful streaming audio loader. :meth:`next` returns the next
    ``(timestamp_ns, int16 samples)`` chunk, or None past the last chunk or
    on a failed chunk load; a failure does not advance the index, so a
    retry reads the same chunk again."""

    def __init__(self, reader):
        self._reader = reader
        self._idx = 0

    def next(self) -> AudioChunk | None:
        if self._idx >= self._reader.num_audio_chunks:
            return None
        chunk = self._reader.audio_chunk(self._idx)
        if chunk is None:
            return None
        self._idx += 1
        return chunk

    def __iter__(self) -> Iterator[AudioChunk]:
        while (chunk := self.next()) is not None:
            yield chunk


class FrameDecoder:
    """Persistent single-frame decode loop (the latency path), from
    :meth:`Decoder.make_frame_decoder`. Call with a timestamp; returns
    ((H, W) uint16 on the decoder's device, frame JSON), a fresh output
    tensor each call.

    One program per (codec, width, height) key, kept for the object's
    lifetime: a :class:`~mcraw_torch.kernels.staging.Staging` whose host and
    device input buffers grow to the key's largest frame. Each call is
    :meth:`Decoder.load_frame_device`'s path through the key's buffers: the
    host prep, one H2D, the device prep and one launch of the codec's
    kernel, its stages attributed to the decoder's :attr:`Decoder.timer`.
    A homogeneous clip has one key."""

    def __init__(self, decoder: Decoder):
        self._d = decoder
        self._programs: dict[tuple, Staging] = {}

    @property
    def num_programs(self) -> int:
        return len(self._programs)

    def __call__(self, timestamp: int) -> tuple[torch.Tensor, dict]:
        return self._d._decode_frame(timestamp, self._staging)

    def _staging(self, fm: FrameMetadata) -> Staging:
        key = (fm.compression_type, fm.width, fm.height)
        if key not in self._programs:
            self._programs[key] = Staging(self._d.device)
        return self._programs[key]
