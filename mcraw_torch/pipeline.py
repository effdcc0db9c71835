"""Decoder facade on PyTorch: the single-frame surface of mcraw.Decoder.

    d = Decoder(path, device="cuda")
    d.frames                       # sorted timestamps
    d.container_metadata           # parsed container JSON
    img, meta = d.load_frame(ts)   # (H, W) uint16 numpy + frame JSON
    img, meta = d.load_frame_device(ts)  # (H, W) torch.uint16 on the device
    d.load_audio() / d.audio_chunks()

Modern-codec (compressionType 7) frames decode through
:mod:`mcraw_torch.kernels.unpack` (host scans, upload, device prep, the CUDA
modern unpack kernel), legacy-codec (compressionType 6) frames through
:mod:`mcraw_torch.kernels.legacy` (host header-chain scan, upload, the CUDA
legacy unpack kernel); a clip may mix both. ``device="cpu"`` runs the
kernels' plain torch versions. The container, metadata and error model are
the port's copies of the JAX package's NumPy-only modules.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import numpy as np
import torch

from .container import COMPRESSION_TYPE, COMPRESSION_TYPE_LEGACY, ContainerReader
from .errors import DecodeError, IOException, MotionCamException
from .kernels import unpack as U
from .kernels.legacy import decode_legacy as decode_legacy_frame
from .kernels.tables import modern_tables
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


def decode_modern_frame(
    payload: np.ndarray, width: int, height: int, device: torch.device
) -> torch.Tensor:
    """One modern payload -> (height, width) uint16 on `device`."""
    frame = U.prepare_modern(payload, width, height)
    dev = U.upload(frame, device)
    offsets = U.block_offsets(dev.bits, modern_tables(device))
    return U.decode_modern_device(
        dev.words, dev.bits, dev.refs, offsets,
        ty=dev.tiles_y, tx=dev.tiles_x, height=height, width=width,
    )


class Decoder:
    def __init__(self, source, device: torch.device | str = "cuda"):
        """source: path, raw bytes, or open binary file object.
        device: "cuda" (the default; raises without a card) or "cpu"."""
        self._device = resolve_device(device)
        self._reader = ContainerReader(source)

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
        payload, meta = self._reader.frame_payload(timestamp)
        fm = FrameMetadata(meta)
        ct = fm.compression_type
        if ct not in (COMPRESSION_TYPE, COMPRESSION_TYPE_LEGACY):
            raise IOException("Invalid compression type")
        modern = ct == COMPRESSION_TYPE
        self._reference_return_check(payload, fm, modern)
        decode = decode_modern_frame if modern else decode_legacy_frame
        with _uncompress_error_text(modern):
            img = decode(payload, fm.width, fm.height, self._device)
        return img, meta

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
