# A copy of mcraw/container.py, kept in the port so that mcraw_torch imports nothing of
# mcraw; tests/test_torch_standalone.py holds the two equal.
"""MCRAW container format: constants, structs, and the reader.

On-disk grammar from lib/include/motioncam/Container.hpp and the reader
algorithm from lib/Decoder.cpp. The reader memory-maps the file and exposes
flat uint8 payload views plus parsed JSON metadata; all pixel decoding
happens downstream (NumPy oracle or TPU kernels).

Layout (Decoder.cpp:116-151, 237-315):

    [Header "MOTION " + version=3]                              8 B
    [Item{METADATA, n} + n bytes container JSON]
    [... per frame: Item{BUFFER}+payload, Item{METADATA}+frame JSON;
         interleaved audio: Item{AUDIO_DATA}+PCM,
         optional Item{AUDIO_DATA_METADATA}+{timestampNs} ...]
    [Item{AUDIO_INDEX} + AudioIndex + numOffsets x BufferOffset]
    [frame index: numOffsets x BufferOffset at indexDataOffset]
    [Item{BUFFER_INDEX} + BufferIndex]                          last 24 B
"""

from __future__ import annotations

import io
import mmap
import struct
from dataclasses import dataclass
from enum import IntEnum
from typing import BinaryIO

import numpy as np

from .errors import IOException
from .metadata import parse_metadata_json


def _copy_json(o):
    """Deep copy of a parsed-JSON tree (dict/list/scalars only) —
    2-3x cheaper than copy.deepcopy on this host's single vCPU, and the
    batch run-splitter pays it 2-3 times per frame against a ~0.74 ms
    host-prep budget."""
    if isinstance(o, dict):
        return {k: _copy_json(v) for k, v in o.items()}
    if isinstance(o, list):
        return [_copy_json(v) for v in o]
    return o


INDEX_MAGIC_NUMBER = 0x8A905612  # Container.hpp:23
# BufferIndex.magicNumber is an int32, so the magic compares as negative
# (Decoder.cpp:252 compares int32 against the uint32 constant).
INDEX_MAGIC_I32 = INDEX_MAGIC_NUMBER - (1 << 32)
CONTAINER_VERSION = 3  # Container.hpp:25
CONTAINER_ID = b"MOTION "  # Container.hpp:26

COMPRESSION_TYPE_LEGACY = 6  # Decoder.cpp:20
COMPRESSION_TYPE = 7  # Decoder.cpp:21


class ItemType(IntEnum):
    """Container item tags. Container.hpp:38-46."""

    BUFFER_INDEX = 0
    BUFFER_INDEX_DATA = 1
    BUFFER = 2
    METADATA = 3
    AUDIO_INDEX = 4
    AUDIO_DATA = 5
    AUDIO_DATA_METADATA = 6


# struct formats (little-endian, packed — matches x86 layout of the PODs)
HEADER_FMT = struct.Struct("<7sB")  # Header: ident[7], version
ITEM_FMT = struct.Struct("<II")  # Item: type u32, size u32
BUFFER_OFFSET_FMT = struct.Struct("<qq")  # BufferOffset: offset, timestamp
BUFFER_INDEX_FMT = struct.Struct("<iiq")  # BufferIndex: magic, numOffsets, dataOffset
AUDIO_INDEX_FMT = struct.Struct("<qq")  # AudioIndex: numOffsets, startTimestampMs
AUDIO_METADATA_FMT = struct.Struct("<q")  # AudioMetadata: timestampNs

BUFFER_OFFSET_DTYPE = np.dtype([("offset", "<i8"), ("timestamp", "<i8")])


@dataclass(frozen=True)
class FrameEntry:
    timestamp: int
    offset: int


class ContainerReader:
    """Parses an .mcraw container; the Python analogue of Decoder::init.

    Random access is O(1) via the EOF index (Decoder.cpp:237-264). Accepts a
    path, raw bytes, or an open binary file object (the analogue of the
    reference's FILE* constructor, Decoder.hpp:49-50) — real files are
    mmapped, non-seekable streams are read fully. Thread-safe for reads (no
    shared cursor; all reads are absolute offsets into the mmap).
    """

    def __init__(self, source):
        self._file: BinaryIO | None = None
        if isinstance(source, str):
            try:
                self._file = open(source, "rb")
            except OSError as e:
                raise IOException(f"Failed to open {source}") from e
            self._buf = self._mmap_or_fail(self._file, source)
        elif isinstance(source, (bytes, bytearray, memoryview)):
            self._buf = memoryview(bytes(source))
        elif hasattr(source, "read"):  # file object (Decoder.hpp:50)
            try:
                self._buf = memoryview(
                    mmap.mmap(source.fileno(), 0, access=mmap.ACCESS_READ)
                )
            except (ValueError, OSError, AttributeError, io.UnsupportedOperation):
                try:
                    self._buf = memoryview(source.read())
                except OSError as e:
                    raise IOException(f"Failed to read stream: {e}") from e
        else:
            raise IOException(f"Unsupported source type {type(source)!r}")
        self._data = np.frombuffer(self._buf, dtype=np.uint8)
        self._init()

    @staticmethod
    def _mmap_or_fail(f, name: str) -> memoryview:
        try:
            return memoryview(mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ))
        except (ValueError, OSError) as e:  # empty file etc.
            f.close()
            raise IOException(f"Failed to open {name}: {e}") from e

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "ContainerReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- low-level reads ---------------------------------------------------

    def _read(self, offset: int, size: int) -> bytes:
        if offset < 0 or offset + size > len(self._buf):
            raise IOException("Failed to read data")
        return bytes(self._buf[offset : offset + size])

    def _read1(self, offset: int, size: int) -> bytes:
        """The reference's single-item read form (Decoder.cpp:36-40):
        `fread(data, size, 1, f)` returns 0 when size == 0, so a ZERO-SIZE
        payload read throws "Failed to read data" — unlike the items-form
        used for the index arrays, where `fread(data, 16, 0) == 0` items
        succeeds. Zero-size container JSON / BUFFER / frame-METADATA /
        AUDIO_DATA payloads must therefore fail exactly like the reference.
        """
        if size == 0:
            raise IOException("Failed to read data")
        return self._read(offset, size)

    def _read_item(self, offset: int) -> tuple[int, int, int]:
        """Returns (type, size, offset_past_item_header)."""
        t, size = ITEM_FMT.unpack(self._read(offset, ITEM_FMT.size))
        return t, size, offset + ITEM_FMT.size

    # -- parse (Decoder::init, Decoder.cpp:116-151) -------------------------

    def _init(self) -> None:
        ident, version = HEADER_FMT.unpack(self._read(0, HEADER_FMT.size))
        # Version checked before ident, as in Decoder.cpp:123-127.
        if version != CONTAINER_VERSION:
            raise IOException("Invalid container version")
        if ident != CONTAINER_ID:
            raise IOException("Invalid header id")

        t, size, pos = self._read_item(HEADER_FMT.size)
        if t != ItemType.METADATA:
            raise IOException("Invalid camera metadata")
        # nlohmann-dialect parse (Decoder.cpp:141): rejects NaN/Infinity
        # literals; failures raise MetadataError (see errors.MetadataError
        # for the documented divergence vs the reference's abort).
        self.container_metadata: dict = parse_metadata_json(
            self._read1(pos, size)
        )

        self._read_index()
        self._reindex_offsets()
        self._read_extra()

    def _read_index(self) -> None:
        """readIndex, Decoder.cpp:237-264."""
        tail = len(self._buf) - (ITEM_FMT.size + BUFFER_INDEX_FMT.size)
        t, _, pos = self._read_item(tail)
        if t != ItemType.BUFFER_INDEX:
            raise IOException("Invalid file")
        magic, num_offsets, index_data_offset = BUFFER_INDEX_FMT.unpack(
            self._read(pos, BUFFER_INDEX_FMT.size)
        )
        if magic != INDEX_MAGIC_I32:
            raise IOException("Corrupted file")
        raw = self._read(index_data_offset, BUFFER_OFFSET_FMT.size * num_offsets)
        self._offsets = np.frombuffer(raw, dtype=BUFFER_OFFSET_DTYPE)

    def _reindex_offsets(self) -> None:
        """reindexOffsets, Decoder.cpp:266-279: sort by timestamp."""
        order = np.argsort(self._offsets["timestamp"], kind="stable")
        sorted_offsets = self._offsets[order]
        self.frames: list[int] = [int(ts) for ts in sorted_offsets["timestamp"]]
        # std::map::insert keeps the FIRST entry per duplicate key
        # (Decoder.cpp:277); dict assignment keeps the last, so guard.
        self._frame_offset_map: dict[int, int] = {}
        for ts, off in zip(sorted_offsets["timestamp"], sorted_offsets["offset"]):
            self._frame_offset_map.setdefault(int(ts), int(off))
        self._sorted_offsets = sorted_offsets
        # Parsed frame-JSON memo (timestamp -> dict): the batched decode
        # path reads each frame's metadata twice (run-splitting by
        # (codec, w, h), then the decode itself). frame_payload() hands
        # out deep copies — the memo itself is never aliased by callers.
        # Bounded: cleared past 4096 entries.
        self._frame_meta_cache: dict[int, dict] = {}

    def _read_extra(self) -> None:
        """readExtra, Decoder.cpp:281-315: walk items to the audio index."""
        self.audio_offsets = np.empty(0, dtype=BUFFER_OFFSET_DTYPE)
        if len(self._sorted_offsets) == 0:
            return
        pos = int(self._sorted_offsets["offset"][-1])
        skippable = {
            ItemType.BUFFER,
            ItemType.METADATA,
            ItemType.AUDIO_DATA,
            ItemType.AUDIO_DATA_METADATA,
        }
        while True:
            if pos + ITEM_FMT.size > len(self._buf):
                break
            t, size, after = self._read_item(pos)
            if t in skippable:
                pos = after + size
            elif t == ItemType.AUDIO_INDEX:
                num, _start_ms = AUDIO_INDEX_FMT.unpack(
                    self._read(after, AUDIO_INDEX_FMT.size)
                )
                raw = self._read(
                    after + AUDIO_INDEX_FMT.size, BUFFER_OFFSET_FMT.size * num
                )
                self.audio_offsets = np.frombuffer(raw, dtype=BUFFER_OFFSET_DTYPE)
                pos = after + AUDIO_INDEX_FMT.size + BUFFER_OFFSET_FMT.size * num
            else:
                break

    # -- frame / audio access ----------------------------------------------

    def frame_payload(self, timestamp: int) -> tuple[np.ndarray, dict]:
        """Raw compressed payload + parsed frame JSON for one timestamp.

        Mirrors the container walk of loadFrame (Decoder.cpp:184-214) but
        returns the payload undecoded (a zero-copy uint8 view of the mmap).

        The returned metadata dict is a fresh deep copy per call — the
        parse memo stays internal, so a caller mutating its copy (key
        normalization, annotation, ...) cannot poison later reads of the
        same frame (the batch run-splitter reads every frame's metadata
        twice).
        """
        if timestamp not in self._frame_offset_map:
            raise IOException(f"Frame not found (timestamp: {timestamp})")
        pos = self._frame_offset_map[timestamp]

        t, size, after = self._read_item(pos)
        if t != ItemType.BUFFER:
            raise IOException("Invalid buffer type")
        if size == 0:  # reference read(f, buf, 0) throws (Decoder.cpp:36-40)
            raise IOException("Failed to read data")
        payload = self._data[after : after + size]
        if len(payload) != size:
            raise IOException("Failed to read data")

        t, msize, mafter = self._read_item(after + size)
        if t != ItemType.METADATA:
            raise IOException("Invalid metadata")
        metadata = self._frame_meta_cache.get(timestamp)
        if metadata is None:
            # nlohmann-dialect parse (Decoder.cpp:214) — see _init().
            metadata = parse_metadata_json(self._read1(mafter, msize))
            if len(self._frame_meta_cache) >= 4096:
                self._frame_meta_cache.clear()
            self._frame_meta_cache[timestamp] = metadata
        return payload, _copy_json(metadata)

    def frame_payload_window(
        self, timestamp: int
    ) -> tuple[np.ndarray, np.ndarray, dict]:
        """(payload, window, frame JSON): like frame_payload but also returns
        the zero-copy view from the payload start to EOF.

        The window lets device-prep over-read past the payload (its DMA
        tiles round up to 512B rows) without a multi-MB pad copy — the bytes
        after a frame are just the rest of the container, and no valid block
        ever addresses them. Only frames at the very end of the file fall
        back to copying.
        """
        payload, metadata = self.frame_payload(timestamp)
        pos = self._frame_offset_map[timestamp] + ITEM_FMT.size
        return payload, self._data[pos:], metadata

    def audio_chunk(self, index: int) -> tuple[int, np.ndarray] | None:
        """One audio chunk: (timestampNs, int16 interleaved samples).

        Mirrors loadAudioChunk (Decoder.cpp:42-75): timestamp is -1 when the
        optional AUDIO_DATA_METADATA item is absent (older recordings,
        Decoder.cpp:63-70). Returns None when the chunk offset is invalid
        (the batch loader skips those, Decoder.cpp:173-174).
        """
        entry = self.audio_offsets[index]
        pos = int(entry["offset"])
        if pos < 0:
            return None  # FSEEK failure -> false (Decoder.cpp:43-44)
        t, size, after = self._read_item(pos)
        if t != ItemType.AUDIO_DATA:
            raise IOException("Invalid audio data")
        raw = self._read1(after, size)
        # (size+1)//2 samples; odd byte counts leave the final sample's high
        # byte zero, matching tmp.resize((size+1)/2) + partial read
        # (Decoder.cpp:54-57). Zero-size chunks RAISE via _read1 — the
        # reference's fread(_, 0, 1) != 1 throw escapes loadAudio's skip
        # (which only covers seek failures), aborting the whole audio load.
        buf = raw + b"\x00" * (len(raw) & 1)
        samples = np.frombuffer(buf, dtype="<i2").copy()

        # The metadata item read is unconditional in the reference
        # (Decoder.cpp:60-61) and throws at EOF; only a non-matching type
        # falls back to timestamp -1 (Decoder.cpp:63-70).
        timestamp = -1
        t, _msize, mafter = self._read_item(after + size)
        if t == ItemType.AUDIO_DATA_METADATA:
            (timestamp,) = AUDIO_METADATA_FMT.unpack(
                self._read(mafter, AUDIO_METADATA_FMT.size)
            )
        return timestamp, samples

    @property
    def num_audio_chunks(self) -> int:
        return len(self.audio_offsets)
