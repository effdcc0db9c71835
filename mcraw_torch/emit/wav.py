# A copy of mcraw/emit/wav.py, kept in the port so that mcraw_torch imports nothing of
# mcraw; tests/test_torch_standalone.py holds the two equal.
"""Bit-exact RIFF/WAVE PCM16 writer.

Reproduces AudioFile<int16_t>::save -> saveToWaveFile byte-for-byte
(thirdparty/audiofile/AudioFile.h:937-1049): 12-byte RIFF header, 24-byte
"fmt " chunk (PCM, formatChunkSize=16), "data" chunk with interleaved
little-endian int16 samples. The example CLI's channel handling
(example.cpp:26-53) is preserved: only 1- or 2-channel audio produces
samples; any other channel count yields a header-only WAV.
"""

from __future__ import annotations

import struct

import numpy as np


def wav_bytes(sample_rate: int, num_channels: int, samples: np.ndarray) -> bytes:
    """Serialize interleaved int16 `samples` shaped (frames, channels)
    or (n,) for mono."""
    samples = np.asarray(samples, dtype="<i2")
    if samples.ndim == 1:
        samples = samples[:, None]
    frames, channels = samples.shape
    assert channels == num_channels

    bit_depth = 16
    data_size = frames * num_channels * (bit_depth // 8)
    fmt_size = 16  # PCM (AudioFile.h:943)
    file_size = 4 + fmt_size + 8 + 8 + data_size  # AudioFile.h:952

    out = bytearray()
    out += b"RIFF" + struct.pack("<i", file_size) + b"WAVE"
    out += b"fmt " + struct.pack(
        "<ihhiihh",
        fmt_size,
        1,  # PCM
        num_channels,
        sample_rate,
        (num_channels * sample_rate * bit_depth) // 8,
        num_channels * (bit_depth // 8),
        bit_depth,
    )
    out += b"data" + struct.pack("<i", data_size)
    out += samples.tobytes()
    return bytes(out)


def chunks_to_samples(
    chunks: list[tuple[int, np.ndarray]], num_channels: int
) -> np.ndarray:
    """Concatenate audio chunks into (frames, channels) int16.

    Mirrors writeAudio (example.cpp:26-53): 2-channel chunks are consumed in
    sample pairs (an odd trailing sample is dropped); channel counts other
    than 1 or 2 produce zero samples, yielding a 44-byte header-only WAV.
    """
    if num_channels not in (1, 2):
        return np.zeros((0, num_channels), dtype=np.int16)
    parts = []
    for _ts, data in chunks:
        data = np.asarray(data, dtype=np.int16)
        if num_channels == 2:
            data = data[: len(data) - (len(data) % 2)]
        parts.append(data.reshape(-1, num_channels))
    if not parts:
        return np.zeros((0, num_channels), dtype=np.int16)
    return np.concatenate(parts, axis=0)


def write_wav(
    path: str,
    sample_rate: int,
    num_channels: int,
    chunks: list[tuple[int, np.ndarray]],
) -> None:
    samples = chunks_to_samples(chunks, num_channels)
    with open(path, "wb") as f:
        f.write(wav_bytes(sample_rate, num_channels, samples))
