# A copy of mcraw/emit/dng.py, kept in the port so that mcraw_torch imports nothing of
# mcraw; tests/test_torch_standalone.py holds the two equal.
"""Bit-exact DNG writer reproducing the reference CLI's output byte-for-byte.

The reference example writes DNGs through tinydng (example.cpp:55-139,
thirdparty/tinydng/tiny_dng_writer.h). Its byte layout, reproduced here:

  [8-byte TIFF header: "II", 42, ifd_offset = 8 + len(data)]
  [data area: accrues in Set* CALL ORDER; image strip first, then every tag
   payload > 4 bytes in the order the tags were set]
  [IFD: u16 tag count; 12-byte entries sorted ascending by tag id, with the
   STRIP_OFFSET tag synthesized at write time (tiny_dng_writer.h:1993-2005);
   <=4-byte values inlined and zero-padded; u32 next-IFD offset = 0]

Float -> RATIONAL conversion clones tinydng's FloatToRational
(tiny_dng_writer.h:500-536) including its float32 semantics, and the
whiteLevel double -> short truncation of SetWhiteLevel(short)
(example.cpp:91 passing a double into tiny_dng_writer.h:1074).
"""

from __future__ import annotations

import math
import struct

import numpy as np

from ..errors import MotionCamException
from ..metadata import CFA_PATTERNS, ContainerMetadata, FrameMetadata

# TIFF field types (tiny_dng_writer.h:475-491)
TIFF_BYTE = 1
TIFF_ASCII = 2
TIFF_SHORT = 3
TIFF_LONG = 4
TIFF_RATIONAL = 5
TIFF_SLONG = 9
TIFF_SRATIONAL = 10

_TYPE_SIZE = {
    TIFF_BYTE: 1,
    TIFF_ASCII: 1,
    TIFF_SHORT: 2,
    TIFF_LONG: 4,
    TIFF_RATIONAL: 8,
    TIFF_SLONG: 4,
    TIFF_SRATIONAL: 8,
}

# Tag ids (tiny_dng_writer.h:104-163)
TAG_SUB_FILETYPE = 254
TAG_IMAGE_WIDTH = 256
TAG_IMAGE_LENGTH = 257
TAG_BITS_PER_SAMPLE = 258
TAG_COMPRESSION = 259
TAG_PHOTOMETRIC = 262
TAG_STRIP_OFFSET = 273
TAG_SAMPLES_PER_PIXEL = 277
TAG_ROWS_PER_STRIP = 278
TAG_STRIP_BYTE_COUNTS = 279
TAG_PLANAR_CONFIG = 284
TAG_CFA_REPEAT_PATTERN_DIM = 33421
TAG_CFA_PATTERN = 33422
TAG_DNG_VERSION = 50706
TAG_DNG_BACKWARD_VERSION = 50707
TAG_UNIQUE_CAMERA_MODEL = 50708
TAG_CFA_LAYOUT = 50711
TAG_BLACK_LEVEL_REPEAT_DIM = 50713
TAG_BLACK_LEVEL = 50714
TAG_WHITE_LEVEL = 50717
TAG_COLOR_MATRIX1 = 50721
TAG_COLOR_MATRIX2 = 50722
TAG_AS_SHOT_NEUTRAL = 50728
TAG_CALIBRATION_ILLUMINANT1 = 50778
TAG_CALIBRATION_ILLUMINANT2 = 50779
TAG_ACTIVE_AREA = 50829
TAG_FORWARD_MATRIX1 = 50964
TAG_FORWARD_MATRIX2 = 50965

PHOTOMETRIC_CFA = 32803
COMPRESSION_NONE = 1
PLANARCONFIG_CONTIG = 1

_HEADER_SIZE = 8  # tiny_dng_writer.h:494


def float_to_rational(x: float) -> tuple[int, int]:
    """Clone of tinydng's FloatToRational (tiny_dng_writer.h:500-536).

    Operates in float32 like the original; returns (numerator, denominator)
    as Python ints (exact — both are dyadic and fit the float32 mantissa).
    """
    x = float(np.float32(x))
    if not math.isfinite(x):
        num = 1.0 if x > 0 else (-1.0 if x < 0 else 0.0)
        return int(num), 0

    flt_mant_dig = 24
    flt_max_exp = 128
    m, expo = math.frexp(x)
    numerator = m * (2.0**flt_mant_dig)  # integer-valued float
    denominator = 1.0
    expo -= flt_mant_dig
    if expo > 0:
        numerator *= 2.0**expo
    elif expo < 0:
        expo = -expo
        if expo >= flt_max_exp - 1:
            numerator /= 2.0 ** (expo - (flt_max_exp - 1))
            denominator *= 2.0 ** (flt_max_exp - 1)
            return int(numerator), int(denominator)
        denominator *= 2.0**expo

    num_i, den_i = int(numerator), int(denominator)
    while num_i != 0 and num_i % 2 == 0 and den_i % 2 == 0:
        num_i //= 2
        den_i //= 2
    return num_i, den_i


def _cast_i32(x: int) -> int:
    """static_cast<int>(float) as compiled on x86-64: cvttss2si r32 yields
    INT_MIN on overflow/NaN."""
    if not (-(2**31) <= x < 2**31):
        return -(2**31)
    return x


def _cast_u32(x: int) -> int:
    """static_cast<unsigned int>(float) as compiled by gcc on x86-64:
    cvttss2si r64 then truncate to 32 bits; 2^63 sentinel on overflow."""
    if not (-(2**63) <= x < 2**63):
        x = -(2**63)
    return x & 0xFFFFFFFF


def _rationals(values, signed: bool) -> bytes:
    out = bytearray()
    for v in values:
        num, den = float_to_rational(v)
        if signed:
            out += struct.pack("<ii", _cast_i32(num), _cast_i32(den))
        else:
            out += struct.pack("<II", _cast_u32(num), _cast_u32(den))
    return bytes(out)


class DNGImage:
    """Accumulates tags + data area in call order, like tinydng's DNGImage."""

    def __init__(self):
        self._data = bytearray()
        self._tags: list[tuple[int, int, int, bytes | int]] = []
        self._strip_offset = 0
        self._strip_bytes = 0

    def _tag(self, tag: int, ttype: int, count: int, payload: bytes) -> None:
        """WriteTIFFTag (tiny_dng_writer.h:616-667): payloads > 4 bytes go to
        the data area at the current cursor; <=4 bytes are inlined."""
        length = count * _TYPE_SIZE[ttype]
        if length > 4:
            offset = len(self._data) + _HEADER_SIZE
            self._data += payload
            self._tags.append((tag, ttype, count, offset))
        else:
            inline = payload[:length] + b"\x00" * (4 - length)
            self._tags.append((tag, ttype, count, inline))

    # -- tag setters in the subset the reference CLI uses -------------------

    def set_dng_version(self, a, b, c, d):
        self._tag(TAG_DNG_VERSION, TIFF_BYTE, 4, bytes((a, b, c, d)))

    def set_dng_backward_version(self, a, b, c, d):
        self._tag(TAG_DNG_BACKWARD_VERSION, TIFF_BYTE, 4, bytes((a, b, c, d)))

    def set_image_data(self, data: bytes):
        self._strip_offset = len(self._data)
        self._strip_bytes = len(data)
        self._data += data
        self._tag(TAG_STRIP_BYTE_COUNTS, TIFF_LONG, 1, struct.pack("<I", len(data)))

    def set_image_width(self, v):
        self._tag(TAG_IMAGE_WIDTH, TIFF_LONG, 1, struct.pack("<I", v))

    def set_image_length(self, v):
        self._tag(TAG_IMAGE_LENGTH, TIFF_LONG, 1, struct.pack("<I", v))

    def set_planar_config(self, v):
        self._tag(TAG_PLANAR_CONFIG, TIFF_SHORT, 1, struct.pack("<H", v))

    def set_photometric(self, v):
        self._tag(TAG_PHOTOMETRIC, TIFF_SHORT, 1, struct.pack("<H", v))

    def set_rows_per_strip(self, v):
        self._tag(TAG_ROWS_PER_STRIP, TIFF_LONG, 1, struct.pack("<I", v))

    def set_samples_per_pixel(self, v):
        self._tag(TAG_SAMPLES_PER_PIXEL, TIFF_SHORT, 1, struct.pack("<H", v))

    def set_cfa_repeat_pattern_dim(self, w, h):
        self._tag(TAG_CFA_REPEAT_PATTERN_DIM, TIFF_SHORT, 2, struct.pack("<HH", w, h))

    def set_black_level_repeat_dim(self, w, h):
        self._tag(TAG_BLACK_LEVEL_REPEAT_DIM, TIFF_SHORT, 2, struct.pack("<HH", w, h))

    def set_black_level(self, values):
        payload = np.asarray(values, dtype="<u2").tobytes()
        self._tag(TAG_BLACK_LEVEL, TIFF_SHORT, len(values), payload)

    def set_white_level_short(self, value: float):
        # SetWhiteLevel takes a C `short`; example.cpp passes a double, which
        # truncates (65535.0 -> -1 -> bytes FF FF on x86). Doubles whose
        # truncation falls outside int32 go through cvttsd2si's indefinite
        # result 0x80000000, low 16 bits = 0 — probed against the compiled
        # reference (1e308 / -2^63 / 2147483700.0 all emit 0x0000;
        # 70000.5 emits 0x1170; tools/soak_json.py iters 85/207).
        t = int(value)
        v = t if -(2**31) <= t < 2**31 else -(2**31)
        v = ((v + 0x8000) & 0xFFFF) - 0x8000
        self._tag(TAG_WHITE_LEVEL, TIFF_SHORT, 1, struct.pack("<h", v))

    def set_compression(self, v):
        self._tag(TAG_COMPRESSION, TIFF_SHORT, 1, struct.pack("<H", v))

    def set_cfa_pattern(self, cfa: bytes):
        self._tag(TAG_CFA_PATTERN, TIFF_BYTE, len(cfa), bytes(cfa))

    def set_cfa_layout(self, v):
        self._tag(TAG_CFA_LAYOUT, TIFF_SHORT, 1, struct.pack("<H", v))

    def set_bits_per_sample(self, values):
        payload = np.asarray(values, dtype="<u2").tobytes()
        self._tag(TAG_BITS_PER_SAMPLE, TIFF_SHORT, len(values), payload)

    def set_color_matrix1(self, m):
        self._tag(TAG_COLOR_MATRIX1, TIFF_SRATIONAL, 9, _rationals(m, True))

    def set_color_matrix2(self, m):
        self._tag(TAG_COLOR_MATRIX2, TIFF_SRATIONAL, 9, _rationals(m, True))

    def set_forward_matrix1(self, m):
        self._tag(TAG_FORWARD_MATRIX1, TIFF_SRATIONAL, 9, _rationals(m, True))

    def set_forward_matrix2(self, m):
        self._tag(TAG_FORWARD_MATRIX2, TIFF_SRATIONAL, 9, _rationals(m, True))

    def set_as_shot_neutral(self, v):
        self._tag(TAG_AS_SHOT_NEUTRAL, TIFF_RATIONAL, 3, _rationals(v, False))

    def set_calibration_illuminant1(self, v):
        self._tag(TAG_CALIBRATION_ILLUMINANT1, TIFF_SHORT, 1, struct.pack("<H", v))

    def set_calibration_illuminant2(self, v):
        self._tag(TAG_CALIBRATION_ILLUMINANT2, TIFF_SHORT, 1, struct.pack("<H", v))

    def set_unique_camera_model(self, name: str):
        payload = name.encode() + b"\x00"
        self._tag(TAG_UNIQUE_CAMERA_MODEL, TIFF_ASCII, len(payload), payload)

    def set_subfile_type(self):
        self._tag(TAG_SUB_FILETYPE, TIFF_LONG, 1, struct.pack("<I", 0))

    def set_active_area(self, values):
        payload = struct.pack("<4I", *values)
        self._tag(TAG_ACTIVE_AREA, TIFF_LONG, 4, payload)

    # -- serialization -------------------------------------------------------

    def ifd_bytes(self, data_base_offset: int, strip_offset: int) -> bytes:
        """WriteIFDToStream (tiny_dng_writer.h:1985-2063)."""
        tags = list(self._tags)
        tags.append(
            (TAG_STRIP_OFFSET, TIFF_LONG, 1,
             struct.pack("<I", strip_offset + _HEADER_SIZE))
        )
        tags.sort(key=lambda t: t[0])

        out = bytearray(struct.pack("<H", len(tags)))
        for tag, ttype, count, val in tags:
            out += struct.pack("<HHI", tag, ttype, count)
            if isinstance(val, int):  # data-area offset
                out += struct.pack("<I", val + data_base_offset)
            else:  # inlined value, already padded to 4
                out += val
        return bytes(out)


def dng_bytes(
    image: np.ndarray, frame_metadata: dict, container_metadata: dict
) -> bytes:
    """Serialize one frame exactly like writeDng (example.cpp:55-139).

    Metadata reads go through the nlohmann-typed accessors
    (mcraw.metadata): missing keys / wrong types / short arrays raise
    MetadataError where the reference aborts or OOB-reads
    (example.cpp:61-72 const operator[] + fixed-count Set* reads)."""
    fm = FrameMetadata(frame_metadata)
    cm = ContainerMetadata(container_metadata)
    width, height = fm.width, fm.height
    sensor = cm.sensor_arrangement  # misspelled key, example.cpp:68
    if sensor not in CFA_PATTERNS:
        raise MotionCamException("Invalid sensor arrangement")

    image = np.ascontiguousarray(image, dtype="<u2")
    assert image.shape == (height, width)

    d = DNGImage()
    # Exact Set* call order of example.cpp:77-130 — the order determines the
    # data-area layout and must not change.
    d.set_dng_version(1, 4, 0, 0)
    d.set_dng_backward_version(1, 1, 0, 0)
    d.set_image_data(image.tobytes())
    d.set_image_width(width)
    d.set_image_length(height)
    d.set_planar_config(PLANARCONFIG_CONTIG)
    d.set_photometric(PHOTOMETRIC_CFA)
    d.set_rows_per_strip(height)
    d.set_samples_per_pixel(1)
    d.set_cfa_repeat_pattern_dim(2, 2)
    d.set_black_level_repeat_dim(2, 2)
    d.set_black_level(cm.black_level)
    d.set_white_level_short(cm.white_level)
    d.set_compression(COMPRESSION_NONE)
    d.set_cfa_pattern(CFA_PATTERNS[sensor])
    d.set_cfa_layout(1)
    d.set_bits_per_sample([16])
    d.set_color_matrix1(cm.color_matrix(1))
    d.set_color_matrix2(cm.color_matrix(2))
    d.set_forward_matrix1(cm.forward_matrix(1))
    d.set_forward_matrix2(cm.forward_matrix(2))
    d.set_as_shot_neutral(fm.as_shot_neutral)
    d.set_calibration_illuminant1(21)
    d.set_calibration_illuminant2(17)
    d.set_unique_camera_model("MotionCam")
    d.set_subfile_type()
    d.set_active_area([0, 0, height, width])

    # DNGWriter::WriteToFile (tiny_dng_writer.h:2099-2189), single image.
    data = bytes(d._data)
    header = b"II\x2a\x00" + struct.pack("<I", _HEADER_SIZE + len(data))
    ifd = d.ifd_bytes(data_base_offset=0, strip_offset=d._strip_offset)
    next_ifd = struct.pack("<I", 0)
    return header + data + ifd + next_ifd


def write_dng(
    path: str, image: np.ndarray, frame_metadata: dict, container_metadata: dict
) -> None:
    # Serialize BEFORE opening: a metadata fault must not leave a stray
    # empty file (the reference faults in writeDng before its
    # WriteToFile opens anything, example.cpp:55-139).
    blob = dng_bytes(image, frame_metadata, container_metadata)
    with open(path, "wb") as f:
        f.write(blob)
