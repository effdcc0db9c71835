# A copy of mcraw/metadata.py, kept in the port so that mcraw_torch imports nothing of
# mcraw; tests/test_torch_standalone.py holds the two equal.
"""Typed accessors for container- and frame-level JSON metadata.

The implicit schema the reference reads (SURVEY.md §2.3):
- container JSON: extraData.audioSampleRate / audioChannels
  (Decoder.cpp:162-167), blackLevel, whiteLevel, colorMatrix1/2,
  forwardMatrix1/2, and the *misspelled* key ``sensorArrangment``
  (example.cpp:66-72 — no second 'e'; preserved deliberately).
- frame JSON: width, height, compressionType (Decoder.cpp:216-218),
  asShotNeutral (example.cpp:64).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field

import numpy as np

from .errors import MetadataError, MotionCamException

# CFA byte patterns per sensor arrangement (example.cpp:96-105).
CFA_PATTERNS: dict[str, bytes] = {
    "rggb": bytes((0, 1, 1, 2)),
    "bggr": bytes((2, 1, 1, 0)),
    "grbg": bytes((1, 0, 2, 1)),
    "gbrg": bytes((1, 2, 0, 1)),
}


# -- nlohmann-dialect JSON parsing + typed conversions --------------------
#
# The reference parses metadata with nlohmann::json::parse
# (Decoder.cpp:141, :214) and reads keys with typed conversions
# (Decoder.cpp:161-167, :216-218; example.cpp:61-72). Python's json is a
# LOOSER dialect (it accepts NaN/Infinity/-Infinity literals nlohmann
# rejects) and Python's int() is a LOOSER conversion (int("42") succeeds
# where nlohmann get<int> from a string throws type_error.302). These
# helpers pin the nlohmann semantics so malformed metadata fails in the
# same CLASS as the reference; the failure FORM is a clean MetadataError
# instead of the reference's uncaught-exception abort / UB (see
# errors.MetadataError).


def _reject_constant(name: str):
    # nlohmann has no NaN/Infinity literals: json.exception.parse_error.101
    raise MetadataError(f"invalid metadata JSON: unexpected '{name}'")


def _parse_float(s: str) -> float:
    # nlohmann rejects float literals that overflow to inf
    # (json.hpp lexer -> !isfinite -> out_of_range.406); Python would
    # return inf silently.
    v = float(s)
    if not math.isfinite(v):
        raise MetadataError(
            f"invalid metadata JSON: number overflow parsing '{s}'"
        )
    return v


def _parse_int(s: str) -> object:
    # nlohmann integer literals: negative fits int64 / non-negative fits
    # uint64 -> integer; otherwise the lexer FALLS BACK TO DOUBLE
    # (json.hpp scan_number_done), with overflow-to-inf a parse error.
    # Python's unbounded int would silently diverge (e.g. width =
    # 2^64+192 wraps to a DECODABLE 192 for us, aborts the reference).
    v = int(s)
    if -(1 << 63) <= v < (1 << 64):
        return v
    return _parse_float(s)


def parse_metadata_json(data: bytes) -> object:
    """json::parse with nlohmann's dialect (Decoder.cpp:141, :214).

    Rejects invalid UTF-8, syntax errors, the NaN/Infinity literals
    Python's json would accept, and overflowing number literals; huge
    integer literals degrade to double exactly like nlohmann's lexer.
    Raises MetadataError (the reference's parse_error escapes its catch
    and aborts, example.cpp:196-199).

    NUL semantics (probed live, found by tools/soak_json.py): nlohmann
    truncates the input at the first NUL byte — '{...}\\x00<garbage>'
    parses (everything after the NUL silently ignored) while a NUL
    inside the document fails as a truncated document. Replicated by
    splitting at the first NUL before parsing."""
    if isinstance(data, (bytes, bytearray)):
        data = bytes(data).split(b"\x00", 1)[0]
    try:
        return json.loads(
            data,
            parse_constant=_reject_constant,
            parse_float=_parse_float,
            parse_int=_parse_int,
        )
    except MetadataError:
        raise
    except (ValueError, UnicodeDecodeError) as e:
        raise MetadataError(f"invalid metadata JSON: {e}") from None


def _get(raw: object, key: str) -> object:
    """Key lookup with nlohmann failure semantics, tightened.

    Reference: non-const operator[] on a missing key inserts null (then
    the typed read throws type_error -> abort); const operator[] is UB
    (example.cpp:61-72). Non-object access throws type_error.305."""
    if not isinstance(raw, dict):
        raise MetadataError(
            f"metadata key '{key}': value is not a JSON object"
        )
    if key not in raw:
        raise MetadataError(f"missing metadata key '{key}'")
    return raw[key]


def _type_name(v: object) -> str:
    return {
        bool: "boolean", int: "number", float: "number", str: "string",
        list: "array", dict: "object", type(None): "null",
    }.get(type(v), type(v).__name__)


def _to_arith(v: object, key: str) -> object:
    """nlohmann's GENERIC arithmetic from_json (json.hpp:4959-4990):
    for any arithmetic target that is not exactly number_integer_t /
    number_unsigned_t / number_float_t / boolean_t (so: the reference's
    `int`, `float`, `uint16_t`, `short` reads), the accepted sources are
    the three number types AND BOOLEAN (static_cast: true -> 1).
    Everything else is type_error.302. Found the asymmetry via
    tools/soak_json.py: `int width = json(true)` SUCCEEDS while
    `double whiteLevel = json(false)` aborts (exact-type overload)."""
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, (int, float)):
        return v
    raise MetadataError(
        f"metadata key '{key}': type must be number, but is {_type_name(v)}"
    )


def _to_int(v: object, key: str) -> int:
    """nlohmann get<int> (generic arithmetic): integer/bool ->
    static_cast<int32> (two's-complement wrap, well-defined); float ->
    truncation toward zero, with out-of-int32 truncations landing on
    x86-64's cvttsd2si indefinite value 0x80000000 = INT_MIN (probed
    against the compiled reference: compressionType 1e308 reads as
    INT_MIN -> clean 'Invalid compression type', soak_json iter 498)."""
    a = _to_arith(v, key)
    if isinstance(a, float):
        t = int(a)  # finite by parse construction; truncates toward zero
        return t if -(2**31) <= t < 2**31 else -(2**31)
    return ((a + (1 << 31)) % (1 << 32)) - (1 << 31)


def _to_float(v: object, key: str) -> float:
    """Generic-arithmetic float target (matrix/neutral elements):
    booleans convert (see _to_arith)."""
    return float(_to_arith(v, key))


def _to_double(v: object, key: str) -> float:
    """EXACT number_float_t (double) target — the whiteLevel read
    (example.cpp:67). nlohmann's exact-type overload accepts only the
    three number types: boolean -> type_error.302 (soak_json iter 117)."""
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    raise MetadataError(
        f"metadata key '{key}': type must be number, but is {_type_name(v)}"
    )


def _to_str(v: object, key: str) -> str:
    if isinstance(v, str):
        return v
    raise MetadataError(
        f"metadata key '{key}': type must be string, but is {_type_name(v)}"
    )


def _to_float_vec(v: object, key: str, n: int) -> np.ndarray:
    """nlohmann std::vector<float> + fixed-count consumer.

    The reference converts the whole array then reads exactly n entries
    from data() (e.g. SetColorMatrix1(3, ..) reads 9 floats,
    example.cpp:110-118): longer arrays are defined behavior (extras
    ignored), SHORTER arrays are an out-of-bounds read (UB) -> we raise."""
    if not isinstance(v, list):
        raise MetadataError(
            f"metadata key '{key}': type must be array, but is "
            f"{_type_name(v)}"
        )
    if len(v) < n:
        raise MetadataError(
            f"metadata key '{key}': expected >= {n} entries, got {len(v)}"
        )
    # Convert EVERY element, not just the first n: nlohmann materializes
    # the whole std::vector before the consumer reads n entries, so a
    # wrong-typed element BEYOND n still throws type_error.302 in the
    # reference (tools/soak_json.py iter 3990).
    vals = [_to_float(x, key) for x in v]
    return np.asarray(vals[:n], dtype=np.float32)


def _to_uint16_vec(v: object, key: str, n: int) -> np.ndarray:
    """nlohmann std::vector<uint16_t>: per-element static_cast wraps
    negatives/overflow mod 2^16 (defined for integer sources)."""
    if not isinstance(v, list):
        raise MetadataError(
            f"metadata key '{key}': type must be array, but is "
            f"{_type_name(v)}"
        )
    if len(v) < n:
        raise MetadataError(
            f"metadata key '{key}': expected >= {n} entries, got {len(v)}"
        )
    # Whole-array conversion before the n-entry read (see _to_float_vec).
    vals = [_to_int(x, key) for x in v]
    return np.asarray(vals[:n], dtype=np.int64).astype(np.uint16)


@dataclass(frozen=True)
class ContainerMetadata:
    raw: dict

    @property
    def audio_sample_rate(self) -> int:
        # Decoder.cpp:161-163: mMetadata["extraData"]["audioSampleRate"]
        return _to_int(
            _get(_get(self.raw, "extraData"), "audioSampleRate"),
            "audioSampleRate",
        )

    @property
    def audio_channels(self) -> int:
        return _to_int(
            _get(_get(self.raw, "extraData"), "audioChannels"),
            "audioChannels",
        )

    @property
    def black_level(self) -> np.ndarray:
        # example.cpp:66 + SetBlackLevel(4, ..): exactly 4 entries read.
        return _to_uint16_vec(_get(self.raw, "blackLevel"), "blackLevel", 4)

    @property
    def white_level(self) -> float:
        # `double whiteLevel = ...` — the EXACT number_float_t overload
        # (rejects boolean, unlike the generic int/float reads).
        return _to_double(_get(self.raw, "whiteLevel"), "whiteLevel")

    @property
    def sensor_arrangement(self) -> str:
        # Key is misspelled in real containers; honor it (example.cpp:68).
        return _to_str(_get(self.raw, "sensorArrangment"), "sensorArrangment")

    @property
    def cfa_pattern(self) -> bytes:
        arr = self.sensor_arrangement
        if arr not in CFA_PATTERNS:
            raise MotionCamException("Invalid sensor arrangement")
        return CFA_PATTERNS[arr]

    def color_matrix(self, which: int) -> np.ndarray:
        key = f"colorMatrix{which}"
        return _to_float_vec(_get(self.raw, key), key, 9)

    def forward_matrix(self, which: int) -> np.ndarray:
        key = f"forwardMatrix{which}"
        return _to_float_vec(_get(self.raw, key), key, 9)


@dataclass(frozen=True)
class FrameMetadata:
    raw: dict

    @property
    def width(self) -> int:
        # Decoder.cpp:216: const int width = outMetadata["width"]
        return _to_int(_get(self.raw, "width"), "width")

    @property
    def height(self) -> int:
        return _to_int(_get(self.raw, "height"), "height")

    @property
    def compression_type(self) -> int:
        return _to_int(_get(self.raw, "compressionType"), "compressionType")

    @property
    def as_shot_neutral(self) -> np.ndarray:
        # example.cpp:64 + SetAsShotNeutral reads exactly 3 rationals.
        return _to_float_vec(
            _get(self.raw, "asShotNeutral"), "asShotNeutral", 3
        )


def example_container_metadata(
    sample_rate: int = 48000,
    channels: int = 2,
    sensor: str = "rggb",
    black_level: tuple[int, int, int, int] = (64, 64, 64, 64),
    white_level: float = 1023.0,
) -> dict:
    """A minimal schema-complete container JSON for fixtures."""
    ident = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
    return {
        "extraData": {"audioSampleRate": sample_rate, "audioChannels": channels},
        "blackLevel": list(black_level),
        "whiteLevel": white_level,
        "sensorArrangment": sensor,
        "colorMatrix1": ident,
        "colorMatrix2": ident,
        "forwardMatrix1": ident,
        "forwardMatrix2": ident,
    }


def example_frame_metadata(
    width: int, height: int, compression_type: int = 7
) -> dict:
    return {
        "width": width,
        "height": height,
        "compressionType": compression_type,
        "asShotNeutral": [0.5, 1.0, 0.6],
    }
