# A copy of mcraw/errors.py, kept in the port so that mcraw_torch imports nothing of
# mcraw; tests/test_torch_standalone.py holds the two equal.
"""Exception hierarchy mirroring the reference decoder's error model.

The reference defines MotionCamException and IOException (Decoder.hpp:31-39)
and throws IOException on every failure path. The TPU framework keeps that
two-level shape and adds DecodeError for codec-level failures, which the
reference signals only via a <=0 return from raw::Decode (Decoder.cpp:225-230
then wraps it in an IOException).
"""


class MotionCamException(RuntimeError):
    """Base class for all mcraw errors (Decoder.hpp:31-34)."""


class IOException(MotionCamException):
    """Container / file-level failure (Decoder.hpp:36-39)."""


class DecodeError(IOException):
    """Codec-level failure (truncated or malformed block data)."""


class MetadataError(MotionCamException):
    """Malformed metadata JSON: parse failure, dialect violation
    (NaN/Infinity — rejected by nlohmann, accepted by Python json),
    missing key, or wrong-typed/short value.

    Documented tightening of the reference: its JSON errors are NOT
    MotionCamExceptions — nlohmann parse_error/type_error escape the
    example's catch (example.cpp:196-199) and abort the process via
    std::terminate, and several missing-key paths (const operator[] in
    writeDng, example.cpp:61-72) are outright UB. We surface the same
    failures as clean in-hierarchy errors; tests/test_json_parity.py
    pins each divergence class against the compiled reference.
    """
