# A copy of mcraw/emit/__init__.py, kept in the port so that mcraw_torch imports nothing of
# mcraw; tests/test_torch_standalone.py holds the two equal.
from .dng import dng_bytes, write_dng  # noqa: F401
from .wav import wav_bytes, write_wav, chunks_to_samples  # noqa: F401
