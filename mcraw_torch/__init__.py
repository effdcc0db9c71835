"""mcraw_torch: MotionCam .mcraw decoding on PyTorch and CUDA.

The port of :mod:`mcraw` (JAX and Pallas on a TPU) to an NVIDIA Hopper GPU.
The hot passes are hand-written CUDA kernels (``csrc/``, built with nvcc
at first use): the block unpack of each codec, the develop of a Bayer
frame to RGBA8888 (:mod:`mcraw_torch.preview`) and the checksum that gates
them. :mod:`mcraw_torch.clip` exports whole clips (overlapped, resumable,
per-frame error isolation) and :mod:`mcraw_torch.observe` times and traces
them. Container, metadata, errors, DNG/WAV emit, colour math, the fixture
encoder, the codec tables and the host scans (C++, built with g++ at first
use) are the port's own copies of the JAX package's NumPy-only modules:
nothing here imports JAX or anything of :mod:`mcraw`.
"""

from .errors import (  # noqa: F401
    DecodeError,
    IOException,
    MetadataError,
    MotionCamException,
)

from .container import (  # noqa: F401
    COMPRESSION_TYPE,
    COMPRESSION_TYPE_LEGACY,
    ContainerReader,
    ItemType,
)
from .metadata import ContainerMetadata, FrameMetadata  # noqa: F401

from . import preview  # noqa: F401
from .codecs import decode_legacy, decode_modern  # noqa: F401
from .pipeline import AudioChunkLoader, Decoder, FrameDecoder  # noqa: F401

__version__ = "0.1.0"
