"""mcraw_torch: MotionCam .mcraw decoding on PyTorch and CUDA.

The port of :mod:`mcraw` (JAX and Pallas on a TPU) to an NVIDIA Hopper GPU.
The hot passes are hand-written CUDA kernels (``csrc/``, built with nvcc
at first use): the block unpack of each codec, the develop of a Bayer
frame to RGBA8888 (:mod:`mcraw_torch.preview`) and the checksum that gates
them. Container, metadata, DNG/WAV emit, colour math and the NumPy oracle
are the JAX package's NumPy-only modules, imported as they are. Nothing
here imports JAX.
"""

from mcraw.errors import (  # noqa: F401
    DecodeError,
    IOException,
    MetadataError,
    MotionCamException,
)

from . import preview  # noqa: F401
from .pipeline import Decoder  # noqa: F401

__version__ = "0.1.0"
