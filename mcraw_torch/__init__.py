"""mcraw_torch: MotionCam .mcraw decoding on PyTorch and CUDA.

The port of :mod:`mcraw` (JAX and Pallas on a TPU) to an NVIDIA Hopper GPU.
The hot block unpack of each codec is a hand-written CUDA kernel
(``csrc/``, built with nvcc at first use); container, metadata, DNG/WAV emit and the NumPy oracle
are the JAX package's NumPy-only modules, imported as they are. Nothing
here imports JAX.
"""

from mcraw.errors import (  # noqa: F401
    DecodeError,
    IOException,
    MetadataError,
    MotionCamException,
)

from .pipeline import Decoder  # noqa: F401

__version__ = "0.1.0"
