"""qoaudio_tpu_torch — the QOA codec's device tier in PyTorch and CUDA.

The port of ``qoaudio_tpu`` to PyTorch, with the Pallas kernels rewritten
by hand in CUDA C++ for Hopper (``csrc/``).  Its public entry points are
the JAX package's, with a ``"torch"`` backend where that package has
``"jax"``: the one-shot ``codec`` functions, ``QoaDecoder`` /
``QoaEncoder``, ``QoaPcmSource``, the batched corpus layer
(``parallel``) and the CLI (``python -m qoaudio_tpu_torch``).  The
``"torch"`` backend takes an explicit ``device``: a CPU device runs the
plain PyTorch versions of the kernels, a CUDA device runs the kernels
themselves, and nothing falls back from one to the other.

The host tier (format, bitstream, types, errors, the native engine, the
scalar oracle, WAV I/O) is the port's own copy of the JAX package's
(``tests/test_torch_host.py`` holds each copy against its original).  This
package imports nothing of jax and nothing of ``qoaudio_tpu``.
"""

from . import bitstream, native, types  # noqa: F401
from . import format  # noqa: F401,A004
from .format import (  # noqa: F401
    QOA_FRAME_LEN,
    QOA_HEADER_SIZE,
    QOA_LMS_LEN,
    QOA_MAGIC,
    QOA_MAX_CHANNELS,
    QOA_SLICE_LEN,
    QOA_SLICES_PER_FRAME,
    MAX_SLICES_PER_CHANNEL_PER_FRAME,
    qoa_frame_size,
)
from .errors import (  # noqa: F401
    DecodeError,
    EncodeError,
    IncompatibleFrame,
    InvalidChannels,
    InvalidFrameHeader,
    InvalidSampleRate,
    InvalidSamples,
    IoError,
    NoSamples,
    NotQoaFile,
    QoaError,
)
from .types import (  # noqa: F401
    DecodedQoa,
    FixedSamples,
    FrameHeader,
    ProcessingMode,
    QoaDesc,
    Streaming,
)

from . import codec  # noqa: F401
from .codec import (  # noqa: F401
    decode_all,
    decode_range,
    encode_all,
    encode_all_batch,
    open_and_decode_all,
)
from .source import QoaPcmSource  # noqa: F401
from .streaming import QoaDecoder, QoaEncoder  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "bitstream",
    "codec",
    "format",
    "native",
    "types",
    "DecodedQoa",
    "FixedSamples",
    "FrameHeader",
    "ProcessingMode",
    "QoaDesc",
    "Streaming",
    "decode_all",
    "decode_range",
    "encode_all",
    "encode_all_batch",
    "open_and_decode_all",
    "QoaDecoder",
    "QoaEncoder",
    "QoaPcmSource",
    "QOA_FRAME_LEN",
    "QOA_HEADER_SIZE",
    "QOA_LMS_LEN",
    "QOA_MAGIC",
    "QOA_MAX_CHANNELS",
    "QOA_SLICE_LEN",
    "QOA_SLICES_PER_FRAME",
    "MAX_SLICES_PER_CHANNEL_PER_FRAME",
    "qoa_frame_size",
    "DecodeError",
    "EncodeError",
    "IncompatibleFrame",
    "InvalidChannels",
    "InvalidFrameHeader",
    "InvalidSampleRate",
    "InvalidSamples",
    "IoError",
    "NoSamples",
    "NotQoaFile",
    "QoaError",
]
