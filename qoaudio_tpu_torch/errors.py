"""Error taxonomy, mirroring the reference enums.

A copy of ``qoaudio_tpu/errors.py`` (the port's own classes: they are
not the JAX package's, and ``except`` clauses do not mix them).

Reference: ``DecodeError`` at src/lib.rs:866-893 and
``EncodeError`` at src/lib.rs:104-115,895-912.  Python idiom: exception
subclasses instead of enum variants.
"""

from __future__ import annotations


class QoaError(Exception):
    """Base class for all qoaudio_tpu_torch errors."""


class DecodeError(QoaError):
    """Base class for decoding errors."""


class NotQoaFile(DecodeError):
    def __init__(self, msg: str = "File is not a qoa file"):
        super().__init__(msg)


class NoSamples(DecodeError):
    def __init__(self, msg: str = "File has no samples"):
        super().__init__(msg)


class InvalidFrameHeader(DecodeError):
    def __init__(self, msg: str = "File has invalid frame header"):
        super().__init__(msg)


class IncompatibleFrame(DecodeError):
    def __init__(self, msg: str = "Incompatible frame header"):
        super().__init__(msg)


class EncodeError(QoaError):
    """Base class for encoding errors."""


class InvalidChannels(EncodeError):
    def __init__(self, msg: str = "Invalid number of channels (must be 1-8)"):
        super().__init__(msg)


class InvalidSampleRate(EncodeError):
    def __init__(self, msg: str = "Invalid sample rate (must be > 0)"):
        super().__init__(msg)


class InvalidSamples(EncodeError):
    def __init__(self, msg: str = "Invalid number of samples (must be > 0)"):
        super().__init__(msg)


class IoError(DecodeError, EncodeError, OSError):
    """I/O failure (truncated stream, unreadable file, ...).

    Participates in both the decode and encode hierarchies, mirroring the
    reference's ``DecodeError::IoError`` / ``EncodeError::IoError`` variants,
    and in OSError for Python idiom.
    """

    def __init__(self, msg: str = "IO error"):
        super().__init__(msg)
