"""Playback source adapter: ``qoaudio_tpu.source.QoaPcmSource``.

The source only reads from the decoder it is given (``next_frame`` and the
frame headers), so it serves the port's ``QoaDecoder`` unchanged.
"""

from qoaudio_tpu.source import QoaPcmSource  # noqa: F401

__all__ = ["QoaPcmSource"]
