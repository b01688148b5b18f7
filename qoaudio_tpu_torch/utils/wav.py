"""WAV read/write helpers (stdlib ``wave``; analog of the reference's
optional ``hound`` integration used by examples/encode.rs and decode.rs).

A copy of ``qoaudio_tpu/utils/wav.py``.
"""

from __future__ import annotations

import wave

import numpy as np


def read_wav(path) -> tuple[np.ndarray, int, int]:
    """Read a 16-bit PCM WAV file -> (interleaved int16, channels, rate).

    Mirrors the validation in examples/encode.rs (16-bit
    integer PCM only).
    """
    with wave.open(str(path), "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError("only 16-bit PCM WAV files are supported")
        channels = w.getnchannels()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    pcm = np.frombuffer(raw, dtype="<i2").astype(np.int16)
    return pcm, channels, rate


def write_wav(path, samples: np.ndarray, channels: int, sample_rate: int) -> None:
    """Write interleaved int16 samples to a 16-bit PCM WAV file."""
    samples = np.asarray(samples, dtype=np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(samples.astype("<i2").tobytes())
