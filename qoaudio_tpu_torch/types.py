"""Public data types, mirroring the reference API surface.

A copy of ``qoaudio_tpu/types.py``; equality compares within one
package's classes only.

Reference: ``QoaDesc`` (src/lib.rs:93-102), ``FrameHeader``
(src/lib.rs:772-781), ``ProcessingMode`` (src/lib.rs:31-45), ``QoaItem``
(src/lib.rs:654-659), ``DecodedQoa`` (src/lib.rs:695-704).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class QoaDesc:
    """Stream properties for encoding."""

    channels: int
    sample_rate: int
    samples: int  # samples per channel


@dataclasses.dataclass(frozen=True)
class FrameHeader:
    """Metadata at the start of each frame."""

    num_channels: int
    sample_rate: int
    num_samples_per_channel: int


@dataclasses.dataclass(frozen=True)
class FixedSamples:
    """Fixed mode: totals known; channels/rate constant across the file."""

    channels: int
    sample_rate: int
    samples: int


class Streaming:
    """Streaming mode: totals unknown; channels/rate may change per frame."""

    _instance: Optional["Streaming"] = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "Streaming()"

    def __eq__(self, other):
        return isinstance(other, Streaming)

    def __hash__(self):
        return hash(Streaming)


ProcessingMode = Union[FixedSamples, Streaming]


@dataclasses.dataclass
class DecodedQoa:
    """A fully decoded QOA stream."""

    num_channels: int
    sample_rate: int
    samples: np.ndarray  # int16, interleaved (L R L R ... for stereo)

    @property
    def samples_per_channel(self) -> int:
        return len(self.samples) // self.num_channels

    @property
    def duration_seconds(self) -> float:
        return self.samples_per_channel / self.sample_rate


# QoaItem variants for the streaming decoder iterator: a plain int sample
# or a FrameHeader.  Python idiom: the iterator yields `int` for samples
# and `FrameHeader` objects at frame starts (cf. QoaItem, src/lib.rs:654).
QoaItem = Union[int, FrameHeader]
