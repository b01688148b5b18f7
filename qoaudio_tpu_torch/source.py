"""Playback source adapter (analog of the reference's rodio integration).

A copy of ``qoaudio_tpu/source.py`` over the port's own ``QoaDecoder``.

Reference: ``QoaRodioSource`` (src/lib.rs:914-989) wraps a
decoder as an ``Iterator<Item = i16>`` whose ``channels()`` /
``sample_rate()`` always describe the *next* sample to be returned — it
prefetches the next frame header at frame boundaries so mid-stream format
changes (streaming mode) are visible to the audio sink at the right moment
(src/lib.rs:941-954).

``QoaPcmSource`` provides the same contract for Python audio sinks
(sounddevice/pyaudio/wave writers): iterate i16 samples, query
``channels`` / ``sample_rate`` / ``current_frame_len`` / ``total_duration``
at any point.  Errors end iteration, like the reference (a failed
frame-boundary prefetch drops the already-decoded sample, exactly as the
reference's ``?`` at src/lib.rs:951 returns None).  Bulk ``read`` stops at
format changes so every returned block is single-format.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .streaming import QoaDecoder
from .types import Streaming


class QoaPcmSource:
    """Iterator of i16 samples over a :class:`QoaDecoder`."""

    def __init__(self, decoder: QoaDecoder):
        self._decoder = decoder
        self._buffer: Optional[np.ndarray] = None
        self._idx = 0
        self._next_frame = None  # prefetched (header, samples)
        self._finished = False
        # format of the block the last read() returned (0, 0 before any
        # read / after an empty one).  NOT the same as channels/
        # sample_rate: when a read stops AT a format boundary the next
        # frame is already staged, so those describe the NEXT block.
        self.block_channels = 0
        self.block_sample_rate = 0

    # -- source metadata ---------------------------------------------------

    @property
    def channels(self) -> int:
        return self._decoder.current_frame_header().num_channels

    @property
    def sample_rate(self) -> int:
        return self._decoder.current_frame_header().sample_rate

    def current_frame_len(self) -> Optional[int]:
        """Interleaved samples remaining in the current frame (streaming
        mode only; None in fixed mode — src/lib.rs:966-975).  After a
        frame-boundary prefetch this is the PREFETCHED frame's full count,
        because channels/sample_rate already describe that frame."""
        if not isinstance(self._decoder.mode(), Streaming):
            return None
        remaining = (
            0 if self._buffer is None else max(len(self._buffer) - self._idx, 0)
        )
        if remaining == 0 and self._next_frame is not None:
            return len(self._next_frame[1])
        return remaining

    def total_duration(self) -> Optional[float]:
        return self._decoder.total_duration()

    # -- iteration ---------------------------------------------------------

    def __iter__(self) -> "QoaPcmSource":
        return self

    def _pull_frame(self) -> bool:
        """Stage the next frame's samples; False at end or on error."""
        try:
            if self._next_frame is not None:
                frame, self._next_frame = self._next_frame, None
            else:
                frame = self._decoder.next_frame()
        except Exception:
            return False  # errors stop iteration (src/lib.rs:951,958)
        if frame is None:
            return False
        _, samples = frame
        self._buffer = samples
        self._idx = 0
        return True

    def __next__(self) -> int:
        if self._finished:
            raise StopIteration
        while self._buffer is None or self._idx >= len(self._buffer):
            self._buffer = None
            if not self._pull_frame():
                self._finished = True
                raise StopIteration
        if self._idx == len(self._buffer) - 1:
            # last sample of the frame: prefetch the next header FIRST so
            # channels/sample_rate describe the next sample — and so a
            # prefetch error drops this sample and ends iteration, exactly
            # like the reference's `?` (src/lib.rs:941-954)
            try:
                self._next_frame = self._decoder.next_frame()
            except Exception:
                self._next_frame = None
                self._finished = True
                raise StopIteration
        s = int(self._buffer[self._idx])
        self._idx += 1
        return s

    # -- bulk --------------------------------------------------------------

    def read(self, n: Optional[int] = None) -> np.ndarray:
        """Read up to n interleaved samples (all remaining if None).

        Stops early at a mid-stream format change (streaming mode), so a
        returned block is always single-format — described by
        ``block_channels`` / ``block_sample_rate``.  (``channels`` /
        ``sample_rate`` can differ right after a read that stopped AT a
        boundary: they describe the next, already-staged frame.)  The
        next ``read`` starts the new format.
        """
        chunks = []
        got = 0
        fmt0 = None
        while n is None or got < n:
            if self._buffer is None or self._idx >= len(self._buffer):
                self._buffer = None
                if not self._pull_frame():
                    self._finished = True
                    break
                hdr = self._decoder.current_frame_header()
                if fmt0 is None:
                    fmt0 = (hdr.num_channels, hdr.sample_rate)
                elif (hdr.num_channels, hdr.sample_rate) != fmt0:
                    # format change: leave the staged frame for the next
                    # read; metadata already describes it
                    break
            elif fmt0 is None:
                hdr = self._decoder.current_frame_header()
                fmt0 = (hdr.num_channels, hdr.sample_rate)
            take = len(self._buffer) - self._idx
            if n is not None:
                take = min(take, n - got)
            chunks.append(self._buffer[self._idx : self._idx + take])
            self._idx += take
            got += take
        if chunks:
            self.block_channels, self.block_sample_rate = fmt0
            return np.concatenate(chunks)
        self.block_channels = self.block_sample_rate = 0
        return np.empty(0, dtype=np.int16)
