"""QOA stream layout: assembly and parse, plain NumPy.

A stream is big-endian 64-bit words: the file header (``qoaf`` and the
samples per channel), then per frame a header word (channels, rate,
samples per channel, frame bytes), per channel one word of LMS history and
one of LMS weights (4 x i16 each), and per 20-sample window one slice word
per channel.  Every frame holds 5,120 samples per channel but the last.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .tables import FRAME_LEN, MAGIC, SLICE_LEN, SLICES_PER_FRAME

_SHIFTS = np.array([48, 32, 16, 0], np.uint64)


@dataclasses.dataclass(frozen=True)
class Geometry:
    frames: int
    spf: np.ndarray  # samples per channel of each frame
    windows: np.ndarray  # slice windows of each frame
    starts: np.ndarray  # first word of each frame, and the end
    channels: int

    @property
    def words(self) -> int:
        return int(self.starts[-1])


def geometry(samples: int, channels: int) -> Geometry:
    frames = -(-samples // FRAME_LEN)
    spf = np.full(frames, FRAME_LEN, np.int64)
    spf[-1] = samples - (frames - 1) * FRAME_LEN
    windows = -(-spf // SLICE_LEN)
    sizes = 1 + 2 * channels + windows * channels
    starts = np.concatenate([[1], 1 + np.cumsum(sizes)])
    return Geometry(frames, spf, windows, starts, channels)


def pack_lms(vals: np.ndarray) -> np.ndarray:
    """int[..., 4] -> u64 words, each value truncated to 16 bits."""
    u16 = (np.asarray(vals).astype(np.int64) & 0xFFFF).astype(np.uint64)
    return np.bitwise_or.reduce(u16 << _SHIFTS, axis=-1)


def unpack_lms(words: np.ndarray) -> np.ndarray:
    """u64 words -> int32[..., 4], each 16-bit value sign-extended."""
    v = (np.asarray(words, np.uint64)[..., None] >> _SHIFTS) & np.uint64(0xFFFF)
    return v.astype(np.uint16).astype(np.int16).astype(np.int32)


def _frame_headers(g: Geometry, rate: int) -> np.ndarray:
    fbytes = 8 * (g.starts[1:] - g.starts[:-1])
    return ((np.uint64(g.channels) << np.uint64(56))
            | (np.uint64(rate) << np.uint64(32))
            | (g.spf.astype(np.uint64) << np.uint64(16))
            | fbytes.astype(np.uint64))


def assemble(channels: int, rate: int, samples: int, states: np.ndarray,
             words: np.ndarray) -> bytes:
    """One stream's bytes.  states: (F, C, 8) int, the LMS at each frame's
    start (history, then weights); words: (F, 256, C) u64 slice words."""
    g = geometry(samples, channels)
    C, F = channels, g.frames
    out = np.empty(g.words, np.uint64)
    out[0] = (np.uint64(int.from_bytes(MAGIC, "big")) << np.uint64(32)) | np.uint64(samples)
    lms = np.empty((F, 2 * C), np.uint64)
    lms[:, 0::2] = pack_lms(states[:F, :, 0:4])
    lms[:, 1::2] = pack_lms(states[:F, :, 4:8])
    heads = _frame_headers(g, rate)
    full = 1 + 2 * C + SLICES_PER_FRAME * C
    if F > 1:
        body = out[1 : g.starts[F - 1]].reshape(F - 1, full)
        body[:, 0] = heads[:-1]
        body[:, 1 : 1 + 2 * C] = lms[:-1]
        body[:, 1 + 2 * C :] = np.asarray(words[: F - 1], np.uint64).reshape(F - 1, -1)
    last = out[g.starts[F - 1] :]
    last[0] = heads[-1]
    last[1 : 1 + 2 * C] = lms[-1]
    last[1 + 2 * C :] = np.asarray(words[F - 1, : g.windows[-1]], np.uint64).reshape(-1)
    return out.astype(">u8").tobytes()


@dataclasses.dataclass
class Parsed:
    channels: int
    rate: int
    samples: int
    heads: np.ndarray  # (F,) u64 frame header words
    states: np.ndarray  # (F, C, 8) int32 LMS at each frame start
    words: np.ndarray  # (F, 256, C) u64 slice words; zero past each frame's windows
    geometry: Geometry


def parse(data: bytes, channels: Optional[int] = None,
          samples: Optional[int] = None) -> Optional[Parsed]:
    """The frames of a stream laid out for ``samples`` per channel of
    ``channels`` (default: as its own headers say).  None when the bytes
    cannot hold that layout.  Frame headers are returned, not judged."""
    if len(data) % 8 or len(data) < 16:
        return None
    w = np.frombuffer(data, ">u8").astype(np.uint64)
    if int(w[0] >> np.uint64(32)) != int.from_bytes(MAGIC, "big"):
        return None
    if samples is None:
        samples = int(w[0] & np.uint64(0xFFFFFFFF))
    if channels is None:
        channels = int(w[1] >> np.uint64(56))
    if samples < 1 or channels < 1:
        return None
    g = geometry(samples, channels)
    if g.words != len(w):
        return None
    C, F = channels, g.frames
    full = 1 + 2 * C + SLICES_PER_FRAME * C
    heads = np.empty(F, np.uint64)
    lms = np.empty((F, 2 * C), np.uint64)
    words = np.zeros((F, SLICES_PER_FRAME, C), np.uint64)
    if F > 1:
        body = w[1 : g.starts[F - 1]].reshape(F - 1, full)
        heads[:-1] = body[:, 0]
        lms[:-1] = body[:, 1 : 1 + 2 * C]
        words[:-1] = body[:, 1 + 2 * C :].reshape(F - 1, SLICES_PER_FRAME, C)
    last = w[g.starts[F - 1] :]
    heads[-1] = last[0]
    lms[-1] = last[1 : 1 + 2 * C]
    words[-1, : g.windows[-1]] = last[1 + 2 * C :].reshape(-1, C)
    states = np.concatenate([unpack_lms(lms[:, 0::2]), unpack_lms(lms[:, 1::2])], axis=-1)
    rate = int((heads[0] >> np.uint64(32)) & np.uint64(0xFFFFFF))
    return Parsed(C, rate, samples, heads, states, words, g)


def headers_valid(p: Parsed) -> bool:
    """Every frame header says what the layout needs."""
    return bool((p.heads == _frame_headers(p.geometry, p.rate)).all())
