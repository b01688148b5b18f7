"""Host-side bitstream framing: byte parsing/building of QOA streams.

A copy of ``qoaudio_tpu/bitstream.py``; its native fast paths are the
port's own engine (``qoaudio_tpu_torch.native``).

This layer turns raw QOA bytes into dense numpy arrays shaped for the device
kernels (and back).  It mirrors the reference decoder's *exact* traversal
semantics (src/lib.rs:205-330):

* frame advance is driven by the frame header's ``samples_per_channel``
  (``ceil(n/20)`` slice windows are consumed), *not* by ``frame_size``;
* ``frame_size`` is used only for validation;
* a clean EOF at a frame-header boundary ends the stream; EOF anywhere else
  is an IoError;
* in fixed mode, channel-count / sample-rate changes after the first frame
  raise IncompatibleFrame (src/lib.rs:246-259).

All multi-byte values are big-endian.  Vectorized with numpy uint64; a native
C++ fast path can be swapped in transparently (see native/).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np

from . import format as fmt
from .errors import (
    IncompatibleFrame,
    InvalidFrameHeader,
    IoError,
)

_CODE_SHIFTS = (57 - 3 * np.arange(fmt.QOA_SLICE_LEN, dtype=np.uint64)).astype(
    np.uint64
)
_LMS_SHIFTS = (48 - 16 * np.arange(4, dtype=np.uint64)).astype(np.uint64)


# ---------------------------------------------------------------------------
# Slice word pack / unpack  (reference: src/lib.rs:303-315, 468-491)
# ---------------------------------------------------------------------------

def unpack_slices(words: np.ndarray):
    """uint64 slice words -> (scalefactor uint8, codes uint8[..., 20]).

    ``codes[..., k]`` is the 3-bit residual code of sample k (MSB-first
    layout: code k lives at bits [57-3k, 59-3k]).
    """
    words = np.asarray(words, dtype=np.uint64)
    sf = (words >> np.uint64(60)).astype(np.uint8)
    codes = ((words[..., None] >> _CODE_SHIFTS) & np.uint64(7)).astype(
        np.uint8
    )
    return sf, codes


def pack_slices(sf: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """(scalefactor, codes[..., 20]) -> uint64 slice words.

    Codes past a short slice's length must already be zero; that reproduces
    the reference's left-shift of short final slices (src/lib.rs:484-487).
    """
    sf = np.asarray(sf, dtype=np.uint64)
    codes = np.asarray(codes, dtype=np.uint64)
    words = sf << np.uint64(60)
    words = words | np.bitwise_or.reduce(codes << _CODE_SHIFTS, axis=-1)
    return words


# ---------------------------------------------------------------------------
# LMS state pack / unpack  (reference: src/lib.rs:270-281, 455-466)
# ---------------------------------------------------------------------------

def unpack_lms(words: np.ndarray) -> np.ndarray:
    """uint64 history/weight words -> int32[..., 4] (sign-extended i16)."""
    words = np.asarray(words, dtype=np.uint64)
    vals = ((words[..., None] >> _LMS_SHIFTS) & np.uint64(0xFFFF)).astype(
        np.uint16
    )
    return vals.astype(np.int16).astype(np.int32)


def pack_lms(vals: np.ndarray) -> np.ndarray:
    """int32[..., 4] -> uint64 words (truncating each entry to 16 bits).

    The truncation (not saturation) of out-of-i16-range weights mirrors the
    reference's ``as u16`` cast at src/lib.rs:459-460.
    """
    vals = np.asarray(vals)
    u16 = (vals.astype(np.int64) & 0xFFFF).astype(np.uint64)
    return np.bitwise_or.reduce(u16 << _LMS_SHIFTS, axis=-1)


# ---------------------------------------------------------------------------
# Frame parsing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FrameRecord:
    """One parsed frame, as numpy arrays ready for kernel assembly."""

    channels: int
    sample_rate: int
    samples_per_channel: int
    frame_size: int  # declared size (validation only)
    lms_history: np.ndarray  # int32 (channels, 4)
    lms_weights: np.ndarray  # int32 (channels, 4)
    slice_words: np.ndarray  # uint64 (n_windows, channels)

    @property
    def n_windows(self) -> int:
        return self.slice_words.shape[0]


def _validate_frame_header(channels, sample_rate, frame_size):
    if channels == 0 or sample_rate == 0:
        raise InvalidFrameHeader()
    non_sample = fmt.QOA_HEADER_SIZE + fmt.QOA_LMS_LEN * 4 * channels
    if frame_size <= non_sample:
        raise InvalidFrameHeader()
    num_slices = (frame_size - non_sample) // 8
    if num_slices % channels != 0:
        raise InvalidFrameHeader()
    if num_slices // channels > fmt.MAX_SLICES_PER_CHANNEL_PER_FRAME:
        raise InvalidFrameHeader()


def parse_frame(data: bytes, offset: int) -> Optional[tuple]:
    """Parse one frame at ``offset``.

    Returns ``(FrameRecord, next_offset)`` or None on clean EOF (no bytes
    left at the header boundary).  Raises on truncation or invalid headers.
    """
    n = len(data)
    if offset + 8 > n:
        # EOF (even a PARTIAL header word) at the frame boundary is a clean
        # end of stream: the reference maps UnexpectedEof on the header
        # read to Ok(false) (src/lib.rs:205-215)
        return None
    word = int.from_bytes(data[offset : offset + 8], "big")
    channels, sample_rate, samples_per_channel, frame_size = (
        fmt.unpack_frame_header(word)
    )
    _validate_frame_header(channels, sample_rate, frame_size)

    pos = offset + 8
    lms_bytes = fmt.QOA_LMS_STATE_BYTES * channels
    if pos + lms_bytes > n:
        raise IoError("unexpected EOF reading LMS state")
    lms_words = np.frombuffer(data, dtype=">u8", count=2 * channels, offset=pos)
    lms_words = lms_words.astype(np.uint64).reshape(channels, 2)
    history = unpack_lms(lms_words[:, 0])
    weights = unpack_lms(lms_words[:, 1])
    pos += lms_bytes

    n_windows = -(-samples_per_channel // fmt.QOA_SLICE_LEN)
    n_words = n_windows * channels
    if pos + 8 * n_words > n:
        raise IoError("unexpected EOF reading slice data")
    words = np.frombuffer(data, dtype=">u8", count=n_words, offset=pos)
    words = words.astype(np.uint64).reshape(n_windows, channels)
    pos += 8 * n_words

    rec = FrameRecord(
        channels=channels,
        sample_rate=sample_rate,
        samples_per_channel=samples_per_channel,
        frame_size=frame_size,
        lms_history=history,
        lms_weights=weights,
        slice_words=words,
    )
    return rec, pos


def iter_frames(data: bytes, offset: int = fmt.QOA_HEADER_SIZE) -> Iterator[FrameRecord]:
    while True:
        out = parse_frame(data, offset)
        if out is None:
            return
        rec, offset = out
        yield rec


@dataclasses.dataclass
class ParsedQoa:
    """A fully parsed QOA byte stream."""

    total_samples: int  # from the file header; 0 => streaming mode
    frames: List[FrameRecord]

    @property
    def streaming(self) -> bool:
        return self.total_samples == 0


def parse_file(data: bytes) -> ParsedQoa:
    """Parse a whole QOA stream (file header + all frames).

    In fixed mode (total_samples != 0), enforces constant channels/rate
    across frames like the streaming decoder does (src/lib.rs:246-259).
    """
    total_samples = fmt.unpack_file_header(data)
    frames: List[FrameRecord] = []
    for rec in iter_frames(data):
        if total_samples != 0 and frames:
            if (
                rec.channels != frames[0].channels
                or rec.sample_rate != frames[0].sample_rate
            ):
                raise IncompatibleFrame()
        frames.append(rec)
    return ParsedQoa(total_samples=total_samples, frames=frames)


# ---------------------------------------------------------------------------
# Fast whole-file parse (fixed-layout streams)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ParsedArrays:
    """Dense whole-file parse: arrays shaped for the chain-vector kernels.

    Chain n = frame f * channels + channel c.  ``words_be`` holds the RAW
    big-endian u64 slice words (consumers byteswap or ``.astype`` as
    needed); rows past a short final frame's windows are zero.
    """

    total_samples: int
    channels: int
    sample_rate: int
    samples_per_frame: np.ndarray  # int64 (F,)
    words_be: np.ndarray  # uint64 (W, F*C) raw big-endian
    state: np.ndarray  # int32 (8, F*C) frame-start LMS

    @property
    def n_frames(self) -> int:
        return len(self.samples_per_frame)

    @property
    def max_windows(self) -> int:
        return self.words_be.shape[0]

    @property
    def first_frame_samples(self) -> int:
        return int(self.samples_per_frame[0])


@dataclasses.dataclass
class FileGeometry:
    """Validated geometry of a fixed-mode uniform-frame stream.

    The probe half of :func:`parse_file_arrays`: everything needed to
    gather the words and LMS straight from ``data`` on the device
    (``ops/gather.py``) without the chain-array gather on the host.
    """

    total_samples: int
    channels: int
    sample_rate: int
    spc0: int          # samples/channel of every full frame
    frame_bytes: int   # byte size of every full frame
    W0: int            # slice windows per full frame
    F_full: int        # number of full frames
    tail: Optional[FrameRecord]  # short final frame, if any

    # what ``parse_file_arrays`` would give, read from the headers alone
    @property
    def n_frames(self) -> int:
        return self.F_full + (self.tail is not None)

    @property
    def max_windows(self) -> int:
        return self.W0

    @property
    def frame_samples(self) -> int:
        """Samples a channel over all frame headers (``samples_per_frame``
        summed, not the file header's count)."""
        tail = 0 if self.tail is None else self.tail.samples_per_channel
        return self.F_full * self.spc0 + tail

    @property
    def first_frame_samples(self) -> int:
        return self.spc0


def parse_file_geometry(data: bytes) -> Optional[FileGeometry]:
    """Validate a fixed-mode uniform-frame stream WITHOUT gathering.

    Exploits the format's arithmetic layout (every non-final frame is
    byte-identical in geometry, src/lib.rs:602-604): one
    ``np.frombuffer`` + reshape covers all full frames' header words;
    only the final short frame (if any) is parsed individually.  Returns
    None when the stream is not uniform (streaming mode, mid-stream
    format change, or corrupt) — callers fall back to ``parse_file``.
    """
    n = len(data)
    if n < fmt.QOA_HEADER_SIZE + 8:
        return None
    try:
        total_samples = fmt.unpack_file_header(data)
    except Exception:
        return None
    if total_samples == 0:
        return None  # streaming mode: frames may differ; use parse_file

    hdr0 = int.from_bytes(data[8:16], "big")
    channels, rate, spc0, fsize0 = fmt.unpack_frame_header(hdr0)
    try:
        _validate_frame_header(channels, rate, fsize0)
    except Exception:
        return None
    W0 = -(-spc0 // fmt.QOA_SLICE_LEN)
    frame_bytes = fmt.qoa_frame_size(channels, W0)
    if fsize0 != frame_bytes:
        return None
    frame_words = frame_bytes // 8

    body = n - fmt.QOA_HEADER_SIZE
    F_full = body // frame_bytes
    tail_bytes = body - F_full * frame_bytes
    if F_full == 0:
        return None

    hdrs = np.frombuffer(
        data, dtype=">u8", count=F_full * frame_words, offset=fmt.QOA_HEADER_SIZE
    ).reshape(F_full, frame_words)[:, 0]

    # all full frames must share the exact header word (same geometry); a
    # last frame whose size is a full frame's but whose samples are fewer
    # (5,101-5,119 of 5,120: 256 windows all the same) is the tail
    if not bool((hdrs[:-1] == hdrs[0]).all()):
        return None
    if hdrs[-1] != hdrs[0]:
        if tail_bytes:
            return None
        F_full -= 1
        tail_bytes = frame_bytes

    # final short frame, if any
    tail = None
    if tail_bytes:
        try:
            out = parse_frame(data, fmt.QOA_HEADER_SIZE + F_full * frame_bytes)
        except Exception:
            return None  # corrupt/truncated tail: the general walk reports it
        if out is None:
            return None
        tail, end = out
        if end != n or tail.channels != channels or tail.sample_rate != rate:
            return None
        if tail.n_windows > W0 or tail.samples_per_channel > spc0:
            # a tail LONGER than the uniform frames (in windows OR samples)
            # breaks the uniform-stride indexing downstream callers assume
            # (decode_range, seek): general walk
            return None
        if tail_bytes == frame_bytes and tail.samples_per_channel == spc0:
            return None  # a full frame whose header differs in its size field

    return FileGeometry(
        total_samples=total_samples,
        channels=channels,
        sample_rate=rate,
        spc0=spc0,
        frame_bytes=frame_bytes,
        W0=W0,
        F_full=F_full,
        tail=tail,
    )


def parse_file_arrays(data: bytes) -> Optional[ParsedArrays]:
    """Vectorized parse of a fixed-mode uniform-frame QOA stream.

    The geometry probe (:func:`parse_file_geometry`) plus the chain-array
    gather.  Returns None when the stream is not uniform — callers fall
    back to the general ``parse_file`` walk.
    """
    geo = parse_file_geometry(data)
    if geo is None:
        return None
    total_samples = geo.total_samples
    channels, rate = geo.channels, geo.sample_rate
    spc0, frame_bytes, W0 = geo.spc0, geo.frame_bytes, geo.W0
    F_full, tail = geo.F_full, geo.tail
    frame_words = frame_bytes // 8
    words8 = np.frombuffer(
        data, dtype=">u8", count=F_full * frame_words, offset=fmt.QOA_HEADER_SIZE
    ).reshape(F_full, frame_words)

    F = F_full + (1 if tail is not None else 0)
    C = channels
    N = F * C
    W = W0

    from . import native

    if native.available():
        # one native pass: strided gather of slice words + LMS sign-extend
        words_be, state = native.gather_frames(
            data, fmt.QOA_HEADER_SIZE, F_full, frame_bytes, C, W0, W, N
        )
    else:
        # LMS state: (F_full, C, 2) u64 -> (8, N)
        lms = words8[:, 1 : 1 + 2 * C].astype(np.uint64).reshape(F_full, C, 2)
        history = unpack_lms(lms[:, :, 0])  # (F_full, C, 4)
        weights = unpack_lms(lms[:, :, 1])
        state = np.zeros((8, N), dtype=np.int32)
        state[0:4, : F_full * C] = history.reshape(F_full * C, 4).T
        state[4:8, : F_full * C] = weights.reshape(F_full * C, 4).T

        # slice words: raw big-endian bytes, (F_full, W, C) -> (W, F*C)
        words_be = np.zeros((W, N), dtype=np.uint64)
        full = np.ascontiguousarray(
            words8[:, 1 + 2 * C :].reshape(F_full, W, C).transpose(1, 0, 2)
        ).view(np.uint64).reshape(W, F_full * C)
        words_be[:, : F_full * C] = full

    spf = np.full(F, spc0, dtype=np.int64)
    if tail is not None:
        state[0:4, F_full * C :] = tail.lms_history.T
        state[4:8, F_full * C :] = tail.lms_weights.T
        # tail.slice_words are logical u64; store raw big-endian
        tw = tail.slice_words.astype(">u8").view(np.uint64)
        words_be[: tail.n_windows, F_full * C :] = tw
        spf[-1] = tail.samples_per_channel

    return ParsedArrays(
        total_samples=total_samples,
        channels=C,
        sample_rate=rate,
        samples_per_frame=spf,
        words_be=words_be,
        state=state,
    )


# ---------------------------------------------------------------------------
# Frame building (encoder side)
# ---------------------------------------------------------------------------

def build_frame_bytes(
    channels: int,
    sample_rate: int,
    samples_per_channel: int,
    lms_history: np.ndarray,
    lms_weights: np.ndarray,
    slice_words: np.ndarray,
) -> bytes:
    """Assemble one frame's bytes from packed slice words + LMS snapshot."""
    n_windows = slice_words.shape[0]
    frame_size = fmt.qoa_frame_size(channels, n_windows)
    header = fmt.pack_frame_header(
        channels, sample_rate, samples_per_channel, frame_size
    )
    parts = [header.to_bytes(8, "big")]
    hist_words = pack_lms(lms_history)  # (channels,)
    wt_words = pack_lms(lms_weights)
    lms_inter = np.empty(2 * channels, dtype=np.uint64)
    lms_inter[0::2] = hist_words
    lms_inter[1::2] = wt_words
    parts.append(lms_inter.astype(">u8").tobytes())
    parts.append(
        np.ascontiguousarray(slice_words, dtype=np.uint64)
        .astype(">u8")
        .tobytes()
    )
    return b"".join(parts)


def assemble_stream_bytes(
    channels: int,
    sample_rate: int,
    samples: int,
    snaps: np.ndarray,
    words: np.ndarray,
) -> bytes:
    """Vectorized whole-stream byte assembly from encoder kernel outputs.

    For standard framing (every frame 5120 samples/channel except possibly
    the last), all-but-last frames are byte-identical in geometry, so the
    whole stream assembles as ONE dense uint64 blob dumped big-endian —
    no per-frame Python loop (which dominates batched transcode epilogues).

    snaps: (>=F, 8, C) int32 — frame-start LMS (history rows 0-3, weights
    rows 4-7); words: (>=F, >=nw, C) uint64 logical slice words.
    """
    if samples <= 0:
        from .errors import InvalidSamples

        raise InvalidSamples()
    C = channels
    T = samples
    F = -(-T // fmt.QOA_FRAME_LEN)
    spf = np.full(F, fmt.QOA_FRAME_LEN, np.int64)
    spf[-1] = T - (F - 1) * fmt.QOA_FRAME_LEN
    nw = -(-spf // fmt.QOA_SLICE_LEN)
    Wf = int(nw.max())
    fsize = fmt.qoa_frame_size(C, nw)  # elementwise over the frame axis
    headers = (
        (np.uint64(C) << np.uint64(56))
        | (np.uint64(sample_rate) << np.uint64(32))
        | (spf.astype(np.uint64) << np.uint64(16))
        | fsize.astype(np.uint64)
    )
    hist_words = pack_lms(snaps[:F, 0:4].transpose(0, 2, 1))  # (F, C)
    wt_words = pack_lms(snaps[:F, 4:8].transpose(0, 2, 1))
    lms_inter = np.empty((F, 2 * C), np.uint64)
    lms_inter[:, 0::2] = hist_words
    lms_inter[:, 1::2] = wt_words

    frame_words = 1 + 2 * C + Wf * C
    blob = np.empty((F, frame_words), np.uint64)
    blob[:, 0] = headers
    blob[:, 1 : 1 + 2 * C] = lms_inter
    blob[:, 1 + 2 * C :] = np.ascontiguousarray(words[:F, :Wf]).reshape(F, Wf * C)

    out = [fmt.pack_file_header(T)]
    if F > 1:
        out.append(blob[:-1].astype(">u8").tobytes())
    out.append(blob[-1, : 1 + 2 * C + int(nw[-1]) * C].astype(">u8").tobytes())
    return b"".join(out)


# ---------------------------------------------------------------------------
# Dense assembly for batched kernels
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FrameBatch:
    """Frames of one fixed-mode stream, stacked and padded for the decoder
    kernel.

    Shapes (F = n frames, W = max windows per frame, C = channels):
      * sf:      uint8  (F, W, C)
      * codes:   uint8  (F, W, C, 20)
      * history: int32  (F, C, 4)
      * weights: int32  (F, C, 4)
      * samples_per_frame: int64 (F,)  — true samples/channel per frame
    """

    channels: int
    sample_rate: int
    sf: np.ndarray
    codes: np.ndarray
    history: np.ndarray
    weights: np.ndarray
    samples_per_frame: np.ndarray

    @property
    def n_frames(self) -> int:
        return self.sf.shape[0]

    @property
    def max_windows(self) -> int:
        return self.sf.shape[1]


def batch_chain_arrays(batch: "FrameBatch"):
    """FrameBatch -> chain-vector arrays for the native/Pallas kernels.

    Returns (words_be (W, F*C) uint64 RAW BIG-ENDIAN slice words,
    state (8, F*C) int32 frame-start LMS); chain n = frame*channels+ch.
    """
    F, W, C = batch.sf.shape
    logical = pack_slices(
        batch.sf.astype(np.uint64), batch.codes.astype(np.uint64)
    )  # (F, W, C)
    words_be = (
        logical.transpose(1, 0, 2)
        .astype(">u8", order="C")  # one copy: relayout + byteswap together
        .view(np.uint64)
        .reshape(W, F * C)
    )
    state = np.empty((8, F * C), np.int32)
    state[0:4] = batch.history.reshape(F * C, 4).T
    state[4:8] = batch.weights.reshape(F * C, 4).T
    return words_be, state


def stack_frames(frames: List[FrameRecord]) -> FrameBatch:
    if not frames:
        raise ValueError("no frames to stack")
    channels = frames[0].channels
    rate = frames[0].sample_rate
    if any(f.channels != channels or f.sample_rate != rate for f in frames):
        raise IncompatibleFrame()
    F = len(frames)
    W = max(f.n_windows for f in frames)
    sf = np.zeros((F, W, channels), dtype=np.uint8)
    codes = np.zeros((F, W, channels, fmt.QOA_SLICE_LEN), dtype=np.uint8)
    history = np.zeros((F, channels, 4), dtype=np.int32)
    weights = np.zeros((F, channels, 4), dtype=np.int32)
    spf = np.zeros(F, dtype=np.int64)
    for i, f in enumerate(frames):
        s, c = unpack_slices(f.slice_words)
        sf[i, : f.n_windows] = s
        codes[i, : f.n_windows] = c
        history[i] = f.lms_history
        weights[i] = f.lms_weights
        spf[i] = f.samples_per_channel
    return FrameBatch(
        channels=channels,
        sample_rate=rate,
        sf=sf,
        codes=codes,
        history=history,
        weights=weights,
        samples_per_frame=spf,
    )
