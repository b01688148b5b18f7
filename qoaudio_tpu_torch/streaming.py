"""Streaming codec objects of the port: ``QoaDecoder`` and ``QoaEncoder``.

Port of ``qoaudio_tpu/streaming.py`` (API parity with the reference's L3
layer: ``QoaDecoder`` src/lib.rs:59-331,619-693, ``QoaEncoder``
src/lib.rs:85-493), whole classes with a ``"torch"`` backend in place of
the JAX device backend; a ``device`` names where it runs (a CUDA device
launches the kernels, ``"cpu"`` runs their plain versions).

* ``QoaDecoder``: backends ``"auto"`` (native, else numpy), ``"native"``,
  ``"numpy"``, ``"torch"``.  Whole frames decode in one vectorized call
  (``readahead`` frames per batch); on ``"torch"`` each batch decodes in
  one launch, on the prefetch worker thread when prefetch is on.  Iterator
  semantics are the reference's, including the quirk that a
  streaming-mode decoder yields an initial default ``FrameHeader(0, 0, 0)``
  before the first real frame (src/lib.rs:674-678).  Beyond parity:
  ``seek_to_frame`` gives O(1) random access on fixed-mode streams.
* ``QoaEncoder``: backends ``"auto"`` (native, else ``"torch"`` on
  ``device``), ``"native"``, ``"numpy"``, ``"torch"``.  On ``"torch"``,
  ``encode_frame`` encodes one frame from the carried LMS state (a full
  frame on the full-window kernel, a short one on the masked kernel over
  only its windows), and ``encode`` encodes the whole input in one chunked
  call from the current state: 64 frames per launch, not one per frame.

Divergence notes (the JAX package's):

* The reference dies permanently if ``decode_frame`` is fed a partial
  frame (its cursor has already consumed bytes).  This decoder buffers
  instead and resumes once the rest of the frame arrives — strictly more
  tolerant, same behavior for whole-frame feeding.
* The reference iterator yields ``Some(Err(e))`` once and documents that
  iteration "should be considered finished" (src/lib.rs:666-667).  The
  Pythonic equivalent here is that ``__next__`` raises the typed error;
  subsequent calls raise ``StopIteration``.  The item sequence before the
  error is identical, including truncation fidelity: an EOF-truncated
  final frame still yields its header and every complete slice window
  (src/lib.rs:291-330 reads one u64 per channel per window, so the first
  incomplete window is where the error lands).
"""

from __future__ import annotations

import io
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from . import bitstream as bs
from . import codec
from . import format as fmt
from . import native
from .errors import (
    IncompatibleFrame,
    InvalidSamples,
    IoError,
    NoSamples,
    NotQoaFile,
)
from .parallel import corpus
from .reference import Lms, PyEncoder, decode_batch_np
from .types import FixedSamples, FrameHeader, ProcessingMode, QoaDesc, Streaming


def _as_reader(source) -> io.BufferedIOBase:
    if isinstance(source, (bytes, bytearray, memoryview)):
        return io.BytesIO(bytes(source))
    if hasattr(source, "read"):
        return source
    raise TypeError("source must be bytes or a binary file-like object")


class _GrowableBuffer:
    """Append-only byte source used by streaming-mode decoders."""

    def __init__(self, initial: bytes = b""):
        self._buf = bytearray(initial)
        self._pos = 0

    def append(self, data: bytes) -> None:
        if self._pos:
            # compact: consumed bytes would otherwise accumulate forever
            # on long-lived network streams
            del self._buf[: self._pos]
            self._pos = 0
        self._buf.extend(data)

    def read(self, n: int) -> bytes:
        out = bytes(self._buf[self._pos : self._pos + n])
        self._pos += len(out)
        return out

    def peek_len(self) -> int:
        return len(self._buf) - self._pos

    def rewind(self, n: int) -> None:
        self._pos -= n


class QoaDecoder:
    """Streaming QOA decoder with iterator semantics.

    Yields ``FrameHeader`` at each frame start and ``int`` samples between
    headers.  Bulk access: ``read_samples`` / ``decode_pending``.
    """

    def __init__(self, source, backend: str = "auto", readahead: int = 32,
                 prefetch: Optional[bool] = None, device=None):
        """``readahead``: frames decoded per staging batch.  Frames are
        decode-parallel (each carries its LMS seed), so staging many at once
        costs the same wall time as one — the TPU-idiomatic default.  Use
        ``readahead=1`` for strict frame-at-a-time IO.

        ``backend``: "auto" (native host engine, falling back to numpy),
        "native", "numpy", or "torch" (the decode kernel on ``device``,
        which it needs; the other backends do not use ``device``).

        ``prefetch``: pipeline the NEXT batch's read+decode on a worker
        thread while the consumer drains the current one (the host-IO /
        device-compute overlap axis, SURVEY.md §2.2 PP; the native and
        torch decode calls release the GIL, so the overlap is real).  Default:
        enabled whenever ``readahead > 1`` on a file-like source —
        in-memory ``bytes`` have no IO latency to hide, so they stay
        synchronous unless explicitly requested."""
        if backend != "auto":  # unknown names; "torch" needs a device
            codec.resolve_backend(backend, device)
        in_memory = isinstance(source, (bytes, bytearray, memoryview))
        self._reader = _as_reader(source)
        if backend in ("auto", "native"):
            if native.available():
                backend = "native"
            elif backend == "native":
                raise RuntimeError("native engine unavailable")
            else:
                backend = "numpy"
        self._backend = backend
        self.device = torch.device(device) if backend == "torch" else None
        self._readahead = max(1, readahead)
        self._dead = False

        header = self._reader.read(fmt.QOA_HEADER_SIZE)
        if len(header) < fmt.QOA_HEADER_SIZE:
            raise IoError("unexpected EOF reading file header")
        if int.from_bytes(header[:4], "big") != fmt.QOA_MAGIC:
            raise NotQoaFile()
        total_samples = int.from_bytes(header[4:8], "big")

        self._pending: np.ndarray = np.empty(0, dtype=np.int16)
        self._pending_idx = 0
        self._returned_first_header = False
        self._current_header = FrameHeader(0, 0, 0)
        # decoded-but-undrained frames: deque of (header, pcm, yield_header)
        self._queue = deque()
        # Producer-side state (_records, _tail, _pending_error) is touched
        # by __init__, seek_to_frame, and _produce ONLY.  When prefetch is
        # enabled _produce runs on the worker thread; safety relies on the
        # invariant that AT MOST ONE _produce is in flight and every other
        # toucher first drains the future (_drain_prefetch / _fill_queue),
        # so access is serialized through the future, never concurrent.
        self._records = deque()  # parsed but not yet decoded FrameRecords
        self._pending_error: Optional[Exception] = None
        self._mode: Optional[ProcessingMode] = None  # set below
        if prefetch is None:
            prefetch = self._readahead > 1 and not in_memory
        self._prefetch_enabled = prefetch and not isinstance(
            self._reader, _GrowableBuffer
        )
        self._prefetch_future = None
        self._executor = None
        self.prefetch_hits = 0  # batches served that were decoded ahead
        self._tail = b""  # bytes bulk-read past the last parsed frame

        if total_samples == 0:
            self._mode = Streaming()
        else:
            # fixed mode: read the first frame eagerly (NoSamples if absent),
            # mirroring QoaDecoder::new (src/lib.rs:160-166)
            rec = self._read_frame_record()
            if rec is None:
                raise NoSamples()
            self._mode = FixedSamples(
                channels=rec.channels,
                sample_rate=rec.sample_rate,
                samples=total_samples,
            )
            self._current_header = FrameHeader(
                rec.channels, rec.sample_rate, rec.samples_per_channel
            )
            self._first_frame_size = rec.frame_size
            self._first_frame_samples = rec.samples_per_channel
            # its header is delivered by the first-header path, not the queue
            self._records.append((rec, False))

    # -- constructors ------------------------------------------------------

    @classmethod
    def open(cls, path, backend: str = "auto", readahead: int = 32,
             prefetch: Optional[bool] = None, device=None) -> "QoaDecoder":
        """Open a file path (reference: src/lib.rs:619-625)."""
        f = open(path, "rb")
        try:
            return cls(f, backend=backend, readahead=readahead,
                       prefetch=prefetch, device=device)
        except BaseException:
            f.close()
            raise

    @classmethod
    def new_streaming(cls, backend: str = "auto", readahead: int = 32,
                      device=None) -> "QoaDecoder":
        """Decoder for network-streamed frames (src/lib.rs:632-638)."""
        buf = _GrowableBuffer(fmt.pack_file_header(0))
        return cls(buf, backend=backend, readahead=readahead, device=device)

    # -- accessors ---------------------------------------------------------

    def mode(self) -> ProcessingMode:
        return self._mode

    def current_frame_header(self) -> FrameHeader:
        return self._current_header

    def total_duration(self) -> Optional[float]:
        """Duration in seconds for fixed mode, None when streaming."""
        if isinstance(self._mode, FixedSamples):
            return self._mode.samples / self._mode.sample_rate
        return None

    def into_inner(self):
        """Return the underlying reader; the decoder must not be used after.

        Note the readahead design means the reader's position is generally
        AHEAD of the last consumed sample (batches and the slab buffer may
        have read past it) — same caveat as any buffered reader."""
        self._drain_prefetch()
        self._shutdown_executor()
        self._dead = True
        return self._reader

    # -- random access -------------------------------------------------------

    def seek_to_frame(self, index: int) -> None:
        """Jump to frame ``index`` in O(1) (fixed mode, seekable source).

        QOA frames are self-contained (each header carries the full LMS
        state, reference src/lib.rs:271-281) and fixed-mode streams are
        normally uniformly sized, so the byte offset is pure arithmetic.
        The format does allow partial INTERIOR frames (the reference
        tolerates them, src/lib.rs:54-57), which break the uniform-stride
        assumption — so the landed bytes are verified against the exact
        header word the uniform geometry predicts and ``IoError`` is
        raised on mismatch instead of silently decoding wrong samples.
        The reference has no seeking API — this falls out of the same
        property the batched kernels exploit.
        """
        if not isinstance(self._mode, FixedSamples):
            raise IoError("seek requires a fixed-mode stream")
        if not hasattr(self._reader, "seek"):
            raise IoError("seek requires a seekable source")
        # tell() must work BEFORE the cursor moves: the mismatch path's
        # "decoder untouched on failure" guarantee needs somewhere to
        # restore the reader to, so a seekable-but-not-tellable source is
        # refused up front rather than left mis-positioned on failure.
        # (Probe only — the restore position is re-read after the prefetch
        # worker is settled, which can advance the cursor.)
        try:
            self._reader.tell()
        except (OSError, AttributeError) as e:
            raise IoError("seek requires a tellable source") from e
        if self._first_frame_samples <= 0:
            raise IoError("seek requires a nonempty first frame")
        n_frames = -(-self._mode.samples // self._first_frame_samples)
        if not 0 <= index < n_frames:
            raise IoError(f"frame index {index} out of range 0..{n_frames - 1}")
        # the worker shares the reader cursor: settle it first, KEEPING the
        # prefetched batch — on a failed seek those frames are re-queued so
        # the decoder really is untouched (they are the frames that follow
        # the current queue; discarding them would silently skip audio)
        batch = self._take_prefetch()
        off = fmt.QOA_HEADER_SIZE + index * self._first_frame_size
        # uniform-stride geometry predicts this frame's header exactly
        # (interior frames full-length, the final frame the remainder)
        spc_exp = min(
            self._mode.samples - index * self._first_frame_samples,
            self._first_frame_samples,
        )
        exp = fmt.pack_frame_header(
            self._mode.channels,
            self._mode.sample_rate,
            spc_exp,
            fmt.qoa_frame_size(
                self._mode.channels, -(-spc_exp // fmt.QOA_SLICE_LEN)
            ),
        )
        # verify BEFORE committing: on mismatch the reader is restored and
        # every decoder attribute is untouched, so a caller that catches
        # the typed error keeps a fully consistent decoder
        pos0 = self._reader.tell()
        self._reader.seek(off)
        hdr = self._reader.read(8)
        if len(hdr) < 8 or int.from_bytes(hdr, "big") != exp:
            if batch is not None:
                items, b_err = batch
                self._queue.extend(items)
                if b_err is not None and self._pending_error is None:
                    self._pending_error = b_err
            self._reader.seek(pos0)
            raise IoError(
                f"seek_to_frame: no frame-{index} header at the uniform "
                "stride offset (stream has non-uniform interior frames?)"
            )
        self._reader.seek(off)
        self._pending = np.empty(0, dtype=np.int16)
        self._pending_idx = 0
        self._queue.clear()
        self._records.clear()
        self._tail = b""
        self._pending_error = None
        self._dead = False
        self._returned_first_header = True

    # -- frame loading -----------------------------------------------------

    def _read_raw(self, n: int) -> bytes:
        """Read n bytes, draining the slab leftover buffer first.

        ``_tail`` is only ever non-empty for non-growable fixed-mode
        sources (the slab fast path), so the growable rewind logic in
        ``_read_frame_record`` never interacts with it."""
        if self._tail:
            take, self._tail = self._tail[:n], self._tail[n:]
            if len(take) == n:
                return take
            return take + self._reader.read(n - len(take))
        return self._reader.read(n)

    def _read_frame_record(self) -> Optional[bs.FrameRecord]:
        """Read one whole frame; None on clean EOF (or incomplete buffer).

        EOF within the 8 header bytes — even a partial word — is a CLEAN
        end: the reference maps UnexpectedEof on the header read to
        Ok(false) (src/lib.rs:205-215)."""
        start_is_growable = isinstance(self._reader, _GrowableBuffer)
        hdr = self._read_raw(8)
        if len(hdr) < 8:
            if start_is_growable and hdr:
                self._reader.rewind(len(hdr))
            return None
        word = int.from_bytes(hdr, "big")
        channels, sample_rate, spc, frame_size = fmt.unpack_frame_header(word)
        bs._validate_frame_header(channels, sample_rate, frame_size)

        if isinstance(self._mode, FixedSamples):
            if (
                channels != self._mode.channels
                or sample_rate != self._mode.sample_rate
            ):
                raise IncompatibleFrame()

        n_windows = -(-spc // fmt.QOA_SLICE_LEN)
        lms_len = fmt.QOA_LMS_STATE_BYTES * channels
        body_len = lms_len + 8 * n_windows * channels
        body = self._read_raw(body_len)
        if len(body) < body_len:
            if start_is_growable:
                # streaming buffer: not enough data yet; un-consume all of it
                self._reader.rewind(len(body) + 8)
                return None
            # EOF-truncated frame: the reference reads one u64 per channel
            # per window (src/lib.rs:291-330), so the frame header + every
            # COMPLETE window still yield items before the error.  Build a
            # partial record covering the complete windows and defer the
            # IoError until the queue drains (_raise_or_stop).
            if len(body) < lms_len:
                raise IoError("unexpected EOF inside frame")
            n_windows = (len(body) - lms_len) // (8 * channels)
            self._pending_error = IoError("unexpected EOF inside frame")

        # LMS state is 4 x i16 history + 4 x i16 weights per channel, all
        # big-endian: one typed view replaces per-word shift/mask unpacking
        lms = (
            np.frombuffer(body, dtype=">i2", count=8 * channels)
            .astype(np.int32)
            .reshape(channels, 2, 4)
        )
        words = (
            np.frombuffer(
                body,
                dtype=">u8",
                count=n_windows * channels,
                offset=fmt.QOA_LMS_STATE_BYTES * channels,
            )
            .astype(np.uint64)
            .reshape(n_windows, channels)
        )
        return bs.FrameRecord(
            channels=channels,
            sample_rate=sample_rate,
            samples_per_channel=spc,
            frame_size=frame_size,
            lms_history=lms[:, 0],
            lms_weights=lms[:, 1],
            slice_words=words,
        )

    def _decode_records(self, recs) -> list:
        """Decode a run of frames with equal (channels, rate) in ONE batched
        call — frames are decode-parallel — returning the per-frame queue
        items.

        Zero-window frames (spc == 0, or a frame truncated before its first
        complete window) carry no samples: their header passes through."""
        items = []
        i = 0
        while i < len(recs):
            if recs[i][0].n_windows == 0:
                rec, yield_header = recs[i]
                hdr = FrameHeader(
                    rec.channels, rec.sample_rate, rec.samples_per_channel
                )
                items.append((hdr, np.empty(0, np.int16), yield_header))
                i += 1
                continue
            j = i
            while j < len(recs) and recs[j][0].n_windows > 0:
                j += 1
            items.extend(self._decode_group(recs[i:j]))
            i = j
        return items

    def _decode_group(self, recs) -> list:
        if self._backend == "native":
            # chain arrays straight from the records: the native engine
            # consumes raw big-endian words, so the generic unpack->stack->
            # repack round trip (which dominated the streaming path's
            # per-frame cost) is skipped entirely
            F = len(recs)
            C = recs[0][0].channels
            Wn = max(r.n_windows for r, _ in recs)
            words_be = np.zeros((Wn, F * C), np.uint64)
            st = np.empty((8, F * C), np.int32)
            for i, (rec, _) in enumerate(recs):
                cols = slice(i * C, (i + 1) * C)
                words_be[: rec.n_windows, cols] = rec.slice_words.byteswap()
                st[0:4, cols] = rec.lms_history.T
                st[4:8, cols] = rec.lms_weights.T
            if C in (1, 2) and native.has_fused_interleaved():
                pcm = native.decode_interleaved(words_be, st, C)
            else:
                dec = native.decode_chains(words_be, st)
                pcm = native.interleave_trim(
                    dec, F, C, F * Wn * fmt.QOA_SLICE_LEN
                )
            pcm = pcm.reshape(F, Wn * fmt.QOA_SLICE_LEN, C)
        elif self._backend == "torch":
            # every frame x channel chain of the group in one launch
            pcm = codec._decode_frame_records([r for r, _ in recs], self.device)
        else:
            pcm = decode_batch_np(bs.stack_frames([r for r, _ in recs]))
        items = []
        for i, (rec, yield_header) in enumerate(recs):
            hdr = FrameHeader(
                rec.channels, rec.sample_rate, rec.samples_per_channel
            )
            # a truncated frame carries fewer windows than its declared
            # sample count needs: only the complete windows' samples yield
            valid = min(
                rec.samples_per_channel, rec.n_windows * fmt.QOA_SLICE_LEN
            )
            block = pcm[i, :valid].reshape(-1)
            items.append((hdr, block, yield_header))
        return items

    def _produce(self):
        """Read up to ``readahead`` frames and decode them batched.

        Consecutive frames with equal (channels, rate) share one decode
        call; a format change (streaming mode) starts a new group.
        Returns (queue items, deferred error) without touching the
        consumer-visible ``_queue``; it DOES mutate the producer-side
        state (``_records``, ``_tail``, ``_pending_error``) — safe on the
        prefetch worker only under the single-in-flight-future invariant
        documented at the attribute declarations in ``__init__``.

        Fast path: a uniform fixed-mode stream's frames are byte-identical
        in geometry, so the whole batch bulk-reads in ONE ``read`` and
        parses as a dense numpy slab — no per-frame Python.  Any
        non-uniform byte run (the short final frame, corruption, EOF)
        falls back to the frame-by-frame reader via the ``_tail`` buffer,
        preserving the reference's truncation semantics exactly.
        """
        if (
            self._backend == "native"
            and not self._records
            and self._pending_error is None
            and isinstance(self._mode, FixedSamples)
            and not isinstance(self._reader, _GrowableBuffer)
        ):
            out = self._produce_slab()
            if out is not None:
                return out
        while len(self._records) < self._readahead:
            if self._pending_error is not None:
                break  # a deferred mid-stream error ends record intake
            try:
                rec = self._read_frame_record()
            except Exception as e:
                self._pending_error = e
                break
            if rec is None:
                break
            self._records.append((rec, True))
        items = []
        while self._records:
            group = [self._records.popleft()]
            key = (group[0][0].channels, group[0][0].sample_rate)
            while self._records and (
                self._records[0][0].channels,
                self._records[0][0].sample_rate,
            ) == key:
                group.append(self._records.popleft())
            try:
                items.extend(self._decode_records(group))
            except Exception as e:
                # a decode-stage failure becomes the batch's deferred
                # error: the items decoded so far still yield, then
                # _raise_or_stop delivers the error with the decoder dead
                self._pending_error = e
                break
        err, self._pending_error = self._pending_error, None
        return items, err

    def _match_slab(self, want_frames: Optional[int] = None):
        """Bulk-read + header-match the next run of uniform frames.

        Returns (m, data, fs, nw) for m >= 1 matched frames starting at
        ``data[0]`` (m <= ``want_frames``, default ``readahead``), or
        None (non-uniform next frame / EOF / geometry mismatch — the
        unconsumed bytes stay in ``_tail`` for the frame-at-a-time
        reader).  Bytes past frame m stay in ``_tail``; ``data`` may
        extend beyond m*fs.
        """
        fs = self._first_frame_size
        spc = self._first_frame_samples
        C = self._mode.channels
        if fs != fmt.qoa_frame_size(C, -(-spc // fmt.QOA_SLICE_LEN)):
            # frame_size is advisory to the reference reader (it consumes
            # ceil(spc/20) slices regardless, src/lib.rs:291-330); a
            # declared size that disagrees breaks the slab stride — use
            # the spc-driven frame-at-a-time reader
            return None
        if want_frames is None:
            want_frames = self._readahead
        exp = fmt.pack_frame_header(C, self._mode.sample_rate, spc, fs)
        want = want_frames * fs
        data = self._tail
        self._tail = b""
        if len(data) < want:
            data += self._reader.read(want - len(data))
        k = len(data) // fs
        m = 0
        if k:
            hdrs = np.frombuffer(data, dtype=">u8", count=k * (fs // 8)).reshape(
                k, fs // 8
            )[:, 0]
            eq = hdrs == np.uint64(exp)
            m = k if bool(eq.all()) else int(np.argmin(eq))
            m = min(m, want_frames)  # a large carried _tail can exceed want
        if m == 0:
            self._tail = data
            return None
        self._tail = data[m * fs :]
        nw = (fs // 8 - 1 - 2 * C) // C  # slice windows per frame
        return m, data, fs, nw

    def _parse_slab(self, want_frames: Optional[int] = None):
        """:meth:`_match_slab` plus the dense chain-array gather.

        Returns (m, words_be, state, nw) shaped for the array kernels,
        or None (cf. parse_file_arrays).
        """
        matched = self._match_slab(want_frames)
        if matched is None:
            return None
        m, data, fs, nw = matched
        C = self._mode.channels
        i2 = np.frombuffer(data, dtype=">i2", count=m * (fs // 2)).reshape(
            m, fs // 2
        )
        lms = i2[:, 4 : 4 + 8 * C].astype(np.int32).reshape(m, C, 2, 4)
        state = np.empty((8, m * C), np.int32)
        state[0:4] = lms[:, :, 0].reshape(m * C, 4).T
        state[4:8] = lms[:, :, 1].reshape(m * C, 4).T
        raw = np.frombuffer(data, dtype=np.uint64, count=m * (fs // 8)).reshape(
            m, fs // 8
        )  # native view of big-endian bytes == the raw words the engine eats
        words_be = np.ascontiguousarray(
            raw[:, 1 + 2 * C :].reshape(m, nw, C).transpose(1, 0, 2)
        ).reshape(nw, m * C)
        return m, words_be, state, nw

    def _produce_slab(self):
        """Bulk path of :meth:`_produce`; None = use the slow path."""
        if not native.available():
            return None
        C = self._mode.channels
        spc = self._first_frame_samples

        # interleave at the full nw*20 row stride, then take each frame's
        # first spc rows (contiguous views, no copies).  This is exact for
        # BOTH window-aligned frames (spc == nw*20: the slice is the whole
        # frame) and non-aligned uniform frames (spc % 20 != 0, legal —
        # the reference reads spc from every header, src/lib.rs:217-225 —
        # where the fused interleave+trim's single trailing trim would
        # corrupt every frame after the first)
        if C in (1, 2) and native.has_fused_interleaved():
            # raw-bytes kernel: words + LMS read straight from the slab
            matched = self._match_slab()
            if matched is None:
                return None
            m, data, fs, nw = matched
            full = native.decode_interleaved_raw(data, 0, m, fs, nw, C)
        else:
            parsed = self._parse_slab()
            if parsed is None:
                return None
            m, words_be, state, nw = parsed
            dec = native.decode_chains(words_be, state)
            full = native.interleave_trim(
                dec, m, C, m * nw * fmt.QOA_SLICE_LEN
            )
        full = full.reshape(m, nw * fmt.QOA_SLICE_LEN, C)
        hdr = FrameHeader(C, self._mode.sample_rate, spc)
        items = [(hdr, full[i, :spc].reshape(-1), True) for i in range(m)]
        return items, None

    def _produce_slab_into(self, dst: np.ndarray, want_frames: int) -> int:
        """Decode the next slab straight into ``dst`` samples (no staging).

        ``dst``: flat C-contiguous int16 with capacity for at least
        ``want_frames`` full frames (any sample alignment — the kernel
        only needs contiguity).  Caller guarantees the fused mono/stereo
        engine and window-aligned frames (spc == nw*20), so the kernel's
        uniform frame stride IS the output stride.  Returns the number of
        frames written (0 = no uniform slab here; fall back).
        """
        C = self._mode.channels
        # raw-bytes kernel straight from the slab into dst (the caller
        # guarantees the fused engine, so C is 1 or 2 here)
        matched = self._match_slab(want_frames)
        if matched is None:
            return 0
        m, data, fs, nw = matched
        native.decode_interleaved_raw(
            data, 0, m, fs, nw, C,
            out=dst[: m * nw * fmt.QOA_SLICE_LEN * C].reshape(-1, C),
        )
        return m

    def _take_prefetch(self):
        """Wait out any in-flight prefetch; return its (items, err) or None."""
        if self._prefetch_future is None:
            return None
        fut, self._prefetch_future = self._prefetch_future, None
        try:
            return fut.result()
        except Exception as e:
            return [], e

    def _drain_prefetch(self) -> None:
        """Wait out any in-flight prefetch and discard it (handoff)."""
        self._take_prefetch()

    def _fill_queue(self) -> None:
        if self._queue or self._dead:
            return
        if self._prefetch_future is not None:
            fut, self._prefetch_future = self._prefetch_future, None
            try:
                items, err = fut.result()
            except Exception as e:
                # a worker failure outside _produce's own error handling
                # (e.g. a native-engine fault) must still flow through the
                # typed _raise_or_stop path with the decoder marked dead —
                # never propagate raw out of __next__ and retry from an
                # inconsistent reader position
                items, err = [], e
            else:
                self.prefetch_hits += 1
        else:
            try:
                items, err = self._produce()
            except Exception as e:
                # same guard as the worker path above: _produce wraps its
                # record-intake and decode stages itself, so this only
                # fires for faults outside those (e.g. the slab parser) —
                # they too must arrive typed, with the decoder dead
                items, err = [], e
        self._queue.extend(items)
        self._pending_error = err
        # pipeline the NEXT batch while the consumer drains this one (only
        # when this batch was full-length — a short batch means EOF/error)
        if (
            self._prefetch_enabled
            and err is None
            and items
            and len(items) >= self._readahead
        ):
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="qoa-prefetch"
                )
            self._prefetch_future = self._executor.submit(self._produce)

    # -- iteration ---------------------------------------------------------

    def __iter__(self) -> "QoaDecoder":
        return self

    def __next__(self):
        while True:
            if self._dead:
                raise StopIteration
            if self._pending_idx < len(self._pending):
                s = int(self._pending[self._pending_idx])
                self._pending_idx += 1
                return s
            if not self._returned_first_header:
                self._returned_first_header = True
                return self._current_header
            self._fill_queue()
            if not self._queue:
                self._raise_or_stop()
            hdr, block, yield_header = self._queue.popleft()
            self._current_header = hdr
            self._pending = block
            self._pending_idx = 0
            if yield_header:
                return hdr

    def _shutdown_executor(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None

    def _raise_or_stop(self):
        if self._pending_error is not None:
            self._dead = True
            self._shutdown_executor()
            err, self._pending_error = self._pending_error, None
            raise err
        if isinstance(self._reader, _GrowableBuffer):
            # a dry streaming buffer is NOT end-of-stream: the reference
            # decoder resumes iteration once decode_frame feeds more bytes
            # (src/lib.rs:641-651 drains the iterator repeatedly)
            raise StopIteration
        self._dead = True
        self._shutdown_executor()  # stream ended: release the worker thread
        raise StopIteration

    def __del__(self):
        try:
            self._drain_prefetch()
            self._shutdown_executor()
        except Exception:
            pass

    # -- bulk access -------------------------------------------------------

    def next_frame(self):
        """Advance to the next frame; return (FrameHeader, int16 samples).

        Returns None at end of stream.  Any samples already staged but not
        yet drained by the iterator belong to the *current* frame and are
        returned with the current header.  This is the bulk-granularity
        analog of the item iterator.
        """
        if self._dead:
            return None
        self._returned_first_header = True
        if self._pending_idx < len(self._pending):
            out = self._pending[self._pending_idx :]
            self._pending_idx = len(self._pending)
            return self._current_header, out
        self._fill_queue()
        if not self._queue:
            try:
                self._raise_or_stop()
            except StopIteration:
                return None
        hdr, block, _ = self._queue.popleft()
        self._current_header = hdr
        self._pending = np.empty(0, dtype=np.int16)
        self._pending_idx = 0
        return hdr, block

    def _bulk_drain(self) -> Optional[np.ndarray]:
        """Zero-copy fast path of :meth:`decode_pending`.

        For in-memory fixed-mode mono/stereo sources on the fused native
        engine with window-aligned frames, slabs decode STRAIGHT into one
        preallocated output (the fused kernel's uniform frame stride IS
        the output stride) — no per-frame staging blocks and no final
        concatenate.  Exact same item semantics as the generic path: any
        non-uniform stretch (truncated tail, mid-stream surprises) routes
        through the ordinary queue machinery and its blocks copy in;
        deferred errors are raised only when nothing was decodable.
        Returns None when the preconditions don't hold.
        """
        if (
            self._dead
            or self._backend != "native"
            or not isinstance(self._mode, FixedSamples)
            or self._mode.channels not in (1, 2)
            or self._prefetch_enabled
            or self._prefetch_future is not None
            or not isinstance(self._reader, io.BytesIO)
            or not native.available()
            or not native.has_fused_interleaved()
        ):
            return None
        C = self._mode.channels
        spc = self._first_frame_samples
        fs = self._first_frame_size
        nw = -(-spc // fmt.QOA_SLICE_LEN)
        if spc != nw * fmt.QOA_SLICE_LEN or fs != fmt.qoa_frame_size(C, nw):
            return None
        # capacity estimate IN FLAT SAMPLES: staged samples + remaining
        # bytes as uniform frames.  Exact for well-formed streams (interior
        # frames larger than the first are format-illegal and error out
        # before writing); the overflow list below keeps even hostile
        # streams lossless.  The buffer is flat because a partially-drained
        # iterator can leave an ODD _pending remainder (samples, not
        # channel pairs) — only contiguity matters for the concatenation.
        rem = (
            self._reader.getbuffer().nbytes
            - self._reader.tell()
            + len(self._tail)
        )
        est = len(self._pending) - self._pending_idx
        est += sum(b.size for _, b, _ in self._queue)
        est += sum(C * r.samples_per_channel for r, _ in self._records)
        est += -(-rem // fs) * spc * C
        if est <= 0:
            return None
        out = np.empty(est, np.int16)
        filled = 0
        overflow: list = []

        def put(block) -> None:
            nonlocal filled
            n = block.size
            if overflow or filled + n > est:
                overflow.append(np.asarray(block).reshape(-1))
                return
            out[filled : filled + n] = block.reshape(-1)
            filled += n

        if self._pending_idx < len(self._pending):
            put(self._pending[self._pending_idx :])
            self._pending_idx = len(self._pending)
        self._returned_first_header = True
        hdr_uniform = FrameHeader(C, self._mode.sample_rate, spc)
        # drain already-parsed records (the eagerly-read first frame) as
        # one group so the slab path engages immediately — otherwise
        # _produce would top the batch up with readahead-1 frame-at-a-time
        # reads before the first slab
        if self._records and self._pending_error is None:
            recs = list(self._records)
            self._records.clear()
            try:
                for hdr, block, _ in self._decode_records(recs):
                    self._current_header = hdr
                    put(block)
            except Exception as e:
                self._pending_error = e
        # the bulk drain is UNCAPPED: the raw-bytes kernel decodes slab
        # bytes straight into their final rows of `out`, so there is no
        # staging buffer to keep cache-resident and the whole uniform run
        # decodes as ONE slab (sweep on the fixture: whole-file 1313 Msps
        # vs 1160 at the old 128-frame cap — that cap was an artifact of
        # the retired staging+concat design)
        while not self._dead:
            want = (est - filled) // (spc * C)
            if (
                want >= 1
                and not overflow
                and not self._queue
                and not self._records
                and self._pending_error is None
            ):
                m = self._produce_slab_into(out[filled:], want)
                if m:
                    filled += m * spc * C
                    self._current_header = hdr_uniform
                    continue
            self._fill_queue()
            if not self._queue:
                if (
                    self._pending_error is not None
                    and filled == 0
                    and not overflow
                ):
                    self._raise_or_stop()
                break
            while self._queue:
                hdr, block, _ = self._queue.popleft()
                self._current_header = hdr
                put(block)
        if overflow:
            return np.concatenate([out[:filled]] + overflow)
        return out[:filled]

    def decode_pending(self) -> np.ndarray:
        """Drain everything currently decodable into one int16 array.

        Frame headers are skipped (like ``decode_frame`` in the reference,
        src/lib.rs:641-651).  A deferred mid-stream error is raised only
        after all decodable samples have been returned.
        """
        fast = self._bulk_drain()
        if fast is not None:
            return fast
        chunks = []
        if self._pending_idx < len(self._pending):
            chunks.append(self._pending[self._pending_idx :])
            self._pending_idx = len(self._pending)
        self._returned_first_header = True
        while not self._dead:
            self._fill_queue()
            if not self._queue:
                if self._pending_error is not None and not chunks:
                    self._raise_or_stop()
                break
            while self._queue:
                hdr, block, _ = self._queue.popleft()
                self._current_header = hdr
                chunks.append(block)
        if chunks:
            return np.concatenate(chunks)
        return np.empty(0, dtype=np.int16)

    def decode_frame(self, frame_data: bytes) -> np.ndarray:
        """Streaming mode: feed frame bytes, return newly decoded samples.

        Reference: src/lib.rs:641-651.
        """
        if not isinstance(self._reader, _GrowableBuffer):
            raise TypeError("decode_frame requires a new_streaming decoder")
        self._reader.append(bytes(frame_data))
        return self.decode_pending()


class QoaEncoder:
    """QOA encoder with one-shot and frame-at-a-time streaming APIs.

    LMS state and ``prev_scalefactor`` persist across ``encode_frame``
    calls, so streamed output is byte-identical to one-shot output
    (reference guarantee, src/lib.rs:1262-1297).
    """

    def __init__(self, desc: QoaDesc, backend: str = "auto", device=None):
        """``backend``: "auto" (native host engine, else "torch" on
        ``device``), "native", "numpy" or "torch" (the encode kernels on
        ``device``, which it needs)."""
        backend = codec.resolve_backend(backend, device)
        codec._validate_desc(desc)
        self.desc = desc
        self._backend = backend
        self.device = torch.device(device) if backend == "torch" else None
        self.channels = desc.channels
        self.sample_rate = desc.sample_rate
        self.samples = desc.samples
        # carried state: (8, C) int32 — history rows 0-3, weights rows 4-7
        self._state = codec.initial_encoder_state(desc.channels)
        # kept for API parity; the search order does not use it (the
        # reference carries but never reads it — src/lib.rs:90,481)
        self.prev_scalefactor = [0] * desc.channels

    # -- checkpoint / resume -------------------------------------------------
    #
    # The reference has no checkpointing, but its in-stream equivalent is
    # that every frame serializes full LMS state (src/lib.rs:455-466).  The
    # streaming encoder's carried state is exposed here as an explicit,
    # serializable dict so a long encode can resume exactly (SURVEY.md §5);
    # a state moves between encoders of any backend, the JAX package's
    # included.

    def get_state(self) -> dict:
        """Snapshot the carried codec state (copy, JSON/npz-friendly)."""
        return {
            "history": self._state[0:4].T.copy(),  # (C, 4) int32
            "weights": self._state[4:8].T.copy(),
            "prev_scalefactor": list(self.prev_scalefactor),
        }

    def set_state(self, state: dict) -> None:
        """Restore a snapshot taken by :meth:`get_state`."""
        self._state = np.concatenate(
            [
                np.asarray(state["history"], np.int32).T,
                np.asarray(state["weights"], np.int32).T,
            ]
        )
        self.prev_scalefactor = list(state["prev_scalefactor"])

    # -- streaming API -----------------------------------------------------

    def write_header(self, writer) -> None:
        """Write the 8-byte file header (reference: src/lib.rs:404-408)."""
        writer.write(fmt.pack_file_header(self.samples))

    def encode_frame(self, sample_data, writer) -> int:
        """Encode one frame of interleaved PCM and write it.

        Returns the number of samples per channel encoded.
        """
        data = self._frame_bytes(sample_data)
        writer.write(data)
        return len(np.asarray(sample_data).reshape(-1)) // self.channels

    def encode_frame_bytes(self, sample_data) -> bytes:
        """Like ``encode_frame`` but returns the bytes."""
        return self._frame_bytes(sample_data)

    def _frame_bytes(self, sample_data) -> bytes:
        pcm = np.asarray(sample_data).reshape(-1)
        C = self.channels
        if pcm.size == 0 or pcm.size % C != 0:
            raise InvalidSamples()
        frame_len = pcm.size // C
        if frame_len > fmt.QOA_FRAME_LEN:
            raise InvalidSamples()

        if self._backend == "numpy":
            return self._frame_bytes_numpy(pcm, frame_len)
        if self._backend == "native":
            return self._frame_bytes_native(pcm, frame_len)

        snaps, words = self._encode(pcm, frame_len)
        n_windows = -(-frame_len // fmt.QOA_SLICE_LEN)
        return bs.build_frame_bytes(
            C, self.sample_rate, frame_len,
            snaps[0, 0:4].T, snaps[0, 4:8].T, words[0, :n_windows],
        )

    def _encode(self, pcm: np.ndarray, samples: int):
        """Encode ``samples`` per channel on ``"torch"`` from the carried
        state (the corpus layer's chunked path); update the state and
        ``prev_scalefactor``.  Returns (snaps (F, 8, C), words (F, W, C))."""
        C = self.channels
        desc = QoaDesc(C, self.sample_rate, samples)
        state, snaps, words, _ = corpus.encode_chains(
            [(pcm, desc)], self.device, state=self._state
        )
        self._state = state
        last = -(-(samples - (snaps.shape[0] - 1) * fmt.QOA_FRAME_LEN)
                 // fmt.QOA_SLICE_LEN)
        # the top 4 bits of the last slice word; the mask keeps this right
        # for words held as signed 64-bit values too
        self.prev_scalefactor = [
            (int(words[-1, last - 1, c]) >> 60) & 0xF for c in range(C)
        ]
        return snaps, words

    def _frame_bytes_native(self, pcm, frame_len: int) -> bytes:
        C = self.channels
        n_windows = -(-frame_len // fmt.QOA_SLICE_LEN)
        lens = np.full(n_windows, fmt.QOA_SLICE_LEN, np.int32)
        lens[-1] = frame_len - (n_windows - 1) * fmt.QOA_SLICE_LEN
        hist = self._state[0:4].T.copy()
        wts = self._state[4:8].T.copy()
        if not (
            self._state.flags["C_CONTIGUOUS"] and self._state.dtype == np.int32
        ):
            self._state = np.ascontiguousarray(self._state, dtype=np.int32)
        words = native.encode_windows(
            pcm.reshape(-1, C), lens, n_windows, self._state
        )
        for c in range(C):
            self.prev_scalefactor[c] = int(words[n_windows - 1, c] >> 60)
        return bs.build_frame_bytes(
            C, self.sample_rate, frame_len, hist, wts, words
        )

    def _frame_bytes_numpy(self, pcm, frame_len: int) -> bytes:
        enc = PyEncoder.__new__(PyEncoder)
        enc.channels = self.channels
        enc.sample_rate = self.sample_rate
        enc.samples = self.samples
        enc.lms = [
            Lms(list(map(int, self._state[0:4, c])),
                list(map(int, self._state[4:8, c])))
            for c in range(self.channels)
        ]
        enc.prev_scalefactor = list(self.prev_scalefactor)
        out = enc.encode_frame_bytes(list(map(int, pcm)))
        for c in range(self.channels):
            self._state[0:4, c] = enc.lms[c].history
            self._state[4:8, c] = enc.lms[c].weights
        self.prev_scalefactor = list(enc.prev_scalefactor)
        return out

    # -- one-shot API ------------------------------------------------------

    def encode(self, sample_data) -> bytes:
        """One-shot encode (reference: src/lib.rs:367-398).

        Uses the encoder's *current* carried state, like the reference's
        ``&mut self`` method.  On ``"torch"`` the whole input is one
        chunked call (64 frames per launch); the host backends go frame by
        frame.
        """
        pcm = np.asarray(sample_data).reshape(-1)
        if pcm.size != self.samples * self.channels:
            raise InvalidSamples()
        if self._backend == "torch":
            snaps, words = self._encode(pcm, self.samples)
            return bs.assemble_stream_bytes(
                self.channels, self.sample_rate, self.samples, snaps, words
            )
        out = [fmt.pack_file_header(self.samples)]
        total = self.samples
        offset = 0
        while offset < total:
            frame_len = min(total - offset, fmt.QOA_FRAME_LEN)
            start = offset * self.channels
            end = (offset + frame_len) * self.channels
            out.append(self._frame_bytes(pcm[start:end]))
            offset += frame_len
        return b"".join(out)
