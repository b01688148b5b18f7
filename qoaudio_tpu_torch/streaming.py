"""Streaming codec objects of the port: ``QoaDecoder`` and ``QoaEncoder``.

Subclasses of ``qoaudio_tpu.streaming``'s classes that add the ``"torch"``
backend and a ``device`` (a CUDA device launches the kernels, ``"cpu"``
runs their plain versions); every other backend is the parent's, and the
iterator, readahead, prefetch, seek and checkpoint logic are inherited.

* ``QoaDecoder``: backends ``"auto"`` (native, else numpy, as the parent),
  ``"native"``, ``"numpy"``, ``"torch"``.  On ``"torch"`` each readahead
  batch of frames decodes in one launch; with prefetch on, that launch
  runs on the prefetch worker thread.
* ``QoaEncoder``: backends ``"auto"`` (native, else ``"torch"`` on
  ``device``), ``"native"``, ``"numpy"``, ``"torch"``.  On ``"torch"``,
  ``encode_frame`` encodes one frame from the carried LMS state (a full
  frame on the full-window kernel, a short one on the masked kernel over
  only its windows), and ``encode`` encodes the whole input in one chunked
  call from the current state: 64 frames per launch, not one per frame.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from qoaudio_tpu import bitstream as bs
from qoaudio_tpu import format as fmt
from qoaudio_tpu import streaming as _host
from qoaudio_tpu.errors import InvalidSamples
from qoaudio_tpu.types import FrameHeader, QoaDesc

from . import codec
from .parallel import corpus


class QoaDecoder(_host.QoaDecoder):
    """``qoaudio_tpu.streaming.QoaDecoder`` with a ``"torch"`` backend.

    Yields ``FrameHeader`` at each frame start and ``int`` samples between
    headers.  Bulk access: ``read_samples`` / ``decode_pending``.
    """

    def __init__(self, source, backend: str = "auto", readahead: int = 32,
                 prefetch: Optional[bool] = None, device=None):
        """``backend="torch"`` decodes on ``device`` and needs one; the
        other backends are the parent's (``device`` is not used)."""
        if backend != "auto":  # unknown names; "torch" needs a device
            codec.resolve_backend(backend, device)
        # the parent reads only the first frame record here and decodes
        # nothing, so a host backend stands in until the switch below
        super().__init__(
            source, backend="numpy" if backend == "torch" else backend,
            readahead=readahead, prefetch=prefetch,
        )
        self.device = None
        if backend == "torch":
            self._backend = "torch"
            self.device = torch.device(device)

    @classmethod
    def open(cls, path, backend: str = "auto", readahead: int = 32,
             prefetch: Optional[bool] = None, device=None) -> "QoaDecoder":
        """Open a file path."""
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
        """Decoder for network-streamed frames (feed ``decode_frame``)."""
        buf = _host._GrowableBuffer(fmt.pack_file_header(0))
        return cls(buf, backend=backend, readahead=readahead, device=device)

    def _decode_group(self, recs) -> list:
        if self._backend != "torch":
            return super()._decode_group(recs)
        pcm = codec._decode_frame_records([r for r, _ in recs], self.device)
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
            items.append((hdr, pcm[i, :valid].reshape(-1), yield_header))
        return items


class QoaEncoder(_host.QoaEncoder):
    """``qoaudio_tpu.streaming.QoaEncoder`` with a ``"torch"`` backend.

    LMS state and ``prev_scalefactor`` persist across ``encode_frame``
    calls, so streamed output is byte-identical to one-shot output;
    ``get_state`` / ``set_state`` carry them between encoders of any
    backend, the JAX package's included.
    """

    def __init__(self, desc: QoaDesc, backend: str = "auto", device=None):
        backend = codec.resolve_backend(backend, device)
        super().__init__(desc, backend=backend)
        self.device = torch.device(device) if backend == "torch" else None

    def _encode(self, pcm: np.ndarray, samples: int):
        """Encode ``samples`` per channel from the carried state; update
        the state and ``prev_scalefactor``.  Returns (snaps (F, 8, C),
        words (F, W, C) uint64)."""
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

    def _frame_bytes(self, sample_data) -> bytes:
        if self._backend != "torch":
            return super()._frame_bytes(sample_data)
        pcm = np.asarray(sample_data).reshape(-1)
        C = self.channels
        if pcm.size == 0 or pcm.size % C != 0:
            raise InvalidSamples()
        frame_len = pcm.size // C
        if frame_len > fmt.QOA_FRAME_LEN:
            raise InvalidSamples()
        snaps, words = self._encode(pcm, frame_len)
        n_windows = -(-frame_len // fmt.QOA_SLICE_LEN)
        return bs.build_frame_bytes(
            C, self.sample_rate, frame_len,
            snaps[0, 0:4].T, snaps[0, 4:8].T, words[0, :n_windows],
        )

    def encode(self, sample_data) -> bytes:
        """One-shot encode from the encoder's *current* carried state."""
        if self._backend != "torch":
            return super().encode(sample_data)
        pcm = np.asarray(sample_data).reshape(-1)
        if pcm.size != self.samples * self.channels:
            raise InvalidSamples()
        snaps, words = self._encode(pcm, self.samples)
        return bs.assemble_stream_bytes(
            self.channels, self.sample_rate, self.samples, snaps, words
        )
