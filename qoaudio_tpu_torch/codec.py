"""One-shot codec API of the port: ``decode_all`` / ``decode_range`` /
``encode_all`` / ``encode_all_batch`` / ``open_and_decode_all``.

Port of ``qoaudio_tpu/codec.py``.  Backends:

* ``"native"`` and ``"numpy"``: the host tier, straight through to
  ``qoaudio_tpu.codec``;
* ``"torch"``: the device tier on ``device``, which must be given — a CUDA
  device launches the kernels (``ops/cuda_decode.py``,
  ``ops/cuda_encode.py``), ``"cpu"`` runs their plain versions;
* ``"auto"``: the native engine when it is available, else ``"torch"`` on
  ``device``, else ``ValueError``.

There is no ``"jax"`` backend, and nothing moves from the card to the CPU
or to the host engine: a ``"torch"`` call whose kernel fails raises.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from qoaudio_tpu import bitstream as bs
from qoaudio_tpu import codec as _host
from qoaudio_tpu import native
from qoaudio_tpu.codec import initial_encoder_state, layout_pcm  # noqa: F401
from qoaudio_tpu.errors import IncompatibleFrame, InvalidSamples, NoSamples
from qoaudio_tpu.types import DecodedQoa, QoaDesc

from .ops import cuda_decode
from .parallel import corpus
from .utils.transfer import fetch_arrays, put_arrays

BACKENDS = ("auto", "native", "numpy", "torch")


def resolve_backend(backend: str, device) -> str:
    """The backend a call runs on: ``"native"``, ``"numpy"`` or
    ``"torch"``.  Raises ValueError for an unknown name, and for
    ``"torch"`` (asked for, or what ``"auto"`` falls to without the native
    engine) with no ``device``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "auto":
        if native.available():
            return "native"
        if device is None:
            raise ValueError(
                'backend="auto": the native engine is unavailable and no '
                'device was given for the "torch" backend'
            )
        return "torch"
    if backend == "torch" and device is None:
        raise ValueError('backend="torch" needs a device ("cuda" or "cpu")')
    return backend


def _decode_frame_records(records, device) -> np.ndarray:
    """Frames of one format, decoded in ONE launch on ``device``.

    ``records``: ``bs.FrameRecord``s with equal channels and rate
    (IncompatibleFrame otherwise).  Chain = frame x C + channel; a frame
    with fewer windows than the longest (a short or truncated frame) has
    zero words past its own.  Returns the untrimmed int16 (F, W*20, C)
    PCM on the host.
    """
    C, rate = records[0].channels, records[0].sample_rate
    if any(r.channels != C or r.sample_rate != rate for r in records):
        raise IncompatibleFrame()
    F = len(records)
    W = max(r.n_windows for r in records)
    if W == 0:
        return np.zeros((F, 0, C), np.int16)
    words_be = np.zeros((W, F * C), np.uint64)
    state = np.empty((8, F * C), np.int32)
    for i, rec in enumerate(records):
        cols = slice(i * C, (i + 1) * C)
        # the kernel reads the raw big-endian words and byteswaps them itself
        words_be[: rec.n_windows, cols] = rec.slice_words.byteswap()
        state[0:4, cols] = rec.lms_history.T
        state[4:8, cols] = rec.lms_weights.T
    words_d, state_d = put_arrays([words_be.view(np.int64), state], device)
    dec = cuda_decode.decode_chains_words(state_d, words_d)
    (pcm,) = fetch_arrays([corpus.frame_major(dec, F, C)])
    return pcm


def _decode_torch(data: bytes, device) -> DecodedQoa:
    device = torch.device(device)
    pa = bs.parse_file_arrays(data)
    if pa is not None:
        return corpus.decode_parsed([pa], device)[0]
    # streaming mode, ragged interior frames: the general frame walk
    parsed = bs.parse_file(data)
    if not parsed.frames:
        raise NoSamples()
    pcm = _decode_frame_records(parsed.frames, device)
    samples = np.concatenate(
        [pcm[i, : f.samples_per_channel] for i, f in enumerate(parsed.frames)]
    ).reshape(-1)
    return DecodedQoa(
        num_channels=parsed.frames[0].channels,
        sample_rate=parsed.frames[0].sample_rate,
        samples=samples,
    )


def decode_all(data: bytes, backend: str = "auto", device=None) -> DecodedQoa:
    """Decode a complete QOA stream (``qoaudio_tpu.codec.decode_all``).

    On ``"torch"`` every frame x channel chain decodes in one launch.
    Raises IncompatibleFrame if channels or rate change mid-stream,
    NoSamples on a stream with no frames.
    """
    backend = resolve_backend(backend, device)
    if backend != "torch":
        return _host.decode_all(data, backend=backend)
    return _decode_torch(data, device)


def open_and_decode_all(path, backend: str = "auto", device=None) -> DecodedQoa:
    """Open a file and decode it."""
    with open(path, "rb") as f:
        return decode_all(f.read(), backend=backend, device=device)


def decode_range(
    data: bytes, start: int, end: int, backend: str = "auto", device=None
) -> DecodedQoa:
    """Decode samples [start, end) per channel.

    The host backends decode only the frames that cover the range.  On
    ``"torch"`` the whole stream decodes, then the range is sliced, as the
    JAX package's device backend does.
    """
    if start < 0 or end < start:
        raise ValueError("need 0 <= start <= end")
    backend = resolve_backend(backend, device)
    if backend != "torch":
        return _host.decode_range(data, start, end, backend=backend)
    out = _decode_torch(data, device)
    lo = min(start, out.samples_per_channel)
    hi = min(end, out.samples_per_channel)
    return DecodedQoa(
        num_channels=out.num_channels,
        sample_rate=out.sample_rate,
        samples=out.samples.reshape(-1, out.num_channels)[lo:hi].reshape(-1),
    )


def encode_all(
    sample_data, desc: QoaDesc, backend: str = "auto", device=None
) -> bytes:
    """One-shot encode of interleaved 16-bit PCM to QOA bytes.

    On ``"torch"`` the frames go through the corpus layer's chunked path:
    the leading full frames on the full-window kernel, the rest on the
    masked one, 64 frames per launch with the LMS carried on the device.
    """
    _host._validate_desc(desc)
    sample_data = np.asarray(sample_data)
    if sample_data.size != desc.samples * desc.channels:
        raise InvalidSamples()
    backend = resolve_backend(backend, device)
    if backend != "torch":
        return _host.encode_all(sample_data, desc, backend=backend)
    return corpus.batch_encode([(sample_data, desc)], device)[0]


def encode_all_batch(
    files, backend: str = "auto", device=None
) -> List[bytes]:
    """Encode many ``(interleaved_pcm, QoaDesc)`` files, in input order.

    ``"torch"``: one ``corpus.batch_encode`` over all files' channels.
    ``"native"`` / ``"numpy"``: ``qoaudio_tpu.codec.encode_all_batch``,
    which pairs mono files on the native engine.
    """
    files = list(files)
    backend = resolve_backend(backend, device)
    if backend != "torch":
        return _host.encode_all_batch(files, backend=backend)
    return corpus.batch_encode(files, device)

