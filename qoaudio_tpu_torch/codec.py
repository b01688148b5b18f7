"""One-shot codec API of the port: ``decode_all`` / ``decode_range`` /
``encode_all`` / ``encode_all_batch`` / ``open_and_decode_all``.

Port of ``qoaudio_tpu/codec.py``, with its host paths folded in.  Backends:

* ``"native"``: the host engine (``native/``) — the raw-bytes fused
  decode, the O(range) ``decode_range``, the one-call whole-file encode
  and the dual-mono pairing of ``encode_all_batch``;
* ``"numpy"``: the scalar oracle (``reference.py``);
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

from . import bitstream as bs
from . import format as fmt
from . import native
from .errors import (
    IncompatibleFrame,
    InvalidChannels,
    InvalidSampleRate,
    InvalidSamples,
    NoSamples,
)
from .ops.decode import decode_chain_arrays
from .parallel import corpus
from .reference import decode_batch_np, encode_all_py
from .types import DecodedQoa, QoaDesc

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


def _require_native() -> None:
    if not native.available():
        raise RuntimeError("native engine unavailable")


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def initial_encoder_state(channels: int, n_chains: int | None = None) -> np.ndarray:
    """Fresh per-channel LMS state: history 0, weights (0,0,-2^13,2^14).

    Reference: QoaEncoder::new, src/lib.rs:346-352.
    """
    n = n_chains if n_chains is not None else channels
    state = np.zeros((8, n), dtype=np.int32)
    for i, wv in enumerate(fmt.QOA_INITIAL_WEIGHTS):
        state[4 + i, :] = wv
    return state


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

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
    return decode_chain_arrays(words_be, state, F, C, device)


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


def _decode_numpy(data: bytes) -> DecodedQoa:
    """The scalar oracle's batched decode, each frame trimmed to its
    samples."""
    parsed = bs.parse_file(data)
    if not parsed.frames:
        raise NoSamples()
    batch = bs.stack_frames(parsed.frames)
    pcm = decode_batch_np(batch)
    spf = batch.samples_per_frame
    if np.all(spf[:-1] == batch.max_windows * fmt.QOA_SLICE_LEN):
        # fast path: only the final frame is short
        flat = pcm.reshape(-1, batch.channels)
        full = (batch.n_frames - 1) * batch.max_windows * fmt.QOA_SLICE_LEN
        samples = np.concatenate([flat[:full], pcm[-1, : spf[-1]]]).reshape(-1)
    else:
        samples = np.concatenate(
            [pcm[i, : spf[i]] for i in range(batch.n_frames)]
        ).reshape(-1)
    return DecodedQoa(
        num_channels=batch.channels,
        sample_rate=batch.sample_rate,
        samples=samples.astype(np.int16, copy=False),
    )


def _decode_tail_fused(t, C: int) -> np.ndarray:
    """Decode a short tail FrameRecord through the array kernel.

    Returns the untrimmed (n_windows*20, C) int16 frame; callers slice
    to ``t.samples_per_channel`` rows.
    """
    tstate = np.empty((8, C), dtype=np.int32)
    tstate[0:4] = t.lms_history.T
    tstate[4:8] = t.lms_weights.T
    twords = np.ascontiguousarray(t.slice_words.astype(">u8").view(np.uint64))
    return native.decode_interleaved(twords, tstate, C)


def _decode_all_native(data: bytes) -> DecodedQoa:
    """One-shot decode on the native chain-vector engine.

    Uses the O(1)-per-frame arithmetic parse when the stream is uniform,
    the general frame walk otherwise (streaming mode, non-uniform frames).
    """
    geo = bs.parse_file_geometry(data)
    if (
        geo is not None
        and geo.channels in (1, 2)
        and geo.spc0 == geo.W0 * fmt.QOA_SLICE_LEN
        and native.has_fused_interleaved()
    ):
        # raw-bytes fused path: the kernel reads slice words + LMS straight
        # from the file buffer and stores interleaved PCM at final
        # positions.  Window-aligned full frames make the untrimmed rows
        # contiguous-exact; only the short tail (if any) decodes through
        # the array kernel.
        C = geo.channels
        rows_full = geo.F_full * geo.spc0
        tail_rows = geo.tail.samples_per_channel if geo.tail is not None else 0
        out = np.empty((rows_full + tail_rows, C), dtype=np.int16)
        native.decode_interleaved_raw(
            data, fmt.QOA_HEADER_SIZE, geo.F_full, geo.frame_bytes, geo.W0,
            C, out=out[:rows_full],
        )
        if geo.tail is not None:
            out[rows_full:] = _decode_tail_fused(geo.tail, C)[:tail_rows]
        return DecodedQoa(
            num_channels=C,
            sample_rate=geo.sample_rate,
            samples=out.reshape(-1),
        )

    pa = bs.parse_file_arrays(data)
    if pa is None:
        # general walk (still native kernels, frames stacked the slow way)
        parsed = bs.parse_file(data)
        if not parsed.frames:
            raise NoSamples()
        batch = bs.stack_frames(parsed.frames)
        F, C = batch.n_frames, batch.channels
        words_be, state = bs.batch_chain_arrays(batch)
        spf = batch.samples_per_frame
        rate = batch.sample_rate
    else:
        F = pa.n_frames
        C = pa.channels
        words_be, state = pa.words_be, pa.state
        spf = pa.samples_per_frame
        rate = pa.sample_rate

    W20 = words_be.shape[0] * fmt.QOA_SLICE_LEN
    aligned = bool(np.all(spf[:-1] == W20))
    if C in (1, 2) and native.has_fused_interleaved():
        # fused decode->interleaved: no (W, 20, N) intermediate round trip
        full = native.decode_interleaved(words_be, state, C)
        if aligned:
            samples = full[: int(spf.sum())].reshape(-1)
        else:
            pcm = full.reshape(F, W20, C)
            samples = np.concatenate(
                [pcm[i, : spf[i]] for i in range(F)]
            ).reshape(-1)
    elif aligned:
        # uniform-except-last: transpose + trim fused in native code
        dec = native.decode_chains(words_be, state)
        total = int(spf.sum())
        samples = native.interleave_trim(dec, F, C, total).reshape(-1)
    else:
        dec = native.decode_chains(words_be, state)
        pcm = native.interleave_trim(dec, F, C, F * W20).reshape(F, W20, C)
        samples = np.concatenate(
            [pcm[i, : spf[i]] for i in range(F)]
        ).reshape(-1)
    return DecodedQoa(num_channels=C, sample_rate=rate, samples=samples)


def decode_all(data: bytes, backend: str = "auto", device=None) -> DecodedQoa:
    """Decode a complete QOA stream (``qoaudio_tpu.codec.decode_all``).

    On ``"torch"`` every frame x channel chain decodes in one launch.
    Raises IncompatibleFrame if channels or rate change mid-stream
    (reference: src/lib.rs:735-739), NoSamples on a stream with no frames.
    """
    backend = resolve_backend(backend, device)
    if backend == "native":
        _require_native()
        return _decode_all_native(data)
    if backend == "numpy":
        return _decode_numpy(data)
    return _decode_torch(data, device)


def open_and_decode_all(path, backend: str = "auto", device=None) -> DecodedQoa:
    """Open a file and decode it (reference: src/lib.rs:750-754)."""
    with open(path, "rb") as f:
        return decode_all(f.read(), backend=backend, device=device)


def _range_of(out: DecodedQoa, start: int, end: int) -> DecodedQoa:
    lo = min(start, out.samples_per_channel)
    hi = min(end, out.samples_per_channel)
    return DecodedQoa(
        num_channels=out.num_channels,
        sample_rate=out.sample_rate,
        samples=out.samples.reshape(-1, out.num_channels)[lo:hi].reshape(-1),
    )


def _decode_range_native(data: bytes, start: int, end: int) -> DecodedQoa:
    """The native engine's random-access decode: QOA frames are
    self-contained (every header carries the full LMS state, reference
    src/lib.rs:271-281), so only the frames covering the range decode.
    A non-uniform stream decodes whole."""
    geo = bs.parse_file_geometry(data)
    if (
        geo is not None
        and geo.channels in (1, 2)
        and geo.spc0 == geo.W0 * fmt.QOA_SLICE_LEN
        and native.has_fused_interleaved()
    ):
        # O(range) for real: the geometry probe is O(F) header words
        # (no gather), and the raw kernel decodes ONLY the covered
        # frames straight from the file bytes at their byte offset.
        C = geo.channels
        spc0 = geo.spc0
        tail_spc = geo.tail.samples_per_channel if geo.tail is not None else 0
        total = geo.F_full * spc0 + tail_spc
        start = min(start, total)
        end = min(end, total)
        if end <= start:
            return DecodedQoa(
                num_channels=C, sample_rate=geo.sample_rate,
                samples=np.empty(0, np.int16),
            )
        F = geo.F_full + (1 if geo.tail is not None else 0)
        f0 = start // spc0
        f1 = min(max(f0 + 1, -(-end // spc0)), F)
        nfull = max(0, min(f1, geo.F_full) - f0)
        rows_full = nfull * spc0
        tail_in = f1 > geo.F_full
        pcm = np.empty((rows_full + (tail_spc if tail_in else 0), C), np.int16)
        if nfull:
            native.decode_interleaved_raw(
                data, fmt.QOA_HEADER_SIZE + f0 * geo.frame_bytes, nfull,
                geo.frame_bytes, geo.W0, C, out=pcm[:rows_full],
            )
        if tail_in:
            pcm[rows_full:] = _decode_tail_fused(geo.tail, C)[:tail_spc]
        lo = start - f0 * spc0
        return DecodedQoa(
            num_channels=C, sample_rate=geo.sample_rate,
            samples=np.ascontiguousarray(pcm[lo : lo + end - start]).reshape(-1),
        )

    pa = bs.parse_file_arrays(data)
    if pa is None:
        return _range_of(_decode_all_native(data), start, end)
    C = pa.channels
    total = int(pa.samples_per_frame.sum())
    start = min(start, total)
    end = min(end, total)
    if end <= start:
        return DecodedQoa(
            num_channels=C, sample_rate=pa.sample_rate,
            samples=np.empty(0, np.int16),
        )
    # frame stride comes from the PARSED uniform frame size, not the 5120
    # maximum — the format allows any uniform samples-per-channel and
    # parse_file_arrays accepts it (reference reads spc from each header,
    # src/lib.rs:217-225)
    spc0 = int(pa.samples_per_frame[0])
    f0 = start // spc0
    f1 = min(max(f0 + 1, -(-end // spc0)), pa.n_frames)
    words = np.ascontiguousarray(pa.words_be[:, f0 * C : f1 * C])
    st = np.ascontiguousarray(pa.state[:, f0 * C : f1 * C])
    W20 = pa.max_windows * fmt.QOA_SLICE_LEN
    nf = f1 - f0
    if C in (1, 2) and native.has_fused_interleaved():
        full = native.decode_interleaved(words, st, C)
    else:
        dec = native.decode_chains(words, st)
        full = native.interleave_trim(dec, nf, C, nf * W20)
    if spc0 == W20 or nf == 1:
        # frames are window-aligned (or there is only one): the untrimmed
        # layout is contiguous-exact; slice off the short-tail pad rows
        pcm = full[: int(pa.samples_per_frame[f0:f1].sum())]
    else:
        # short final window inside non-final frames (spc0 % 20 != 0):
        # drop each frame's pad rows from the padded layout
        full = full.reshape(nf, W20, C)
        pcm = np.concatenate(
            [full[i, : int(pa.samples_per_frame[f0 + i])] for i in range(nf)]
        )
    lo = start - f0 * spc0
    return DecodedQoa(
        num_channels=C, sample_rate=pa.sample_rate,
        samples=np.ascontiguousarray(pcm[lo : lo + end - start]).reshape(-1),
    )


def decode_range(
    data: bytes, start: int, end: int, backend: str = "auto", device=None
) -> DecodedQoa:
    """Decode samples [start, end) per channel.

    The native engine decodes only the frames that cover the range.  The
    numpy backend and ``"torch"`` decode the whole stream, then slice the
    range, as the JAX package's device backend does.
    """
    if start < 0 or end < start:
        raise ValueError("need 0 <= start <= end")
    backend = resolve_backend(backend, device)
    if backend == "native":
        _require_native()
        return _decode_range_native(data, start, end)
    if backend == "numpy":
        return _range_of(_decode_numpy(data), start, end)
    return _range_of(_decode_torch(data, device), start, end)


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def _validate_desc(desc: QoaDesc) -> None:
    """Mirror QoaEncoder::new's validation (src/lib.rs:336-344).  The
    reference's u8/u32 field types make negative or >u32 values
    unrepresentable, so those reject with the same typed errors here."""
    if not 1 <= desc.channels <= fmt.QOA_MAX_CHANNELS:
        raise InvalidChannels()
    if not 1 <= desc.sample_rate <= 0xFFFFFFFF:
        raise InvalidSampleRate()
    if not 1 <= desc.samples <= 0xFFFFFFFF:
        raise InvalidSamples()


def layout_pcm(sample_data: np.ndarray, channels: int, samples: int):
    """Interleaved PCM -> kernel layout.

    Returns (samples (F, 256, 20, C) int16, lens (F, 256) int32, F).
    """
    T = samples
    C = channels
    F = -(-T // fmt.QOA_FRAME_LEN)
    pcm = np.asarray(sample_data).astype(np.int16).reshape(T, C)
    padded = np.zeros((F * fmt.QOA_FRAME_LEN, C), dtype=np.int16)
    padded[:T] = pcm
    x = padded.reshape(F, fmt.QOA_SLICES_PER_FRAME, fmt.QOA_SLICE_LEN, C)

    lens = np.full((F, fmt.QOA_SLICES_PER_FRAME), fmt.QOA_SLICE_LEN, np.int32)
    flat = lens.reshape(-1)
    n_windows_total = -(-T // fmt.QOA_SLICE_LEN)
    tail = T - (n_windows_total - 1) * fmt.QOA_SLICE_LEN
    flat[n_windows_total - 1] = tail
    flat[n_windows_total:] = 0
    return x, lens, F


def _encode_all_native(sample_data, desc: QoaDesc) -> bytes:
    """One-shot encode on the native 16-scalefactor-lane engine.

    Zero staging copies (the kernel reads the interleaved PCM in place —
    (W*20, C) row-major IS the interleaved layout; short final windows are
    bounded by ``lens``, reference src/lib.rs:470,484-487), one native call
    for all frames, and vectorized frame-byte assembly.
    """
    C = desc.channels
    T = desc.samples
    pcm = np.ascontiguousarray(
        np.asarray(sample_data, dtype=np.int16).reshape(T, C)
    )
    F = -(-T // fmt.QOA_FRAME_LEN)
    WPF = fmt.QOA_SLICES_PER_FRAME
    Wtot = F * WPF
    n_windows_total = -(-T // fmt.QOA_SLICE_LEN)
    lens = np.zeros(Wtot, np.int32)
    lens[:n_windows_total] = fmt.QOA_SLICE_LEN
    lens[n_windows_total - 1] = T - (n_windows_total - 1) * fmt.QOA_SLICE_LEN
    state = np.ascontiguousarray(initial_encoder_state(C))
    words, snaps = native.encode_file(pcm, lens, Wtot, WPF, state)
    return bs.assemble_stream_bytes(
        C, desc.sample_rate, T, snaps, words.reshape(F, WPF, C)
    )


def encode_all(
    sample_data, desc: QoaDesc, backend: str = "auto", device=None
) -> bytes:
    """One-shot encode of interleaved 16-bit PCM to QOA bytes.

    Bit-exact with the reference encoder (same search, same tie-breaks).
    On ``"torch"`` the frames go through the corpus layer's chunked path:
    the leading full frames on the full-window kernel, the rest on the
    masked one, 64 frames per launch with the LMS carried on the device.
    """
    _validate_desc(desc)
    sample_data = np.asarray(sample_data)
    if sample_data.size != desc.samples * desc.channels:
        raise InvalidSamples()
    backend = resolve_backend(backend, device)
    if backend == "native":
        _require_native()
        return _encode_all_native(sample_data, desc)
    if backend == "numpy":
        return encode_all_py(sample_data, desc.channels, desc.sample_rate,
                             desc.samples)
    return corpus.batch_encode([(sample_data, desc)], device)[0]


# Pairwise fallback events per paired window above which pairing two mono
# files stops paying against two straggler-free mono16 passes.  Measured
# breakeven ~1.5 for the JAX package's host tier, whose engine this is
# (experiments/cpp_encode_dual_mono.py: fixture music 0.40 -> 1.37x win,
# synthetic music 1.24 -> 1.24x win, noisy 1.77 / random 1.99 -> 0.76-0.79x
# loss).
_DUAL_MONO_BAIL = 1.5
# The pairing decision is made ONCE, from a 16-frame paired probe, then
# the rest of the pair runs unmonitored in one native call per mode (finer
# adaptive controllers measured 7-10% slower on both sides in the same
# experiment).
_DUAL_MONO_PROBE_FRAMES = 16


def _encode_two_mono_native(a, da: QoaDesc, b, db: QoaDesc) -> tuple[bytes, bytes]:
    """Encode two mono files as one pairwise C==2 chain, adaptively.

    The pairwise kernel's channels make fully independent decisions, so
    interleaving the files' common full-window prefix as a fake stereo
    signal and splitting the per-channel words/LMS snaps is byte-identical
    to encoding each alone, at up to 2x the aggregate rate.  The first
    ``_DUAL_MONO_PROBE_FRAMES`` frames run paired while watching the
    native engine's fallback counter: a probe rate above
    ``_DUAL_MONO_BAIL`` per window sends the rest of both files down the
    per-file mono16 path.  Byte-identity holds on either path.
    """
    SL = fmt.QOA_SLICE_LEN
    WPF = fmt.QOA_SLICES_PER_FRAME

    flat_a = np.ascontiguousarray(np.asarray(a, dtype=np.int16).reshape(-1))
    flat_b = np.ascontiguousarray(np.asarray(b, dtype=np.int16).reshape(-1))

    def grid(T):
        F = -(-T // fmt.QOA_FRAME_LEN)
        W = F * WPF
        nw = -(-T // SL)
        lens = np.zeros(W, np.int32)
        lens[:nw] = SL
        lens[nw - 1] = T - (nw - 1) * SL
        return lens, W, F

    lens_a, Wa, Fa = grid(da.samples)
    lens_b, Wb, Fb = grid(db.samples)
    words_a = np.zeros(Wa, np.uint64)
    words_b = np.zeros(Wb, np.uint64)
    snaps_a = np.zeros((Fa, 8), np.int32)
    snaps_b = np.zeros((Fb, 8), np.int32)
    state2 = np.ascontiguousarray(initial_encoder_state(2))

    # paired prefix: only full-20 windows can share the kernel's per-window
    # lens, and a partial window only ever ends a file
    wp = min(da.samples // SL, db.samples // SL)
    inter = np.empty((wp * SL, 2), np.int16)
    inter[:, 0] = flat_a[: wp * SL]
    inter[:, 1] = flat_b[: wp * SL]
    lens_full = np.full(wp, SL, np.int32)

    # 16-frame paired probe (the whole prefix if shorter), then ONE
    # unmonitored native call for the rest in the chosen mode.  Probe and
    # rest both start frame-aligned, so encode_file's interval-relative
    # snaps land exactly on frame indices.
    w = min(wp, _DUAL_MONO_PROBE_FRAMES * WPF)
    f0 = native.encode_fallbacks()
    if w:
        w2, s2 = native.encode_file(inter[: w * SL], lens_full[:w], w, WPF, state2)
        words_a[:w] = w2[:, 0]
        words_b[:w] = w2[:, 1]
        snaps_a[: s2.shape[0]] = s2[:, :, 0]
        snaps_b[: s2.shape[0]] = s2[:, :, 1]
    paired = native.encode_fallbacks() - f0 <= _DUAL_MONO_BAIL * max(w, 1)

    if paired and w < wp:
        w2, s2 = native.encode_file(
            inter[w * SL :], lens_full[w:], wp - w, WPF, state2
        )
        words_a[w:wp] = w2[:, 0]
        words_b[w:wp] = w2[:, 1]
        fr = w // WPF
        snaps_a[fr : fr + s2.shape[0]] = s2[:, :, 0]
        snaps_b[fr : fr + s2.shape[0]] = s2[:, :, 1]
        w = wp

    st_a = np.ascontiguousarray(state2[:, 0:1])
    st_b = np.ascontiguousarray(state2[:, 1:2])
    if not paired and w < wp:
        # straggler-heavy content: each file's remaining full windows run
        # mono16 in one call per file
        fr = w // WPF
        for flat, words, snaps, st in (
            (flat_a, words_a, snaps_a, st_a),
            (flat_b, words_b, snaps_b, st_b),
        ):
            w2, s2 = native.encode_file(
                flat[w * SL : wp * SL].reshape(-1, 1),
                lens_full[w:], wp - w, WPF, st,
            )
            words[w:wp] = w2[:, 0]
            snaps[fr : fr + s2.shape[0]] = s2[:, :, 0]
        w = wp

    # per-file mono16 finish: the longer file's surplus full windows, any
    # partial final window, and the zero-length padding windows of the
    # final frame (state passes through those).  Two native calls per
    # file: the head finishes the frame wp sits in (whose snap is already
    # recorded above), then one whole-tail encode_file.
    for flat, T, W, lens, words, snaps, st in (
        (flat_a, da.samples, Wa, lens_a, words_a, snaps_a, st_a),
        (flat_b, db.samples, Wb, lens_b, words_b, snaps_b, st_b),
    ):
        if wp >= W:
            continue
        tail = np.zeros((W - wp) * SL, np.int16)
        n_valid = max(0, T - wp * SL)
        tail[:n_valid] = flat[wp * SL : wp * SL + n_valid]
        ww = wp
        head = min(W, -(-ww // WPF) * WPF) - ww
        if head:
            words[ww : ww + head] = native.encode_windows(
                tail[: head * SL].reshape(-1, 1), lens[ww : ww + head], head, st,
            )[:, 0]
            ww += head
        if ww < W:
            w2, s2 = native.encode_file(
                tail[(ww - wp) * SL :].reshape(-1, 1), lens[ww:], W - ww, WPF, st,
            )
            words[ww:] = w2[:, 0]
            snaps[ww // WPF :] = s2[:, :, 0]

    return (
        bs.assemble_stream_bytes(
            1, da.sample_rate, da.samples,
            snaps_a.reshape(Fa, 8, 1), words_a.reshape(Fa, WPF, 1),
        ),
        bs.assemble_stream_bytes(
            1, db.sample_rate, db.samples,
            snaps_b.reshape(Fb, 8, 1), words_b.reshape(Fb, WPF, 1),
        ),
    )


def encode_all_batch(
    files, backend: str = "auto", device=None
) -> List[bytes]:
    """Encode many ``(interleaved_pcm, QoaDesc)`` files, in input order,
    each byte-identical to ``encode_all`` on that file alone.

    ``"torch"``: one ``corpus.batch_encode`` over all files' channels.
    ``"native"``: mono files pair up into the C==2 chain (nearest
    full-window counts together, :func:`_encode_two_mono_native`); the
    rest, and ``"numpy"``, encode file by file.
    """
    files = list(files)
    backend = resolve_backend(backend, device)
    if backend == "torch":
        return corpus.batch_encode(files, device)
    out: list = [None] * len(files)
    mono_idx = []
    for i, (pcm, desc) in enumerate(files):
        _validate_desc(desc)
        if np.asarray(pcm).size != desc.samples * desc.channels:
            raise InvalidSamples()
        if desc.channels == 1 and backend == "native" and native.available():
            mono_idx.append(i)
        else:
            out[i] = encode_all(pcm, desc, backend=backend)
    mono_idx.sort(key=lambda i: files[i][1].samples // fmt.QOA_SLICE_LEN)
    for k in range(0, len(mono_idx) - 1, 2):
        ia, ib = mono_idx[k], mono_idx[k + 1]
        out[ia], out[ib] = _encode_two_mono_native(
            files[ia][0], files[ia][1], files[ib][0], files[ib][1]
        )
    if len(mono_idx) % 2:
        i = mono_idx[-1]
        out[i] = encode_all(files[i][0], files[i][1], backend=backend)
    return out
