"""In-repo scalar oracle codec (pure Python + a vectorized numpy decoder).

A copy of ``qoaudio_tpu/reference.py``: the port's ``"numpy"`` backend.

This module is NOT the production path — it is the bit-exactness ground
truth the device kernels are tested against (the environment has no Rust
toolchain to run the upstream reference).  It mirrors the reference
implementation's semantics operation-for-operation:

* wrapping i32 arithmetic in predict/penalty/qoa_div
  (src/lib.rs:606-617, 797-818);
* the encoder's insertion-sorted 16-scalefactor search with early break /
  in-loop abandon and strict-< acceptance (src/lib.rs:495-596);
* the decoder's full-20-sample slice decode with post-hoc truncation
  (src/lib.rs:291-330).

The scalar encoder keeps the *original sequential* search shape on purpose:
it independently validates the parallel argmin + lexicographic tie-break
reformulation used by the device kernels.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from . import bitstream as bs
from . import format as fmt
from .errors import InvalidChannels, InvalidSampleRate, InvalidSamples

_QUANT = [int(x) for x in fmt.QOA_QUANT_TAB]
_RECIP = [int(x) for x in fmt.QOA_RECIPROCAL_TAB]
_DEQUANT = [[int(x) for x in row] for row in fmt.QOA_DEQUANT_TAB]

_U64_MAX = (1 << 64) - 1


def wrap32(x: int) -> int:
    """Two's-complement wrap to i32."""
    return ((x + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def qoa_div(v: int, scalefactor: int) -> int:
    """Reciprocal-multiply division with round-half-away-from-zero.

    Wrapping semantics per src/lib.rs:613-617.
    """
    reciprocal = _RECIP[scalefactor]
    n = wrap32(wrap32(v * reciprocal) + (1 << 15)) >> 16
    return (
        n
        + ((v > 0) - (v < 0))
        - ((n > 0) - (n < 0))
    )


@dataclasses.dataclass
class Lms:
    history: List[int]
    weights: List[int]

    @staticmethod
    def zero() -> "Lms":
        return Lms([0, 0, 0, 0], [0, 0, 0, 0])

    @staticmethod
    def encoder_init() -> "Lms":
        return Lms([0, 0, 0, 0], list(fmt.QOA_INITIAL_WEIGHTS))

    def copy(self) -> "Lms":
        return Lms(list(self.history), list(self.weights))

    def predict(self) -> int:
        h, w = self.history, self.weights
        p01 = wrap32(wrap32(w[0] * h[0]) + wrap32(w[1] * h[1]))
        p23 = wrap32(wrap32(w[2] * h[2]) + wrap32(w[3] * h[3]))
        return wrap32(p01 + p23) >> 13

    def predict_and_penalty_sq(self) -> Tuple[int, int]:
        h, w = self.history, self.weights
        p01 = wrap32(wrap32(w[0] * h[0]) + wrap32(w[1] * h[1]))
        p23 = wrap32(wrap32(w[2] * h[2]) + wrap32(w[3] * h[3]))
        prediction = wrap32(p01 + p23) >> 13
        s01 = wrap32(wrap32(w[0] * w[0]) + wrap32(w[1] * w[1]))
        s23 = wrap32(wrap32(w[2] * w[2]) + wrap32(w[3] * w[3]))
        penalty = max((wrap32(s01 + s23) >> 18) - 0x8FF, 0)
        return prediction, penalty * penalty

    def update(self, sample: int, residual: int) -> None:
        delta = residual >> 4
        for i in range(4):
            self.weights[i] = wrap32(
                self.weights[i] + (-delta if self.history[i] < 0 else delta)
            )
        self.history = [
            self.history[1],
            self.history[2],
            self.history[3],
            sample,
        ]


def _clamp_i16(v: int) -> int:
    return -32768 if v < -32768 else (32767 if v > 32767 else v)


# ---------------------------------------------------------------------------
# Scalar decoder
# ---------------------------------------------------------------------------

def decode_frame_record(rec: bs.FrameRecord) -> List[int]:
    """Decode one parsed frame to interleaved i16 samples (scalar path)."""
    channels = rec.channels
    sfs, codes = bs.unpack_slices(rec.slice_words)  # (W, C), (W, C, 20)
    lms = [
        Lms(list(map(int, rec.lms_history[c])), list(map(int, rec.lms_weights[c])))
        for c in range(channels)
    ]
    out = [0] * (rec.n_windows * fmt.QOA_SLICE_LEN * channels)
    for w in range(rec.n_windows):
        base = w * fmt.QOA_SLICE_LEN * channels
        for c in range(channels):
            sf = int(sfs[w, c])
            l = lms[c]
            idx = base + c
            for k in range(fmt.QOA_SLICE_LEN):
                prediction = l.predict()
                dequantized = _DEQUANT[sf][int(codes[w, c, k])]
                reconstructed = _clamp_i16(prediction + dequantized)
                out[idx] = reconstructed
                idx += channels
                l.update(reconstructed, dequantized)
    return out[: rec.samples_per_channel * channels]


def decode_all_py(data: bytes):
    """Scalar decode of a whole stream -> (channels, rate, samples list)."""
    parsed = bs.parse_file(data)
    if not parsed.frames:
        from .errors import NoSamples

        raise NoSamples()
    first = parsed.frames[0]
    samples: List[int] = []
    for rec in parsed.frames:
        samples.extend(decode_frame_record(rec))
    return first.channels, first.sample_rate, samples


# ---------------------------------------------------------------------------
# Vectorized numpy decoder (chains = frames x channels, full-speed host path)
# ---------------------------------------------------------------------------

def decode_batch_np(batch: bs.FrameBatch) -> np.ndarray:
    """Decode a FrameBatch -> int16 array (F, W*20, C), untrimmed.

    Pure numpy int32 with native wrapping; vectorized across all
    frame x channel chains (frames carry their own LMS seeds, so they
    decode in parallel — src/lib.rs:271-281).
    """
    F, W, C = batch.sf.shape
    N = F * C
    h = [batch.history[:, :, i].reshape(N).astype(np.int32) for i in range(4)]
    w = [batch.weights[:, :, i].reshape(N).astype(np.int32) for i in range(4)]
    dq_mag = fmt.QOA_DEQUANT_MAG  # (16, 4)
    out = np.empty((W, fmt.QOA_SLICE_LEN, N), dtype=np.int16)
    sf_all = batch.sf.reshape(F, W, C).transpose(1, 0, 2).reshape(W, N)
    codes_all = (
        batch.codes.reshape(F, W, C, fmt.QOA_SLICE_LEN)
        .transpose(1, 0, 2, 3)
        .reshape(W, N, fmt.QOA_SLICE_LEN)
    )
    for wi in range(W):
        sf = sf_all[wi].astype(np.intp)
        mag_rows = dq_mag[sf]  # (N, 4)
        for k in range(fmt.QOA_SLICE_LEN):
            code = codes_all[wi, :, k].astype(np.int32)
            pred = (
                w[0] * h[0] + w[1] * h[1] + w[2] * h[2] + w[3] * h[3]
            ) >> 13
            mag = np.take_along_axis(
                mag_rows, (code >> 1)[:, None].astype(np.intp), axis=1
            )[:, 0].astype(np.int32)
            dq = np.where((code & 1) == 0, mag, -mag).astype(np.int32)
            recon = np.clip(pred + dq, -32768, 32767).astype(np.int32)
            out[wi, k] = recon.astype(np.int16)
            delta = dq >> 4
            for t in range(4):
                w[t] = w[t] + np.where(h[t] < 0, -delta, delta)
            h[0], h[1], h[2] = h[1], h[2], h[3]
            h[3] = recon
    # (W, 20, N) -> (F, W*20, C)
    out = out.reshape(W, fmt.QOA_SLICE_LEN, F, C)
    return out.transpose(2, 0, 1, 3).reshape(F, W * fmt.QOA_SLICE_LEN, C)


def decode_all_np(data: bytes):
    """Vectorized host decode -> (channels, rate, int16 interleaved array)."""
    parsed = bs.parse_file(data)
    if not parsed.frames:
        from .errors import NoSamples

        raise NoSamples()
    batch = bs.stack_frames(parsed.frames)
    pcm = decode_batch_np(batch)  # (F, W*20, C)
    chunks = [
        pcm[i, : batch.samples_per_frame[i]].reshape(-1)
        for i in range(batch.n_frames)
    ]
    return batch.channels, batch.sample_rate, np.concatenate(chunks)


# ---------------------------------------------------------------------------
# Scalar encoder (sequential search — the oracle for tie-break equivalence)
# ---------------------------------------------------------------------------

def encode_slice_py(
    samples: List[int], lms: Lms
) -> Tuple[int, int, Lms]:
    """Brute-force best-of-16-scalefactor search for one <=20-sample window.

    Returns (slice_word_without_final_shift, best_scalefactor, best_lms).
    Reproduces the reference's insertion-sorted search order, early break
    and in-loop abandon (src/lib.rs:495-596).
    """
    slice_len = len(samples)
    first_predicted, first_penalty_sq = lms.predict_and_penalty_sq()
    first_sample = samples[0]
    first_residual = wrap32(first_sample - first_predicted)

    first_results = [None] * 16  # (quantized, dequantized, reconstructed, rank)
    sf_order: List[int] = []
    for sf in range(16):
        scaled = qoa_div(first_residual, sf)
        clamped = min(max(scaled, -8), 8)
        quantized = _QUANT[clamped + 8]
        dequantized = _DEQUANT[sf][quantized]
        reconstructed = _clamp_i16(first_predicted + dequantized)
        error = first_sample - reconstructed
        rank = error * error + first_penalty_sq
        first_results[sf] = (quantized, dequantized, reconstructed, rank)
        # stable insertion sort by rank (ties keep lower sf first)
        pos = len(sf_order)
        while pos > 0 and first_results[sf_order[pos - 1]][3] > rank:
            pos -= 1
        sf_order.insert(pos, sf)

    best_rank = _U64_MAX
    best_slice = 0
    best_scalefactor = 0
    best_lms = Lms.zero()

    for scalefactor in sf_order:
        l = lms.copy()
        quantized, dequantized, reconstructed, first_rank = first_results[
            scalefactor
        ]
        current_rank = first_rank
        if current_rank > best_rank:
            break
        l.update(reconstructed, dequantized)
        slice_word = ((scalefactor << 3) | quantized) & _U64_MAX

        valid = True
        for i in range(1, slice_len):
            sample = samples[i]
            predicted, penalty_sq = l.predict_and_penalty_sq()
            residual = wrap32(sample - predicted)
            scaled = qoa_div(residual, scalefactor)
            clamped = min(max(scaled, -8), 8)
            quantized = _QUANT[clamped + 8]
            dequantized = _DEQUANT[scalefactor][quantized]
            reconstructed = _clamp_i16(predicted + dequantized)
            error = sample - reconstructed
            current_rank += error * error + penalty_sq
            if current_rank > best_rank:
                valid = False
                break
            l.update(reconstructed, dequantized)
            slice_word = ((slice_word << 3) | quantized) & _U64_MAX

        if valid and current_rank < best_rank:
            best_rank = current_rank
            best_slice = slice_word
            best_scalefactor = scalefactor
            best_lms = l

    return best_slice, best_scalefactor, best_lms


class PyEncoder:
    """Scalar streaming encoder with carried LMS state across frames."""

    def __init__(self, channels: int, sample_rate: int, samples: int):
        if channels == 0 or channels > fmt.QOA_MAX_CHANNELS:
            raise InvalidChannels()
        if sample_rate == 0:
            raise InvalidSampleRate()
        if samples == 0:
            raise InvalidSamples()
        self.channels = channels
        self.sample_rate = sample_rate
        self.samples = samples
        self.lms = [Lms.encoder_init() for _ in range(channels)]
        self.prev_scalefactor = [0] * channels

    def encode_frame_bytes(self, sample_data: List[int]) -> bytes:
        channels = self.channels
        frame_len = len(sample_data) // channels
        n_windows = -(-frame_len // fmt.QOA_SLICE_LEN)
        frame_size = fmt.qoa_frame_size(channels, n_windows)
        header = fmt.pack_frame_header(
            self.channels, self.sample_rate, frame_len, frame_size
        )
        parts = [header.to_bytes(8, "big")]
        for c in range(channels):
            hist = 0
            wts = 0
            for i in range(4):
                hist = ((hist << 16) | (self.lms[c].history[i] & 0xFFFF)) & _U64_MAX
                wts = ((wts << 16) | (self.lms[c].weights[i] & 0xFFFF)) & _U64_MAX
            parts.append(hist.to_bytes(8, "big"))
            parts.append(wts.to_bytes(8, "big"))
        for start in range(0, frame_len, fmt.QOA_SLICE_LEN):
            slice_len = min(frame_len - start, fmt.QOA_SLICE_LEN)
            for c in range(channels):
                window = [
                    sample_data[(start + i) * channels + c]
                    for i in range(slice_len)
                ]
                word, best_sf, best_lms = encode_slice_py(window, self.lms[c])
                self.prev_scalefactor[c] = best_sf
                self.lms[c] = best_lms
                if slice_len < fmt.QOA_SLICE_LEN:
                    word = (
                        word << (3 * (fmt.QOA_SLICE_LEN - slice_len))
                    ) & _U64_MAX
                parts.append(word.to_bytes(8, "big"))
        return b"".join(parts)

    def encode(self, sample_data: List[int]) -> bytes:
        if len(sample_data) != self.samples * self.channels:
            raise InvalidSamples()
        out = [fmt.pack_file_header(self.samples)]
        total = self.samples
        idx = 0
        while idx < total:
            frame_len = min(total - idx, fmt.QOA_FRAME_LEN)
            start = idx * self.channels
            end = (idx + frame_len) * self.channels
            out.append(self.encode_frame_bytes(sample_data[start:end]))
            idx += frame_len
        return b"".join(out)


def encode_all_py(sample_data, channels: int, sample_rate: int, samples: int) -> bytes:
    enc = PyEncoder(channels, sample_rate, samples)
    return enc.encode(list(map(int, sample_data)))
