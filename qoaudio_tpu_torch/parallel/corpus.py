"""Batched multi-file corpus decode, encode and transcode on one device.

Port of ``qoaudio_tpu/parallel/corpus.py`` for a single device.  The
channels (encode) or frame x channel chains (decode) of many files pack
into one chain axis, so a whole corpus runs in a few kernel launches:

* ``batch_decode``    — all files' chains in one decode launch;
* ``batch_encode``    — all files' channels as encode chains, frames in
  launches of ``chunk_frames`` with the LMS carried on the device;
* ``batch_transcode`` — decode, then relayout ON THE DEVICE into the
  encoder's layout (one ``index_select`` plus a ``permute``), then encode:
  the PCM never leaves device memory, and only compressed words and LMS
  snapshots come back;
* ``transcode_corpus`` — files in, report out.

``device`` is explicit everywhere: a CPU device runs the kernels' plain
PyTorch versions, a CUDA device runs the kernels, and nothing moves from
one to the other.  Streams the device path cannot take (rejected by the
arithmetic parser, or multi-frame with non-standard frame sizes) go to the
host decode -> encode pair, which gives the same bytes; the module integer
``host_pair_files`` counts them.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from qoaudio_tpu import bitstream as bs
from qoaudio_tpu import codec
from qoaudio_tpu import format as fmt
from qoaudio_tpu.codec import initial_encoder_state
from qoaudio_tpu.errors import InvalidSamples
from qoaudio_tpu.types import DecodedQoa, QoaDesc

from ..ops import cuda_decode, cuda_encode
from ..utils.transfer import fetch_arrays, put_array, put_arrays

host_pair_files = 0  # files that took the host decode -> encode pair


@dataclasses.dataclass
class CorpusFile:
    path: str
    desc: QoaDesc
    pcm: np.ndarray  # interleaved int16


@dataclasses.dataclass
class TranscodeReport:
    files: List[str]
    total_samples: int
    encode_seconds: float
    decode_seconds: float
    results: List[dict]
    ok: bool = True

    def lines(self) -> List[str]:
        out = []
        for r in self.results:
            out.append(
                f"{r['path']}: {r['samples']} samples, "
                f"compression {r['ratio']:.2f}x, rms {r['rms']:.1f}"
                + (", bit-exact re-decode" if r["exact"] else "")
            )
        msps_enc = self.total_samples / self.encode_seconds / 1e6
        msps_dec = self.total_samples / self.decode_seconds / 1e6
        out.append(
            f"corpus: {len(self.files)} files, {self.total_samples} samples; "
            f"decode {msps_dec:.1f} Msamples/s, encode {msps_enc:.1f} Msamples/s"
        )
        return out


def _stage_words_be(parsed, offs, W: int, N: int):
    """Per-file raw BE words and LMS -> dense (words_be int64 (W, N),
    state int32 (8, N)).  The words stay big-endian: the decode kernel
    byteswaps them itself, so the upload is the compressed payload."""
    words_be = np.zeros((W, N), np.uint64)
    state = np.zeros((8, N), np.int32)
    for p, off in zip(parsed, offs):
        k = p.n_frames * p.channels
        words_be[: p.max_windows, off : off + k] = p.words_be
        state[:, off : off + k] = p.state
    return words_be.view(np.int64), state


def _decode_parsed(parsed, device):
    """Decode all files' chains in one launch -> ((W, 20, N) int16 on the
    device, chain offset of each file)."""
    W = max(p.max_windows for p in parsed)
    offs = []
    n = 0
    for p in parsed:
        offs.append(n)
        n += p.n_frames * p.channels
    words_be, state = _stage_words_be(parsed, offs, W, n)
    words_d, state_d = put_arrays([words_be, state], device)
    return cuda_decode.decode_chains_words(state_d, words_d), offs


def frame_major(dec: torch.Tensor, F: int, C: int) -> torch.Tensor:
    """Decoded chains (W, 20, F*C), chain = frame * C + channel -> the
    frames' untrimmed interleaved PCM (F, W*20, C), on the same device."""
    n_win = dec.shape[0]
    return (
        dec.reshape(n_win, fmt.QOA_SLICE_LEN, F, C)
        .permute(2, 0, 1, 3)
        .reshape(F, n_win * fmt.QOA_SLICE_LEN, C)
    )


def _interleave_file(dec_sub: torch.Tensor, p) -> torch.Tensor:
    """One file's decoded chains (W_i, 20, F*C) -> flat interleaved PCM,
    each frame trimmed to its sample count."""
    arr = frame_major(dec_sub, p.n_frames, p.channels)
    spf = p.samples_per_frame
    last = arr[-1, : int(spf[-1])].reshape(-1)
    if p.n_frames == 1:
        return last
    # every non-final frame of a parsed stream has spf[0] samples
    return torch.cat([arr[:-1, : int(spf[0])].reshape(-1), last])


def _encode_chunked(state, n_frames: int, chunk: int, f_full: int, stage):
    """Encode ``n_frames`` frames in launches of ``chunk`` frames, the LMS
    carried on the device.  ``stage(f0, f1, full)`` returns the chunk's
    (samples, lens) on the device (lens None when ``full``).  Chunks
    below ``f_full`` — where every window of every chain holds 20 samples
    — take the full-window kernel.  Returns (state, snaps, words) on the
    device.
    """
    snaps, words = [], []
    for f0 in range(0, n_frames, chunk):
        f1 = min(f0 + chunk, n_frames)
        full = f1 <= f_full
        x, lens = stage(f0, f1, full)
        if full:
            state, s, w = cuda_encode.encode_frames_full(state, x)
        else:
            state, s, w = cuda_encode.encode_frames(state, x, lens)
        snaps.append(s)
        words.append(w)
    return state, torch.cat(snaps), torch.cat(words)


def encode_chains(
    files: Sequence[tuple[np.ndarray, QoaDesc]],
    device,
    chunk_frames: int = 64,
    state: Optional[np.ndarray] = None,
):
    """Encode many PCM streams, each channel one chain, on ``device``.

    ``state`` is the int32 (8, N) LMS the chains start from (N = all
    files' channels in order; default: the encoder's initial state).
    Returns host arrays (state (8, N) after the last sample, snaps
    (F, 8, N), words (F, W, N) uint64 logical) and each file's first
    chain.  The last frame's padding windows pass the LMS through, so the
    returned state is the one after each file's last real sample.
    """
    for pcm, desc in files:
        codec._validate_desc(desc)
        if np.asarray(pcm).size != desc.samples * desc.channels:
            raise InvalidSamples()
    device = torch.device(device)

    layouts = [codec.layout_pcm(pcm, d.channels, d.samples) for pcm, d in files]
    F_max = max(F for _, _, F in layouts)
    # a corpus of sub-frame clips scans only the windows it has; trailing
    # zero-length windows pass LMS through, so dropping them is exact
    W_use = max(
        fmt.QOA_SLICES_PER_FRAME if F > 1 else -(-d.samples // fmt.QOA_SLICE_LEN)
        for (_, d), (_, _, F) in zip(files, layouts)
    )
    offsets = []
    n = 0
    for _, d in files:
        offsets.append(n)
        n += d.channels
    N = n
    f_full = min(d.samples // fmt.QOA_FRAME_LEN for _, d in files)

    def stage(f0, f1, full):
        # host staging per chunk (never the whole corpus), then one upload
        cx = np.zeros((f1 - f0, W_use, fmt.QOA_SLICE_LEN, N), np.int16)
        cl = np.zeros((f1 - f0, W_use, N), np.int32)
        for (_, d), (xf, lf, F), off in zip(files, layouts, offsets):
            k = min(F, f1) - f0
            if k > 0:
                cx[:k, :, :, off : off + d.channels] = xf[f0 : f0 + k, :W_use]
                cl[:k, :, off : off + d.channels] = lf[f0 : f0 + k, :W_use, None]
        if full:
            return put_array(cx, device), None
        cx_d, cl_d = put_arrays([cx, cl], device)
        return cx_d, cl_d

    if state is None:
        state = initial_encoder_state(0, N)
    state_d = put_array(np.ascontiguousarray(state, np.int32), device)
    state, snaps, words = fetch_arrays(
        _encode_chunked(state_d, F_max, chunk_frames, f_full, stage))
    return state, snaps, words.view(np.uint64), offsets


def batch_encode(
    files: Sequence[tuple[np.ndarray, QoaDesc]],
    device,
    chunk_frames: int = 64,
) -> List[bytes]:
    """Encode many PCM streams as one batched chain axis on ``device``.

    Returns QOA bytes per file, each bit-exact with single-file encoding
    (chains are independent; zero-length padding windows are inert).
    """
    if not files:
        return []
    _, snaps, words, offsets = encode_chains(files, device, chunk_frames)
    out: List[bytes] = []
    for (_, d), off in zip(files, offsets):
        C = d.channels
        out.append(
            bs.assemble_stream_bytes(
                C,
                d.sample_rate,
                d.samples,
                np.ascontiguousarray(snaps[:, :, off : off + C]),
                np.ascontiguousarray(words[:, :, off : off + C]),
            )
        )
    return out


def batch_decode(streams: Sequence[bytes], device) -> List[DecodedQoa]:
    """Decode many QOA streams in ONE decode launch on ``device``.

    Every frame header carries its LMS seed, so the chains of all files
    (frames x channels each) concatenate into one chain axis.  Streams the
    arithmetic parser rejects decode on the host, file by file; the rest
    of the corpus still batches.
    """
    global host_pair_files
    if not streams:
        return []
    device = torch.device(device)
    parsed = [bs.parse_file_arrays(d) for d in streams]
    if any(p is None for p in parsed):
        outs: List[Optional[DecodedQoa]] = [None] * len(streams)
        good = []
        for i, (d, p) in enumerate(zip(streams, parsed)):
            if p is None:
                host_pair_files += 1
                outs[i] = codec.decode_all(d)
            else:
                good.append(i)
        if good:
            for i, o in zip(good, decode_parsed([parsed[i] for i in good], device)):
                outs[i] = o
        return outs
    return decode_parsed(parsed, device)


def decode_parsed(parsed, device) -> List[DecodedQoa]:
    """Decode streams parsed by ``bs.parse_file_arrays`` in ONE decode
    launch on ``device``."""
    dec, offs = _decode_parsed(parsed, torch.device(device))
    flat = []
    for p, off in zip(parsed, offs):
        k = p.n_frames * p.channels
        flat.append(_interleave_file(dec[: p.max_windows, :, off : off + k], p))
    (pcm,) = fetch_arrays([torch.cat(flat)])
    outs = []
    pos = 0
    for p, t in zip(parsed, flat):
        n = t.numel()
        outs.append(
            DecodedQoa(
                num_channels=p.channels,
                sample_rate=p.sample_rate,
                samples=pcm[pos : pos + n],
            )
        )
        pos += n
    return outs


def _transcode_lens(samples: torch.Tensor, f0: int, f1: int, W_enc: int):
    """lens[f, w, j] = clip(min(samples_j - f*5120, 5120) - w*20, 0, 20)
    for frames f0 <= f < f1; int32 (f1 - f0, W_enc, Ne)."""
    dev = samples.device
    f_i = torch.arange(f0, f1, dtype=torch.int64, device=dev)[:, None, None]
    w_i = torch.arange(W_enc, dtype=torch.int64, device=dev)[None, :, None]
    spc = torch.clamp(samples[None, None, :] - f_i * fmt.QOA_FRAME_LEN,
                      0, fmt.QOA_FRAME_LEN)
    return torch.clamp(spc - w_i * fmt.QOA_SLICE_LEN, 0, fmt.QOA_SLICE_LEN
                       ).to(torch.int32)


def _relayout_index(metas, F: int, Ne: int) -> np.ndarray:
    """(F, Ne) decode-chain row of each (frame, encode chain).  Invalid
    slots (f >= F_i) point at row 0: their lens are 0, so the encoder
    passes state through and the per-file packing drops their output."""
    idx = np.zeros((F, Ne), np.int64)
    for F_i, C, doff, eoff in metas:
        for c in range(C):
            idx[:F_i, eoff + c] = doff + np.arange(F_i) * C + c
    return idx


def _relayout_encode_input(dec: torch.Tensor, idx: torch.Tensor, W_enc: int):
    """Decode layout (W, 20, Nd) -> encoder layout (F, W_enc, 20, Ne):
    one ``index_select`` over the chain axis with the (F, Ne) row index,
    then one ``permute``.  With standard 5120-sample frames, decoded sample
    (frame f, window w, offset k) of a file IS encoder sample (f, w, k)."""
    F, Ne = idx.shape
    x = dec[:W_enc].index_select(2, idx.reshape(-1))  # (W_enc, 20, F*Ne)
    x = x.reshape(W_enc, fmt.QOA_SLICE_LEN, F, Ne)
    return x.permute(2, 0, 1, 3).contiguous()


def _host_pair(d: bytes) -> bytes:
    out = codec.decode_all(d)
    return codec.encode_all(
        out.samples,
        QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel),
    )


def _device_eligible(p) -> bool:
    return p is not None and (
        p.n_frames == 1 or int(p.samples_per_frame[0]) == fmt.QOA_FRAME_LEN
    )


def batch_transcode(
    streams: Sequence[bytes],
    device,
    chunk_frames: int = 64,
) -> List[bytes]:
    """Transcode many QOA streams with the PCM device-resident end to end.

    The decode kernel's output re-lays out on the device into the
    encoder's frame layout and feeds the encoder directly; only the
    compressed slice words and LMS snapshots return to the host.  The
    encoder runs in launches of ``chunk_frames`` frames (which bounds the
    relayout's device memory), the leading all-full chunks on the
    full-window kernel.  Streams that are not fixed-layout, or multi-frame
    with non-standard frame sizes, go to the host decode -> encode pair,
    which gives identical bytes.
    """
    global host_pair_files
    if not streams:
        return []
    device = torch.device(device)
    parsed = [bs.parse_file_arrays(d) for d in streams]
    if not all(_device_eligible(p) for p in parsed):
        outs: List[Optional[bytes]] = [None] * len(streams)
        good = []
        for i, (d, p) in enumerate(zip(streams, parsed)):
            if _device_eligible(p):
                good.append(i)
            else:
                host_pair_files += 1
                outs[i] = _host_pair(d)
        if good:
            sub = batch_transcode([streams[i] for i in good], device, chunk_frames)
            for i, data in zip(good, sub):
                outs[i] = data
        return outs

    dec, doffs = _decode_parsed(parsed, device)  # (W, 20, Nd)

    eoffs = []
    n = 0
    for p in parsed:
        eoffs.append(n)
        n += p.channels
    Ne = n
    F_max = max(p.n_frames for p in parsed)
    W_enc = max(
        fmt.QOA_SLICES_PER_FRAME if p.n_frames > 1 else p.max_windows
        for p in parsed
    )
    samples = np.zeros(Ne, np.int64)  # samples/channel of each encode chain
    for p, eoff in zip(parsed, eoffs):
        samples[eoff : eoff + p.channels] = int(p.samples_per_frame.sum())
    f_full = int(samples.min()) // fmt.QOA_FRAME_LEN
    metas = tuple(
        (p.n_frames, p.channels, doff, eoff)
        for p, doff, eoff in zip(parsed, doffs, eoffs)
    )
    idx_d, samples_d = put_arrays([_relayout_index(metas, F_max, Ne), samples],
                                  device)

    def stage(f0, f1, full):
        x = _relayout_encode_input(dec, idx_d[f0:f1], W_enc)
        return x, None if full else _transcode_lens(samples_d, f0, f1, W_enc)

    state = put_array(initial_encoder_state(0, Ne), device)
    _, snaps_d, words_d = _encode_chunked(state, F_max, chunk_frames, f_full, stage)

    # tight per-file packing: only real compressed data crosses to the host
    sp = torch.cat([snaps_d[:F_i, :, e : e + C].reshape(-1)
                    for F_i, C, _, e in metas])
    wp = torch.cat([words_d[:F_i, :, e : e + C].reshape(-1)
                    for F_i, C, _, e in metas])
    sp, wp = fetch_arrays([sp, wp])
    wp = wp.view(np.uint64)

    out: List[bytes] = []
    o_w = o_s = 0
    for (F_i, C, _, _), p in zip(metas, parsed):
        nw = F_i * W_enc * C
        out.append(
            bs.assemble_stream_bytes(
                C,
                p.sample_rate,
                int(p.samples_per_frame.sum()),
                sp[o_s : o_s + F_i * 8 * C].reshape(F_i, 8, C),
                wp[o_w : o_w + nw].reshape(F_i, W_enc, C),
            )
        )
        o_w += nw
        o_s += F_i * 8 * C
    return out


def transcode_corpus(
    paths: Sequence[str],
    device,
    out_dir: Optional[str] = None,
    verify: bool = True,
) -> TranscodeReport:
    """Decode a set of QOA files, re-encode them batched, verify, report."""
    datas = []
    for p in paths:
        with open(p, "rb") as f:
            datas.append(f.read())
    t0 = time.perf_counter()
    outs = batch_decode(datas, device)
    decoded = [
        CorpusFile(
            path=p,
            desc=QoaDesc(d.num_channels, d.sample_rate, d.samples_per_channel),
            pcm=d.samples,
        )
        for p, d in zip(paths, outs)
    ]
    decode_seconds = time.perf_counter() - t0

    t0 = time.perf_counter()
    encoded = batch_encode([(c.pcm, c.desc) for c in decoded], device)
    encode_seconds = time.perf_counter() - t0

    results = []
    ok = True
    total = 0
    for c, data in zip(decoded, encoded):
        total += len(c.pcm)
        r = {
            "path": c.path,
            "samples": len(c.pcm),
            "ratio": (len(c.pcm) * 2) / len(data),
            "rms": 0.0,
            "exact": False,
        }
        if verify:
            again = codec.decode_all(data)
            err = again.samples.astype(np.float64) - c.pcm.astype(np.float64)
            r["rms"] = float(np.sqrt((err**2).mean()))
            r["exact"] = bool(np.array_equal(again.samples, c.pcm))
            if r["rms"] >= 500:
                ok = False
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            name = os.path.splitext(os.path.basename(c.path))[0] + ".qoa"
            with open(os.path.join(out_dir, name), "wb") as f:
                f.write(data)
        results.append(r)

    return TranscodeReport(
        files=list(paths),
        total_samples=total,
        encode_seconds=encode_seconds,
        decode_seconds=decode_seconds,
        results=results,
        ok=ok,
    )
