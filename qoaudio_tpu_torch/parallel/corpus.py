"""Batched multi-file corpus decode, encode and transcode, on one device or
over a mesh.

Port of ``qoaudio_tpu/parallel/corpus.py``.  The channels (encode) or
frame x channel chains (decode) of many files pack into one chain axis, so
a whole corpus runs in a few kernel launches:

* ``batch_decode``    — all files' chains in one decode launch (one per
  shard on a mesh);
* ``batch_encode``    — all files' channels as encode chains, frames in
  launches of ``chunk_frames`` with the LMS carried on the device (per
  shard, on its own device, on a mesh);
* ``batch_transcode`` — decode, then relayout ON THE DEVICE into the
  encoder's layout (one ``index_select`` plus a ``permute``), then encode:
  the PCM never leaves device memory, and only compressed words and LMS
  snapshots come back.  On a mesh whole files are partitioned over the
  devices, so a file's PCM stays on one device.  A mixed-length corpus may
  split into length buckets (``bucket="auto"``), and the staged device
  pipeline can be handed out (``return_fused_handle=True``);
* ``transcode_corpus`` — files in, report out.

Every call takes exactly one of ``device`` and ``mesh``
(``parallel/mesh.py``); a device is a one-device mesh.  A CPU device runs
the kernels' plain PyTorch versions, a CUDA device runs the kernels, and
nothing moves from one to the other.  Streams the device path cannot take
(rejected by the arithmetic parser, or multi-frame with non-standard frame
sizes) go to the host decode -> encode pair of the port's own codec (the
native engine, else ``"torch"`` on the call's device), which gives the
same bytes; the module integer ``host_pair_files`` counts them.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import math
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

# the port's codec imports this module: ``codec`` is bound while it is
# still importing, and only its functions are used, at call time
from .. import bitstream as bs
from .. import codec
from .. import format as fmt
from ..errors import InvalidSamples
from ..ops import cuda_decode, cuda_encode
from ..ops.layout import frame_major
from ..types import DecodedQoa, QoaDesc
from ..utils.transfer import fetch_arrays, put_arrays
from .mesh import (Mesh, decode_chains_sharded, encode_frames_sharded,
                   gather_chains, round_up, shard_chain_arrays)

host_pair_files = 0  # files that took the host decode -> encode pair

# Length-bucketing cost model (_length_buckets), in padded lane-frames.  On
# a CPU device: the JAX package's XLA model and constants, so the port
# buckets exactly where ``qoaudio_tpu`` does.  On CUDA devices one more
# sub-call costs about _CUDA_BUCKET_OVERHEAD_WAVES frames of one full
# resident wave of encode chains: a one-file transcode took 1.125 ms and
# one frame of a full wave (4,224 chains) 1.147 ms on an NVIDIA H100 80GB
# HBM3 at 700 W (chip_smoke.py phase 6 prints both on every run).
_BUCKET_OVERHEAD = 8192.0
_BUCKET_MIN_GAIN = 0.75
_CUDA_BUCKET_OVERHEAD_WAVES = 1.0


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


def _placement(device, mesh) -> Mesh:
    """The mesh a call runs on: ``mesh``, or ``device`` as a one-device
    mesh.  Exactly one of the two must be given."""
    if (device is None) == (mesh is None):
        raise ValueError("give exactly one of device= and mesh=")
    return mesh if mesh is not None else Mesh((torch.device(device),))


def _stage_words_be(parsed, offs, W: int, N: int):
    """Per-file raw BE words and LMS -> dense (words_be int64 (W, N),
    state int32 (8, N)); chains past the files' stay zero.  The words stay
    big-endian: the decode kernel byteswaps them itself, so the upload is
    the compressed payload."""
    words_be = np.zeros((W, N), np.uint64)
    state = np.zeros((8, N), np.int32)
    for p, off in zip(parsed, offs):
        k = p.n_frames * p.channels
        words_be[: p.max_windows, off : off + k] = p.words_be
        state[:, off : off + k] = p.state
    return words_be.view(np.int64), state


def _stage_decode(parsed, multiple: int = 1):
    """All files' decode chains -> (words_be, state) host arrays with the
    chain axis padded to a multiple of ``multiple``, and each file's first
    chain."""
    W = max(p.max_windows for p in parsed)
    offs = []
    n = 0
    for p in parsed:
        offs.append(n)
        n += p.n_frames * p.channels
    words_be, state = _stage_words_be(parsed, offs, W, round_up(n, multiple))
    return words_be, state, offs


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


def _encode_sharded(files, mesh: Mesh, chunk_frames: int, state=None):
    """Encode many PCM streams, each channel one chain, the chain axis
    padded to a multiple of the mesh size and sharded over it.

    Each chunk of ``chunk_frames`` frames is staged on the host (never the
    whole corpus) and every shard runs it on its own device, carrying its
    LMS there; leading all-full chunks take the full-window kernel.
    ``state`` is the int32 (8, N) LMS the chains start from (default: the
    encoder's initial state).  Returns host arrays (state (8, N), snaps
    (F, 8, N), words (F, W, N) uint64 logical) and each file's first chain.
    """
    for pcm, desc in files:
        codec._validate_desc(desc)
        if np.asarray(pcm).size != desc.samples * desc.channels:
            raise InvalidSamples()

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
    Np = round_up(N, mesh.size)  # padding chains run on lens 0, then drop
    f_full = min(d.samples // fmt.QOA_FRAME_LEN for _, d in files)

    start = codec.initial_encoder_state(0, Np)
    if state is not None:
        start[:, :N] = state
    (states,) = shard_chain_arrays(mesh, start)
    snaps, words = [], []  # per chunk, the per-shard device tensors
    for f0 in range(0, F_max, chunk_frames):
        f1 = min(f0 + chunk_frames, F_max)
        cx = np.zeros((f1 - f0, W_use, fmt.QOA_SLICE_LEN, Np), np.int16)
        cl = np.zeros((f1 - f0, W_use, Np), np.int32)
        for (_, d), (xf, lf, F), off in zip(files, layouts, offsets):
            k = min(F, f1) - f0
            if k > 0:
                cx[:k, :, :, off : off + d.channels] = xf[f0 : f0 + k, :W_use]
                cl[:k, :, off : off + d.channels] = lf[f0 : f0 + k, :W_use, None]
        states, s, w = encode_frames_sharded(
            mesh, states, cx, None if f1 <= f_full else cl)
        snaps.append(s)
        words.append(w)
    per_shard = range(mesh.size)
    snaps = gather_chains([torch.cat([c[k] for c in snaps]) for k in per_shard])
    words = gather_chains([torch.cat([c[k] for c in words]) for k in per_shard])
    state = gather_chains(states)
    return (state[:, :N], snaps[..., :N], words[..., :N].view(np.uint64),
            offsets)


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
    return _encode_sharded(files, _placement(device, None), chunk_frames, state)


def batch_encode(
    files: Sequence[tuple[np.ndarray, QoaDesc]],
    device=None,
    chunk_frames: int = 64,
    mesh: Optional[Mesh] = None,
) -> List[bytes]:
    """Encode many PCM streams as one batched chain axis on ``device``, or
    sharded over ``mesh``.

    Returns QOA bytes per file, each bit-exact with single-file encoding
    (chains are independent; zero-length padding windows are inert).
    """
    on = _placement(device, mesh)
    if not files:
        return []
    _, snaps, words, offsets = _encode_sharded(files, on, chunk_frames)
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


def batch_decode(streams: Sequence[bytes], device=None,
                 mesh: Optional[Mesh] = None) -> List[DecodedQoa]:
    """Decode many QOA streams in ONE decode launch on ``device``, or one
    launch per shard over ``mesh``.

    Every frame header carries its LMS seed, so the chains of all files
    (frames x channels each) concatenate into one chain axis.  Streams the
    arithmetic parser rejects decode on the host pair's codec, file by
    file; the rest of the corpus still batches.
    """
    global host_pair_files
    on = _placement(device, mesh)
    if not streams:
        return []
    parsed = [bs.parse_file_arrays(d) for d in streams]
    outs: List[Optional[DecodedQoa]] = [None] * len(streams)
    good = []
    for i, (d, p) in enumerate(zip(streams, parsed)):
        if p is None:
            host_pair_files += 1
            outs[i] = codec.decode_all(d, device=on.devices[0])
        else:
            good.append(i)
    if good:
        for i, o in zip(good, decode_parsed([parsed[i] for i in good], mesh=on)):
            outs[i] = o
    return outs


def _split_files(parts, parsed, offs) -> List[DecodedQoa]:
    """Decoded chains, split along the chain axis over shards (one part
    when one device decoded them all) -> each file's trimmed interleaved
    PCM.  A file interleaves on the device that holds its chains (on the
    host when they straddle two shards); each device's PCM is fetched in
    one copy, one wait for all."""
    starts = np.cumsum([0] + [t.shape[2] for t in parts]).tolist()
    per_device = {}  # device -> [(file index, flat PCM tensor)]
    for i, (p, off) in enumerate(zip(parsed, offs)):
        end = off + p.n_frames * p.channels
        pieces = [t[: p.max_windows, :, max(off - a, 0) : end - a]
                  for t, a, b in zip(parts, starts, starts[1:]) if a < end and off < b]
        sub = pieces[0] if len(pieces) == 1 else torch.cat([x.cpu() for x in pieces], 2)
        per_device.setdefault(sub.device, []).append((i, _interleave_file(sub, p)))
    groups = list(per_device.values())
    pcms = fetch_arrays([torch.cat([t for _, t in g]) for g in groups])
    samples: List[Optional[np.ndarray]] = [None] * len(parsed)
    for g, pcm in zip(groups, pcms):
        pos = 0
        for i, t in g:
            samples[i] = pcm[pos : pos + t.numel()]
            pos += t.numel()
    return [DecodedQoa(num_channels=p.channels, sample_rate=p.sample_rate, samples=x)
            for p, x in zip(parsed, samples)]


def decode_parsed(parsed, device=None, mesh: Optional[Mesh] = None) -> List[DecodedQoa]:
    """Decode streams parsed by ``bs.parse_file_arrays`` in ONE decode
    launch on ``device``, or one per shard over ``mesh``."""
    on = _placement(device, mesh)
    words_be, state, offs = _stage_decode(parsed, on.size)
    return _split_files(decode_chains_sharded(on, state, words_be), parsed, offs)


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


def _host_pair(d: bytes, device) -> bytes:
    out = codec.decode_all(d, device=device)
    return codec.encode_all(
        out.samples,
        QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel),
        device=device,
    )


def _device_eligible(p) -> bool:
    return p is not None and (
        p.n_frames == 1 or int(p.samples_per_frame[0]) == fmt.QOA_FRAME_LEN
    )


def _length_buckets(frame_counts, chans, e_mult, chunk_frames, overhead=None):
    """Partition files into frame-count buckets minimizing padded encode
    work (the JAX package's exact dynamic program).

    cost(bucket) = F_pad * ceil(Ne/e_mult)*e_mult + overhead, where F_pad
    is the bucket's longest file rounded up to its chunk, Ne its chains,
    ``e_mult`` the chains that cost the same as one (a TPU lane tile; on
    CUDA one resident wave of encode chains per device) and ``overhead``
    one more sub-call (default ``_BUCKET_OVERHEAD``).  The optimal
    partition is contiguous in length-sorted order.  Returns a list of
    index lists (input order within each bucket), or ``None`` when one
    call is within ``_BUCKET_MIN_GAIN`` of the optimum — always the case
    when every chain fits in one ``e_mult``.
    """
    if overhead is None:
        overhead = _BUCKET_OVERHEAD
    n = len(frame_counts)
    if n < 2:
        return None
    order = sorted(range(n), key=lambda i: (frame_counts[i], i))
    f_sorted = [frame_counts[i] for i in order]

    def fpad(fmax):
        chunk = min(chunk_frames, codec._next_pow2(int(fmax)))
        return -(-int(fmax) // chunk) * chunk

    fpads = [float(fpad(f)) for f in f_sorted]
    sums = [0]  # chains of the first i sorted files
    for i in order:
        sums.append(sums[-1] + chans[i])
    best, cut = [0.0], [0]
    for i in range(1, n + 1):
        # best[] never falls as files are added, so among the cuts j sharing
        # one value of ceil((sums[i] - sums[j]) / e_mult) only the first can
        # be the (first) argmin: test one cut per e_mult step, so a file
        # costs O(steps) with steps = ceil(sums[i] / e_mult), not a pass
        # over every earlier cut
        js = sorted({bisect.bisect_left(sums, sums[i] - e_mult * q, 0, i)
                     for q in range(1, math.ceil(sums[i] / e_mult) + 1)} - {i})
        costs = [best[j] + fpads[i - 1] * (
            math.ceil((sums[i] - sums[j]) / e_mult) * e_mult) + overhead for j in js]
        k = costs.index(min(costs))
        best.append(costs[k])
        cut.append(js[k])
    single = fpads[-1] * math.ceil(sums[n] / e_mult) * e_mult + overhead
    if not best[n] < _BUCKET_MIN_GAIN * single:
        return None
    segs, i = [], n
    while i > 0:
        j = cut[i]
        segs.append(sorted(order[j:i]))
        i = j
    segs.reverse()
    return segs


def _bucket_model(mesh: Mesh):
    """(e_mult, overhead) of :func:`_length_buckets` for a call on
    ``mesh``.  CUDA: every chain of one resident wave runs at once, so a
    corpus under a wave per device costs its longest chain and never
    buckets; past that, padded chains cost real time.  CPU: the JAX
    package's XLA model (``e_mult`` = the mesh size)."""
    devs = list(dict.fromkeys(mesh.devices))
    if devs[0].type == "cuda":
        e_mult = min(cuda_encode.chains_per_wave(d) for d in devs) * len(devs)
        return e_mult, float(round(_CUDA_BUCKET_OVERHEAD_WAVES * e_mult))
    return mesh.size, _BUCKET_OVERHEAD


class _CompositeFusedHandle:
    """Fused handles of every length bucket of one ``batch_transcode``
    call.  Calling it re-runs each bucket's pipeline in order and returns
    the LAST bucket's outputs — launches on one device run in the order
    they were issued, so waiting for those covers every bucket."""

    __slots__ = ("handles",)

    def __init__(self, handles):
        self.handles = handles

    def __call__(self):
        r = None
        for h in self.handles:
            r = h()
        return r


class TranscodeFusedHandle:
    """Handle onto one device's staged ``batch_transcode`` pipeline,
    returned by ``batch_transcode(..., return_fused_handle=True)``.

    Holds the device-resident staged arguments (raw BE words, decode
    state, relayout index, per-chain samples, initial encoder state, the
    packing's row index),
    which pins them in device memory while the handle lives, and ``fn``,
    which runs decode -> relayout -> lens -> chunked encode -> tight
    packing on them.  Calling the handle re-issues those launches with no
    host staging and returns the packed (snaps int32, words int64) device
    tensors, unfetched.  ``batch_transcode`` itself runs through the
    handle, so timing a call (with a synchronize) times exactly the device
    side of the end-to-end path.  ``assemble(snaps, words)`` turns the
    fetched host arrays into the files' bytes.
    """

    __slots__ = ("fn", "args", "assemble")

    def __init__(self, fn, args, assemble):
        self.fn = fn
        self.args = args
        self.assemble = assemble

    def __call__(self):
        return self.fn(*self.args)


def _transcode_pipeline(dstate, words_be, idx, samples, state, rows, *,
                        W_enc: int, chunk: int, f_full: int):
    """Step 2 of a transcode, all on the staged tensors' device: decode ->
    relayout -> lens -> chunked encode -> tight per-file packing.  Returns
    the packed (snaps, words) device tensors.  Chunks below ``f_full`` —
    where every window of every chain holds 20 samples — take the
    full-window kernel; the LMS carries across chunks on the device."""
    dec = cuda_decode.decode_chains_words(dstate, words_be)  # (W, 20, Nd)
    n_frames = idx.shape[0]
    snaps, words = [], []
    for f0 in range(0, n_frames, chunk):
        f1 = min(f0 + chunk, n_frames)
        x = _relayout_encode_input(dec, idx[f0:f1], W_enc)
        if f1 <= f_full:
            state, s, w = cuda_encode.encode_frames_full(state, x)
        else:
            lens = _transcode_lens(samples, f0, f1, W_enc)
            state, s, w = cuda_encode.encode_frames(state, x, lens)
        snaps.append(s)
        words.append(w)
    snaps, words = torch.cat(snaps), torch.cat(words)
    # tight packing, one gather each: every chain's real frames (row
    # chain * F + frame), file by file; only real compressed data crosses
    # to the host
    sp = snaps.permute(2, 0, 1).reshape(-1, 8).index_select(0, rows)
    wp = words.permute(2, 0, 1).reshape(-1, W_enc).index_select(0, rows)
    return sp, wp


def _assemble_transcode(parsed, W_enc: int, sp: np.ndarray,
                        wp: np.ndarray) -> List[bytes]:
    """Step 3: the fetched packed rows (chain, frame) -> each file's bytes."""
    wp = wp.view(np.uint64)
    out: List[bytes] = []
    r = 0
    for p in parsed:
        F_i, C = p.n_frames, p.channels
        n = F_i * C
        out.append(
            bs.assemble_stream_bytes(
                C,
                p.sample_rate,
                int(p.samples_per_frame.sum()),
                sp[r : r + n].reshape(C, F_i, 8).transpose(1, 2, 0),
                wp[r : r + n].reshape(C, F_i, W_enc).transpose(1, 2, 0),
            )
        )
        r += n
    return out


def _stage_transcode(parsed, device, chunk_frames: int) -> TranscodeFusedHandle:
    """Step 1 of a transcode: stage the files' words and the relayout on
    the host and upload them to ``device``; returns the handle onto
    step 2."""
    words_be, dstate, doffs = _stage_decode(parsed)
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
    frames = np.zeros(Ne, np.int64)  # frames of each encode chain
    for p, eoff in zip(parsed, eoffs):
        samples[eoff : eoff + p.channels] = int(p.samples_per_frame.sum())
        frames[eoff : eoff + p.channels] = p.n_frames
    metas = tuple(
        (p.n_frames, p.channels, doff, eoff)
        for p, doff, eoff in zip(parsed, doffs, eoffs)
    )
    # packed row of (chain j, frame f < frames[j]): j * F_max + f, chain-major
    first = np.repeat(np.cumsum(frames) - frames, frames)
    rows = np.repeat(np.arange(Ne) * F_max, frames) + np.arange(int(frames.sum())) - first
    args = put_arrays(
        [dstate, words_be, _relayout_index(metas, F_max, Ne), samples,
         codec.initial_encoder_state(0, Ne), rows],
        device,
    )
    fn = functools.partial(
        _transcode_pipeline, W_enc=W_enc, chunk=chunk_frames,
        f_full=int(samples.min()) // fmt.QOA_FRAME_LEN,
    )
    return TranscodeFusedHandle(
        fn, tuple(args), functools.partial(_assemble_transcode, parsed, W_enc))


def _file_groups(parsed, n_groups: int) -> List[List[int]]:
    """Partition files over ``n_groups`` devices, balancing encode work:
    files go longest chain first (then samples x channels) to the device
    with the least work so far.  Each group keeps input order."""
    work = [int(p.samples_per_frame.sum()) * p.channels for p in parsed]
    order = sorted(range(len(parsed)),
                   key=lambda i: (-parsed[i].n_frames, -work[i], i))
    load = [0] * n_groups
    groups: List[List[int]] = [[] for _ in range(n_groups)]
    for i in order:
        g = min(range(n_groups), key=lambda k: (load[k], k))
        groups[g].append(i)
        load[g] += work[i]
    return [sorted(g) for g in groups]


def _transcode_groups(parsed, mesh: Mesh, chunk_frames: int):
    """Every device group's pipeline issued before any fetch, then one
    fetch and the assembly.  Returns (bytes per file, handle per group)."""
    runs = []
    for dev, idx in zip(mesh.devices, _file_groups(parsed, mesh.size)):
        if idx:  # a device with no files launches nothing
            h = _stage_transcode([parsed[i] for i in idx], dev, chunk_frames)
            runs.append((idx, h, h()))
    fetched = fetch_arrays([t for _, _, packed in runs for t in packed])
    outs: List[Optional[bytes]] = [None] * len(parsed)
    for k, (idx, h, _) in enumerate(runs):
        for i, data in zip(idx, h.assemble(*fetched[2 * k : 2 * k + 2])):
            outs[i] = data
    return outs, [h for _, h, _ in runs]


def _transcode(streams, parsed, mesh: Mesh, chunk_frames: int, bucket,
               one_device: bool):
    """``batch_transcode`` on parsed streams -> (bytes per file, handle)."""
    global host_pair_files
    if not all(_device_eligible(p) for p in parsed):
        # only the ineligible streams pay the host pair; the rest of the
        # corpus still runs the device pipeline
        outs: List[Optional[bytes]] = [None] * len(streams)
        good = []
        for i, (d, p) in enumerate(zip(streams, parsed)):
            if _device_eligible(p):
                good.append(i)
            else:
                host_pair_files += 1
                outs[i] = _host_pair(d, mesh.devices[0])
        handle = None
        if good:
            sub, handle = _transcode([streams[i] for i in good],
                                     [parsed[i] for i in good], mesh,
                                     chunk_frames, bucket, one_device)
            for i, data in zip(good, sub):
                outs[i] = data
        return outs, handle

    if bucket:
        e_mult, overhead = _bucket_model(mesh)
        segs = _length_buckets([p.n_frames for p in parsed],
                               [p.channels for p in parsed], e_mult,
                               chunk_frames, overhead)
        if segs is not None:
            outs = [None] * len(streams)
            handles = []
            for seg in segs:
                sub, h = _transcode([streams[i] for i in seg],
                                    [parsed[i] for i in seg], mesh,
                                    chunk_frames, False, one_device)
                if h is not None:
                    handles.append(h)
                for i, data in zip(seg, sub):
                    outs[i] = data
            return outs, _CompositeFusedHandle(handles) if handles else None

    outs, handles = _transcode_groups(parsed, mesh, chunk_frames)
    return outs, handles[0] if one_device else None


def batch_transcode(
    streams: Sequence[bytes],
    device=None,
    chunk_frames: int = 64,
    mesh: Optional[Mesh] = None,
    *,
    return_fused_handle: bool = False,
    bucket="auto",
):
    """Transcode many QOA streams with the PCM device-resident end to end.

    The decode kernel's output re-lays out on the device into the
    encoder's frame layout and feeds the encoder directly; only the
    compressed slice words and LMS snapshots return to the host.  The
    encoder runs in launches of ``chunk_frames`` frames (which bounds the
    relayout's device memory), the leading all-full chunks on the
    full-window kernel.  Streams that are not fixed-layout, or multi-frame
    with non-standard frame sizes, go to the host decode -> encode pair,
    which gives identical bytes.

    With ``mesh`` whole files are partitioned over its devices, balanced
    by encode work, and each device runs the pipeline on its own files:
    every device's launches are issued before anything is fetched, and no
    PCM crosses between devices.  Bytes do not depend on the partition.

    ``bucket="auto"`` (default) splits a mixed-length corpus into
    frame-count buckets, each its own sub-call, where
    :func:`_length_buckets` finds that it cuts padded encode work by at
    least 1/0.75; ``bucket=False`` forces one call.  Bucketing never
    changes bytes.

    With ``return_fused_handle=True`` the return value is ``(outs,
    handle)``: a :class:`TranscodeFusedHandle` onto the staged device
    pipeline (covering the device-eligible files when some took the host
    pair; a ``_CompositeFusedHandle`` when the call bucketed), or ``None``
    for an empty corpus and on the ``mesh`` path.
    """
    on = _placement(device, mesh)
    if not streams:
        outs, handle = [], None
    else:
        parsed = [bs.parse_file_arrays(d) for d in streams]
        outs, handle = _transcode(streams, parsed, on, chunk_frames, bucket,
                                  one_device=mesh is None)
    return (outs, handle) if return_fused_handle else outs


def transcode_corpus(
    paths: Sequence[str],
    device=None,
    out_dir: Optional[str] = None,
    verify: bool = True,
    mesh: Optional[Mesh] = None,
) -> TranscodeReport:
    """Decode a set of QOA files, re-encode them batched, verify, report."""
    on = _placement(device, mesh)
    datas = []
    for p in paths:
        with open(p, "rb") as f:
            datas.append(f.read())
    t0 = time.perf_counter()
    outs = batch_decode(datas, device, mesh)
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
    encoded = batch_encode([(c.pcm, c.desc) for c in decoded], device, mesh=mesh)
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
            again = codec.decode_all(data, device=on.devices[0])
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
