"""Batched multi-file corpus decode, encode and transcode, on one device or
over a mesh.

Port of ``qoaudio_tpu/parallel/corpus.py``.  The channels (encode) or
frame x channel chains (decode) of many files pack into one chain axis, so
a whole corpus runs in a few kernel launches.

One rule places files on devices, on every path: :func:`_file_groups`
gives each device of the mesh whole files, balanced by encode work, so a
file's chains always lie on one device.  Each non-empty group runs the
path's one-device body on its own device, every group's work is issued
before one fetch brings all their outputs back, and the host cuts them
into files (:func:`_run_groups`).  A device is a one-device mesh: its one
group is every file, in input order.

* ``batch_decode``    — a group's chains in one decode launch, each file
  interleaved on the device;
* ``batch_encode``    — a group's channels as encode chains, frames in
  launches of ``chunk_frames`` with the LMS carried on the device; the
  group's PCM is uploaded once, as it is interleaved, and laid out for the
  encoder on the device (one gather a chunk); its streams are assembled on
  the device;
* ``batch_transcode`` — a group's streams uploaded once, as they are, and
  gathered into decode chains on the device (``ops.cuda_gather``); decode,
  then relayout ON THE DEVICE into the encoder's layout (one
  ``index_select`` plus a ``permute``), then encode and assemble the
  streams: the PCM never leaves device memory, and only the streams'
  bytes come back.  The host reads each stream's geometry alone
  (``bitstream.parse_file_geometry``).  A mixed-length corpus may split into
  length buckets (``bucket="auto"``), each placed by the same rule, and
  the staged device pipeline can be handed out
  (``return_fused_handle=True``);
* ``transcode_corpus`` — files in, report out.

Every call takes exactly one of ``device`` and ``mesh``
(``parallel/mesh.py``).  A CPU device runs the kernels' plain PyTorch
versions, a CUDA device runs the kernels, and nothing moves from one to
the other.  Streams the device path cannot take
(rejected by the arithmetic parser, or multi-frame with non-standard frame
sizes) go to the host decode -> encode pair of the port's own codec (the
native engine, else ``"torch"`` on the call's device), which gives the
same bytes; the module integer ``host_pair_files`` counts them.

The streams' bytes are written on the device, every file of a device
group back to back in one uint8 tensor (``ops.cuda_assemble``: the kernel
on a CUDA device, its plain version on a CPU device), from a per-file
table built on the host (``ops.assemble.file_table``); one fetch brings
them back, and the host only cuts the buffer at the table's offsets.

Under a running ``torch.profiler`` each host stage of a call is a span
(``utils/timing.span``), once per stage and device group, never per file:
``qoa.parse``, ``qoa.host_pair`` (the eligibility split and the files
that take the host pair), ``qoa.stage`` (host arrays: file groups, the
transcode's stream buffer and tables, the encode checks and the flat PCM
buffer) with
``qoa.bucket`` inside (the length-bucket choice), ``qoa.upload``
(``put_arrays``), ``qoa.pipeline`` (queuing the device work),
``qoa.fetch`` with ``qoa.wait`` inside (``fetch_arrays``) and
``qoa.assemble`` (cutting the fetched bytes into files).
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import itertools
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
from .. import native
from ..errors import InvalidSamples
from ..ops import assemble, cuda_assemble, cuda_decode, cuda_encode, cuda_gather, gather
from ..ops.layout import frame_major
from ..types import DecodedQoa, QoaDesc
from ..utils.timing import span
from ..utils.transfer import fetch_arrays, put_arrays
from .mesh import Mesh

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
# index elements ``_encode_input`` builds at once: 256 MB of int64
_GATHER_ELEMENTS = 1 << 25


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


def _stage_words_be(parsed, offs, W: int, N: int, pin: bool = False):
    """Per-file raw BE words and LMS -> dense (words_be int64 (W, N),
    state int32 (8, N)) of the files' N chains back to back; a file's
    windows past its own stay zero.  The words stay
    big-endian: the decode kernel byteswaps them itself, so the upload is
    the compressed payload.  With ``pin`` the two are torch tensors in
    pinned memory, which the caching host allocator hands out again call
    after call, uploaded as they are; else numpy arrays."""
    words_t = torch.empty((W, N), dtype=torch.int64, pin_memory=pin)
    state_t = torch.empty((8, N), dtype=torch.int32, pin_memory=pin)
    words_be, state = words_t.numpy().view(np.uint64), state_t.numpy()
    for p, off in zip(parsed, offs):
        k = p.n_frames * p.channels
        words_be[: p.max_windows, off : off + k] = p.words_be
        words_be[p.max_windows :, off : off + k] = 0
        state[:, off : off + k] = p.state
    return (words_t, state_t) if pin else (words_be.view(np.int64), state)


def _stage_decode(parsed, pin: bool = False):
    """All files' decode chains -> (words_be, state) host arrays, and each
    file's first chain; pinned tensors with ``pin``
    (:func:`_stage_words_be`)."""
    W = max(p.max_windows for p in parsed)
    offs = []
    n = 0
    for p in parsed:
        offs.append(n)
        n += p.n_frames * p.channels
    words_be, state = _stage_words_be(parsed, offs, W, n, pin)
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


def _stage_encode_pcm(files, device):
    """Every file's interleaved PCM, in input order, copied once into one
    int16 host buffer (pinned on a CUDA device), each file followed by as
    many zeros as it has channels, and uploaded to ``device`` as it is.
    Returns the device buffer and the int64 (3, N) (base, stride, samples)
    of every chain, the files' channels in order: chain j reads its sample
    t at base_j + min(t, samples_j) * stride_j, a zero from its end on."""
    sizes = [d.samples * d.channels for _, d in files]
    starts = np.cumsum([0] + [n + d.channels for n, (_, d) in zip(sizes, files)])
    buf = torch.empty(int(starts[-1]), dtype=torch.int16,
                      pin_memory=torch.device(device).type == "cuda")
    host = buf.numpy()
    vec = np.empty((3, sum(d.channels for _, d in files)), np.int64)
    j = 0
    for (pcm, d), s, n in zip(files, starts, sizes):
        a = np.asarray(pcm)
        np.copyto(host[s : s + n].reshape(a.shape), a, casting="unsafe")
        host[s + n : s + n + d.channels] = 0
        vec[0, j : j + d.channels] = s + np.arange(d.channels)
        vec[1:, j : j + d.channels] = [[d.channels], [d.samples]]
        j += d.channels
    with span("qoa.upload"):
        flat = buf.to(device, non_blocking=True)
    return flat, vec


def _encode_input(flat: torch.Tensor, vec: torch.Tensor, f0: int, f1: int,
                  W_use: int) -> torch.Tensor:
    """Frames f0 <= f < f1 of one device group's encoder input, int16
    (f1 - f0, W_use, 20, n), gathered on the device from its flat PCM:
    x[f, w, k, j] = flat[base_j + min(t, samples_j) * stride_j] for
    t = f*5120 + w*20 + k, zero from chain j's end on.  The index is
    built on the device, a few frames at a time."""
    base, stride, samples = vec
    x = torch.empty((f1 - f0, W_use, fmt.QOA_SLICE_LEN, vec.shape[1]),
                    dtype=torch.int16, device=flat.device)
    t = torch.arange(f0 * fmt.QOA_FRAME_LEN, f1 * fmt.QOA_FRAME_LEN,
                     device=flat.device).view(
        f1 - f0, fmt.QOA_SLICES_PER_FRAME, fmt.QOA_SLICE_LEN)[:, :W_use, :, None]
    step = max(1, _GATHER_ELEMENTS // x[0].numel())
    for a in range(0, f1 - f0, step):
        idx = torch.minimum(t[a : a + step], samples).mul_(stride).add_(base)
        torch.index_select(flat, 0, idx.view(-1), out=x[a : a + step].view(-1))
    return x


@dataclasses.dataclass
class _EncodeStaged:
    """What ``_stage_encode`` leaves on one device: each file's first
    chain, the frames and windows the chunks run, the frames every chain
    has full, and the flat PCM, chain vectors and start state."""

    offsets: List[int]
    F_max: int
    W_use: int
    f_full: int
    flat: torch.Tensor
    vec: torch.Tensor
    state: torch.Tensor


def _stage_encode(files, device, state=None) -> _EncodeStaged:
    """The encode's host side, inside the caller's ``qoa.stage``: checks,
    the start state, the flat PCM buffer and the uploads to ``device``."""
    for pcm, desc in files:
        codec._validate_desc(desc)
        if np.asarray(pcm).size != desc.samples * desc.channels:
            raise InvalidSamples()

    F_max = max(-(-d.samples // fmt.QOA_FRAME_LEN) for _, d in files)
    # a corpus of sub-frame clips scans only the windows it has; trailing
    # zero-length windows pass LMS through, so dropping them is exact
    W_use = max(
        fmt.QOA_SLICES_PER_FRAME if d.samples > fmt.QOA_FRAME_LEN
        else -(-d.samples // fmt.QOA_SLICE_LEN)
        for _, d in files
    )
    offsets = []
    n = 0
    for _, d in files:
        offsets.append(n)
        n += d.channels
    f_full = min(d.samples // fmt.QOA_FRAME_LEN for _, d in files)

    start = codec.initial_encoder_state(0, n)
    if state is not None:
        start[:] = state
    flat, vec = _stage_encode_pcm(files, device)
    start, vec = put_arrays([start, vec], device)
    return _EncodeStaged(offsets, F_max, W_use, f_full, flat, vec, start)


def _cat(parts: List[torch.Tensor]) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _encode_run(st: _EncodeStaged, chunk_frames: int):
    """The staged encode on its device: each chunk of ``chunk_frames``
    frames laid out for the encoder there (``_encode_input``), which runs
    it, carrying its LMS; leading all-full chunks take the full-window
    kernel.  Returns device tensors: state (8, N), snaps (F_max, 8, N),
    words (F_max, W_use, N) int64 logical."""
    state = st.state
    snaps, words = [], []
    for f0 in range(0, st.F_max, chunk_frames):
        f1 = min(f0 + chunk_frames, st.F_max)
        with span("qoa.pipeline"):
            x = _encode_input(st.flat, st.vec, f0, f1, st.W_use)
            if f1 <= st.f_full:
                state, s, w = cuda_encode.encode_frames_full(state, x)
            else:
                state, s, w = cuda_encode.encode_frames(
                    state, x, _transcode_lens(st.vec[2], f0, f1, st.W_use))
        snaps.append(s)
        words.append(w)
    return state, _cat(snaps), _cat(words)


def encode_chains(
    files: Sequence[tuple[np.ndarray, QoaDesc]],
    device,
    chunk_frames: int = 64,
    state: Optional[np.ndarray] = None,
):
    """Encode many PCM streams, each channel one chain, on ``device``: the
    staging and chunked encode of ``batch_encode``'s device group, with no
    assembly.

    ``state`` is the int32 (8, N) LMS the chains start from (N = all
    files' channels in order; default: the encoder's initial state).
    Returns host arrays (state (8, N) after the last sample, snaps
    (F, 8, N), words (F, W, N) uint64 logical), fetched together, and each
    file's first chain.  The last frame's padding windows pass the LMS
    through, so the returned state is the one after each file's last real
    sample.
    """
    with span("qoa.stage"):
        st = _stage_encode(files, _placement(device, None).devices[0], state)
    state, snaps, words = fetch_arrays(_encode_run(st, chunk_frames))
    return state, snaps, words.view(np.uint64), st.offsets


def _cut(buf: np.ndarray, offsets) -> List[bytes]:
    """One fetched buffer of streams laid back to back -> each stream's
    bytes, from its offset to the next one's."""
    mv = memoryview(buf)
    ends = [*offsets[1:], len(buf)]
    return [mv[a:b].tobytes() for a, b in zip(offsets, ends)]


def _assemble(offsets: List[int], buf: np.ndarray) -> List[bytes]:
    """A device group's fetched streams -> each file's bytes."""
    with span("qoa.assemble"):
        return _cut(buf, offsets)


def _file_groups(frames, work, n_groups: int) -> List[List[int]]:
    """The one placement rule of the corpus layer: whole files over
    ``n_groups`` devices, balancing encode work.  ``frames`` and ``work``
    are each file's frame count and samples x channels.  Files go longest
    chain first (then most work, then input order) to the device with the
    least work so far; each group keeps input order.  One device takes
    every file, in input order."""
    if n_groups == 1:
        return [list(range(len(frames)))]
    order = sorted(range(len(frames)), key=lambda i: (-frames[i], -work[i], i))
    load = [0] * n_groups
    groups: List[List[int]] = [[] for _ in range(n_groups)]
    for i in order:
        g = min(range(n_groups), key=lambda k: (load[k], k))
        groups[g].append(i)
        load[g] += work[i]
    return [sorted(g) for g in groups]


def _parsed_load(parsed):
    """(frames, samples x channels) of each parsed stream, for
    :func:`_file_groups`."""
    return ([p.n_frames for p in parsed],
            [int(p.samples_per_frame.sum()) * p.channels for p in parsed])


def _run_groups(mesh: Mesh, groups, launch) -> list:
    """Every non-empty device group's work issued, then one fetch and the
    cut.  ``launch(device, idx)`` stages and queues the files ``idx`` on
    ``device`` and returns (the device tensor of their output, a function
    from its fetched array to their results in order).  Returns each
    file's result; a device with no files launches nothing.  The outputs
    stay on a heap that is never trimmed (:func:`native.tune_allocator`):
    ``batch_encode`` parses no stream, so without this a process that only
    encodes faults its bytes in afresh, call after call, until its heap
    settles."""
    native.tune_allocator()
    runs = [(idx, *launch(dev, idx)) for dev, idx in zip(mesh.devices, groups) if idx]
    out: list = [None] * sum(len(g) for g in groups)
    for (idx, _, cut), got in zip(runs, fetch_arrays([t for _, t, _ in runs])):
        for i, r in zip(idx, cut(got)):
            out[i] = r
    return out


def batch_encode(
    files: Sequence[tuple[np.ndarray, QoaDesc]],
    device=None,
    chunk_frames: int = 64,
    mesh: Optional[Mesh] = None,
) -> List[bytes]:
    """Encode many PCM streams as one batched chain axis on ``device``, or
    over ``mesh``, each device with whole files (:func:`_file_groups`).

    Returns QOA bytes per file, each bit-exact with single-file encoding
    (chains are independent; zero-length padding windows are inert).  A
    file's chains lie on one device, whose one assembly launch
    (``cuda_assemble``) writes the bytes of all its files; only bytes come
    back.  Bytes do not depend on the placement.
    """
    on = _placement(device, mesh)
    if not files:
        return []

    def launch(dev, idx):
        sub = [files[i] for i in idx]
        with span("qoa.stage"):
            st = _stage_encode(sub, dev)
            table, n_bytes, n_frames = assemble.file_table(
                [d.channels for _, d in sub], [d.sample_rate for _, d in sub],
                [d.samples for _, d in sub], st.offsets)
            (t,) = put_arrays([table], dev)
        _, snaps, words = _encode_run(st, chunk_frames)
        with span("qoa.pipeline"):
            buf = cuda_assemble.assemble_streams(snaps, words, t, n_bytes, n_frames)
        return buf, functools.partial(_assemble, table[assemble.OFFSET].tolist())

    with span("qoa.stage"):
        groups = _file_groups([-(-d.samples // fmt.QOA_FRAME_LEN) for _, d in files],
                              [d.samples * d.channels for _, d in files], on.size)
    return _run_groups(on, groups, launch)


def batch_decode(streams: Sequence[bytes], device=None,
                 mesh: Optional[Mesh] = None) -> List[DecodedQoa]:
    """Decode many QOA streams in ONE decode launch on ``device``, or one
    per device group over ``mesh``.

    Every frame header carries its LMS seed, so the chains of all files
    (frames x channels each) concatenate into one chain axis.  Streams the
    arithmetic parser rejects decode on the host pair's codec, file by
    file; the rest of the corpus still batches.
    """
    global host_pair_files
    on = _placement(device, mesh)
    if not streams:
        return []
    with span("qoa.parse"):
        parsed = [bs.parse_file_arrays(d) for d in streams]
    outs: List[Optional[DecodedQoa]] = [None] * len(streams)
    good = []
    with span("qoa.host_pair"):
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


def _split_files(pcm: np.ndarray, parsed, sizes) -> List[DecodedQoa]:
    """One device group's fetched PCM, its files' trimmed interleaved
    samples back to back (``sizes`` each), -> each file's decoded stream.
    A file's chains lie on one device, which interleaves it whole."""
    starts = np.cumsum([0] + list(sizes)).tolist()
    return [DecodedQoa(num_channels=p.channels, sample_rate=p.sample_rate,
                       samples=pcm[a:b])
            for p, a, b in zip(parsed, starts, starts[1:])]


def decode_parsed(parsed, device=None, mesh: Optional[Mesh] = None) -> List[DecodedQoa]:
    """Decode streams parsed by ``bs.parse_file_arrays`` in ONE decode
    launch on ``device``, or one per device group over ``mesh``, each file
    interleaved on its device; one fetch brings every group's PCM back."""
    on = _placement(device, mesh)

    def launch(dev, idx):
        sub = [parsed[i] for i in idx]
        words_be, state, offs = _stage_decode(sub)
        dec = cuda_decode.decode_chains_words(*put_arrays([state, words_be], dev))
        pcms = [_interleave_file(dec[: p.max_windows, :, off : off + p.n_frames * p.channels], p)
                for p, off in zip(sub, offs)]
        return torch.cat(pcms), functools.partial(
            _split_files, parsed=sub, sizes=[t.numel() for t in pcms])

    return _run_groups(on, _file_groups(*_parsed_load(parsed), on.size), launch)


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
    passes state through and the assembly never reads their output."""
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
        p.n_frames == 1 or p.first_frame_samples == fmt.QOA_FRAME_LEN
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

    Holds the device-resident staged arguments (the device group's QOA
    streams back to back as they were uploaded, the per-file gather
    table, relayout index, per-chain samples, initial encoder state, the
    per-file assembly table), which pins them in device memory while the
    handle lives, and ``fn``, which runs chain gather -> decode ->
    relayout -> lens -> chunked encode -> stream assembly on them.  The
    decoder's words and state are made anew by each run's gather and
    freed after its decode.  Calling the handle
    re-issues those launches with no host staging and returns a one-tuple
    of the uint8 device tensor that holds every file's bytes, unfetched.
    ``batch_transcode`` itself runs through the handle, so timing a call
    (with a synchronize) times exactly the device side of the end-to-end
    path.  ``assemble(buf)`` cuts the fetched buffer into the files'
    bytes: ``h.assemble(*fetch_arrays(h()))``.
    """

    __slots__ = ("fn", "args", "assemble")

    def __init__(self, fn, args, assemble):
        self.fn = fn
        self.args = args
        self.assemble = assemble

    def __call__(self):
        return self.fn(*self.args)


def _transcode_pipeline(streams, gtable, idx, samples, state, table, *,
                        W: int, Nd: int, W_enc: int, chunk: int, f_full: int,
                        n_bytes: int, n_frames: int):
    """Step 2 of a transcode, all on the staged tensors' device: the
    decode chains gathered from the streams -> decode -> relayout -> lens
    -> chunked encode -> every file's stream, assembled from the
    encoder's outputs by one launch.  Returns a one-tuple of the uint8
    bytes tensor.  Chunks below ``f_full`` — where every window of every
    chain holds 20 samples — take the full-window kernel; the LMS carries
    across chunks on the device."""
    words_be, dstate = cuda_gather.gather_chains(streams, gtable, W, Nd)
    dec = cuda_decode.decode_chains_words(dstate, words_be)  # (W, 20, Nd)
    del words_be, dstate
    F = idx.shape[0]
    snaps, words = [], []
    for f0 in range(0, F, chunk):
        f1 = min(f0 + chunk, F)
        x = _relayout_encode_input(dec, idx[f0:f1], W_enc)
        if f1 <= f_full:
            state, s, w = cuda_encode.encode_frames_full(state, x)
        else:
            lens = _transcode_lens(samples, f0, f1, W_enc)
            state, s, w = cuda_encode.encode_frames(state, x, lens)
        snaps.append(s)
        words.append(w)
    return (cuda_assemble.assemble_streams(_cat(snaps), _cat(words), table, n_bytes,
                                           n_frames),)


def _stage_streams(streams, geos, pin: bool):
    """A device group's streams copied once, back to back, into one int64
    host tensor (pinned with ``pin``), and the gather's table of them
    (``ops.gather.file_table``).  Every stream the device path takes is a
    whole number of u64 words, so each starts 8-byte aligned.  Returns
    (buffer, table, decode chains in all)."""
    starts = [0, *itertools.accumulate(len(d) for d in streams)]
    buf = torch.empty(starts[-1] // 8, dtype=torch.int64, pin_memory=pin)
    host = memoryview(buf.numpy()).cast("B")
    for d, a, b in zip(streams, starts, starts[1:]):
        host[a:b] = d
    table, n_chains = gather.file_table(
        [a + fmt.QOA_HEADER_SIZE for a in starts[:-1]], [g.n_frames for g in geos],
        [g.F_full for g in geos], [g.frame_bytes for g in geos], [g.channels for g in geos], [g.W0 for g in geos],
        [0 if g.tail is None else g.tail.n_windows for g in geos])
    return buf, table, n_chains


def _stage_transcode(streams, geos, device, chunk_frames: int) -> TranscodeFusedHandle:
    """Step 1 of a transcode: the files' streams copied into one buffer
    (:func:`_stage_streams`), the gather and assembly tables and the
    relayout built on the host from each stream's geometry
    (``bitstream.parse_file_geometry``), all uploaded to ``device``;
    returns the handle onto step 2, which gathers the decode chains on
    the device."""
    buf, gtable, Nd = _stage_streams(streams, geos, pin=torch.device(device).type == "cuda")
    doffs = gtable[gather.CHAIN].tolist()
    eoffs = []
    n = 0
    for g in geos:
        eoffs.append(n)
        n += g.channels
    Ne = n
    F_max = max(g.n_frames for g in geos)
    W_enc = max(
        fmt.QOA_SLICES_PER_FRAME if g.n_frames > 1 else g.max_windows
        for g in geos
    )
    file_samples = [g.frame_samples for g in geos]
    chans = [g.channels for g in geos]
    samples = np.repeat(file_samples, chans)  # samples/channel of each encode chain
    metas = tuple(
        (g.n_frames, g.channels, doff, eoff)
        for g, doff, eoff in zip(geos, doffs, eoffs)
    )
    table, n_bytes, n_frames = assemble.file_table(
        chans, [g.sample_rate for g in geos], file_samples, eoffs)
    args = put_arrays(
        [buf, gtable, _relayout_index(metas, F_max, Ne), samples,
         codec.initial_encoder_state(0, Ne), table],
        device,
    )
    fn = functools.partial(
        _transcode_pipeline, W=max(g.max_windows for g in geos), Nd=Nd, W_enc=W_enc,
        chunk=chunk_frames, f_full=int(samples.min()) // fmt.QOA_FRAME_LEN,
        n_bytes=n_bytes, n_frames=n_frames,
    )
    return TranscodeFusedHandle(
        fn, tuple(args),
        functools.partial(_assemble, table[assemble.OFFSET].tolist()))


def _transcode_groups(streams, geos, mesh: Mesh, chunk_frames: int):
    """Every device group's pipeline issued before any fetch, then one
    fetch and the assembly.  Returns (bytes per file, handle per group)."""
    handles = []

    def launch(dev, idx):
        with span("qoa.stage"):
            h = _stage_transcode([streams[i] for i in idx], [geos[i] for i in idx], dev,
                                 chunk_frames)
        with span("qoa.pipeline"):
            (buf,) = h()
        handles.append(h)
        return buf, h.assemble

    with span("qoa.stage"):
        groups = _file_groups([g.n_frames for g in geos],
                              [g.frame_samples * g.channels for g in geos], mesh.size)
    return _run_groups(mesh, groups, launch), handles


def _transcode(streams, geos, mesh: Mesh, chunk_frames: int, bucket,
               one_device: bool):
    """``batch_transcode`` on the streams and their geometry (``geos``:
    ``bitstream.parse_file_geometry`` of each) -> (bytes per file, handle).
    Only the streams the device path cannot take pay the host pair; the
    rest still run the device pipeline, split into length buckets where
    ``bucket`` is set and the cost model finds a split worth it."""
    global host_pair_files
    outs: List[Optional[bytes]] = [None] * len(streams)
    good = []
    with span("qoa.host_pair"):
        for i, (d, p) in enumerate(zip(streams, geos)):
            if _device_eligible(p):
                good.append(i)
            else:
                host_pair_files += 1
                outs[i] = _host_pair(d, mesh.devices[0])
    if not good:
        return outs, None
    segs = None
    if bucket:
        with span("qoa.stage"), span("qoa.bucket"):
            e_mult, overhead = _bucket_model(mesh)
            segs = _length_buckets([geos[i].n_frames for i in good],
                                   [geos[i].channels for i in good], e_mult,
                                   chunk_frames, overhead)
    handles = []
    for seg in segs or [range(len(good))]:
        idx = [good[k] for k in seg]
        sub, hs = _transcode_groups([streams[i] for i in idx], [geos[i] for i in idx],
                                    mesh, chunk_frames)
        handles.extend(hs)
        for i, data in zip(idx, sub):
            outs[i] = data
    if not one_device:
        return outs, None
    return outs, handles[0] if segs is None else _CompositeFusedHandle(handles)


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
    encoder's frame layout and feeds the encoder directly, and the
    encoder's outputs are assembled into the streams there; only the
    streams' bytes return to the host.  The
    encoder runs in launches of ``chunk_frames`` frames (which bounds the
    relayout's device memory), the leading all-full chunks on the
    full-window kernel.  Streams that are not fixed-layout, or multi-frame
    with non-standard frame sizes, go to the host decode -> encode pair,
    which gives identical bytes.

    With ``mesh`` whole files are partitioned over its devices, balanced
    by encode work (:func:`_file_groups`, the rule of every batched path),
    and each device runs the pipeline on its own files:
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
        with span("qoa.parse"):
            geos = [bs.parse_file_geometry(d) for d in streams]
        outs, handle = _transcode(streams, geos, on, chunk_frames, bucket,
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
