"""Batched multi-file corpus decode, encode and transcode, on one device or
over a mesh.

Port of ``qoaudio_tpu/parallel/corpus.py``.  The channels (encode) or
frame x channel chains (decode) of many files pack into one chain axis, so
a whole corpus runs in a few kernel launches:

* ``batch_decode``    — all files' chains in one decode launch (one per
  shard on a mesh);
* ``batch_encode``    — all files' channels as encode chains, frames in
  launches of ``chunk_frames`` with the LMS carried on the device (per
  shard, on its own device, on a mesh); each file's PCM is uploaded once,
  as it is interleaved, and laid out for the encoder on the device (one
  gather a chunk); the streams are assembled on the device;
* ``batch_transcode`` — decode, then relayout ON THE DEVICE into the
  encoder's layout (one ``index_select`` plus a ``permute``), then encode
  and assemble the streams: the PCM never leaves device memory, and only
  the streams' bytes come back.  On a mesh whole files are partitioned over the
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

The streams' bytes are written on the device, every file of a device
group back to back in one uint8 tensor (``ops.cuda_assemble``: the kernel
on a CUDA device, its plain version on a CPU device), from a per-file
table built on the host (``ops.assemble.file_table``); one fetch brings
them back, and the host only cuts the buffer at the table's offsets.

Under a running ``torch.profiler`` each host stage of a call is a span
(``utils/timing.span``), once per stage and sub-call, never per file:
``qoa.parse``, ``qoa.host_pair`` (the eligibility split and the files
that take the host pair), ``qoa.stage`` (host arrays: file groups, the
transcode staging, the encode checks and the flat PCM buffer) with
``qoa.bucket`` inside (the length-bucket choice), ``qoa.upload``
(``put_arrays``), ``qoa.pipeline`` (queuing the device work),
``qoa.fetch`` with ``qoa.wait`` inside (``fetch_arrays``) and
``qoa.assemble`` (cutting the fetched bytes into files, and the host
assembly of files that straddle shards).
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
from ..ops import assemble, cuda_assemble, cuda_decode, cuda_encode
from ..ops.layout import frame_major
from ..types import DecodedQoa, QoaDesc
from ..utils.timing import span
from ..utils.transfer import fetch_arrays, put_arrays
from .mesh import (Mesh, decode_chains_sharded, encode_frames_sharded,
                   gather_chains, round_up, shard_chain_arrays)

host_pair_files = 0  # files that took the host decode -> encode pair
# files batch_encode assembled on the host: their chains straddle shards
host_assembled_files = 0

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
    state int32 (8, N)); chains past the files' stay zero.  The words stay
    big-endian: the decode kernel byteswaps them itself, so the upload is
    the compressed payload.  With ``pin`` the two are torch tensors in
    pinned memory, which the caching host allocator hands out again call
    after call, uploaded as they are; else numpy arrays."""
    words_t = torch.empty((W, N), dtype=torch.int64, pin_memory=pin)
    state_t = torch.empty((8, N), dtype=torch.int32, pin_memory=pin)
    words_be, state = words_t.numpy().view(np.uint64), state_t.numpy()
    n = 0
    for p, off in zip(parsed, offs):
        k = p.n_frames * p.channels
        words_be[: p.max_windows, off : off + k] = p.words_be
        words_be[p.max_windows :, off : off + k] = 0
        state[:, off : off + k] = p.state
        n = off + k
    words_be[:, n:] = 0
    state[:, n:] = 0
    return (words_t, state_t) if pin else (words_be.view(np.int64), state)


def _stage_decode(parsed, multiple: int = 1, pin: bool = False):
    """All files' decode chains -> (words_be, state) host arrays with the
    chain axis padded to a multiple of ``multiple``, and each file's first
    chain; pinned tensors with ``pin`` (:func:`_stage_words_be`)."""
    W = max(p.max_windows for p in parsed)
    offs = []
    n = 0
    for p in parsed:
        offs.append(n)
        n += p.n_frames * p.channels
    words_be, state = _stage_words_be(parsed, offs, W, round_up(n, multiple), pin)
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


def _stage_encode_pcm(files, offsets, mesh: Mesh, Np: int):
    """Every file's interleaved PCM, in input order, copied once into one
    int16 host buffer (pinned on a CUDA mesh), each file followed by as
    many zeros as it has channels.  Shard k's chains read one slice of
    whole files, uploaded to its device as it is.  ``offsets``: each
    file's first chain.  Returns the per-shard device slices and the int64
    (3, Np) (base, stride, samples) of every chain, base taken from the
    start of its shard's slice: chain j reads its sample t at
    base_j + min(t, samples_j) * stride_j, a zero from its end on.
    Padding chains read their slice's last zero."""
    sizes = [d.samples * d.channels for _, d in files]
    starts = np.cumsum([0] + [n + d.channels for n, (_, d) in zip(sizes, files)])
    total = int(starts[-1])
    buf = torch.empty(total, dtype=torch.int16,
                      pin_memory=mesh.devices[0].type == "cuda")
    host = buf.numpy()
    vec = np.zeros((3, Np), np.int64)  # base, stride, samples; padding: 0
    for (pcm, d), s, n, j in zip(files, starts, sizes, offsets):
        a = np.asarray(pcm)
        np.copyto(host[s : s + n].reshape(a.shape), a, casting="unsafe")
        host[s + n : s + n + d.channels] = 0
        vec[0, j : j + d.channels] = s + np.arange(d.channels)
        vec[1:, j : j + d.channels] = [[d.channels], [d.samples]]
    N = offsets[-1] + files[-1][1].channels
    k = Np // mesh.size
    cuts = []
    for c0 in range(0, Np, k):  # shard by shard: its chains c0 <= j < c0 + k
        c1 = min(c0 + k, N)
        if c0 < c1:
            lo = int(starts[bisect.bisect_right(offsets, c0) - 1])
            hi = int(starts[bisect.bisect_right(offsets, c1 - 1)])
        else:  # padding only
            lo, hi = total - 1, total
        vec[0, c0:c1] -= lo
        vec[0, max(c0, N) : c0 + k] = hi - lo - 1
        cuts.append((lo, hi))
    with span("qoa.upload"):
        flats = [buf[lo:hi].to(dev, non_blocking=True)
                 for (lo, hi), dev in zip(cuts, mesh.devices)]
    return flats, vec


def _encode_input(flat: torch.Tensor, vec: torch.Tensor, f0: int, f1: int,
                  W_use: int) -> torch.Tensor:
    """Frames f0 <= f < f1 of one shard's encoder input, int16
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
    """What ``_stage_encode`` leaves for the device: each file's first
    chain, the real chain count ``N``, the frames and windows the chunks
    run, the frames every chain has full, and the per-shard flat PCM,
    chain vectors and start states."""

    offsets: List[int]
    N: int
    F_max: int
    W_use: int
    f_full: int
    flats: list
    vecs: list
    states: list


def _stage_encode(files, mesh: Mesh, state=None) -> _EncodeStaged:
    """The encode's host side, inside the caller's ``qoa.stage``: checks,
    the start state, the flat PCM buffer and the uploads."""
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
    N = n
    Np = round_up(N, mesh.size)  # padding chains run on lens 0, then drop
    f_full = min(d.samples // fmt.QOA_FRAME_LEN for _, d in files)

    start = codec.initial_encoder_state(0, Np)
    if state is not None:
        start[:, :N] = state
    flats, vec = _stage_encode_pcm(files, offsets, mesh, Np)
    states, vecs = shard_chain_arrays(mesh, start, vec)
    return _EncodeStaged(offsets, N, F_max, W_use, f_full, flats, vecs, states)


def _cat(parts: List[torch.Tensor]) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _encode_run(st: _EncodeStaged, mesh: Mesh, chunk_frames: int):
    """The staged encode on the devices: each chunk of ``chunk_frames``
    frames laid out for the encoder on the shard's own device
    (``_encode_input``), which runs it, carrying its LMS there; leading
    all-full chunks take the full-window kernel.  Returns the per-shard
    device tensors: states (8, n), snaps (F_max, 8, n), words
    (F_max, W_use, n) int64 logical."""
    states = st.states
    snaps, words = [], []  # per chunk, the per-shard device tensors
    for f0 in range(0, st.F_max, chunk_frames):
        f1 = min(f0 + chunk_frames, st.F_max)
        with span("qoa.pipeline"):
            xs = [_encode_input(x, v, f0, f1, st.W_use) for x, v in zip(st.flats, st.vecs)]
            lens = None if f1 <= st.f_full else [
                _transcode_lens(v[2], f0, f1, st.W_use) for v in st.vecs]
            states, s, w = encode_frames_sharded(mesh, states, xs, lens)
        snaps.append(s)
        words.append(w)
    per_shard = range(mesh.size)
    return (states, [_cat([c[k] for c in snaps]) for k in per_shard],
            [_cat([c[k] for c in words]) for k in per_shard])


def _encode_sharded(files, mesh: Mesh, chunk_frames: int, state=None):
    """Encode many PCM streams, each channel one chain, the chain axis
    padded to a multiple of the mesh size and sharded over it.

    The files' PCM is copied once into one flat buffer and each shard's
    slice uploaded once; the chunks run on the shards' devices
    (``_encode_run``).  ``state`` is the int32 (8, N) LMS the chains
    start from (default: the encoder's initial state).  Returns host
    arrays (state (8, N), snaps (F, 8, N), words (F, W, N) uint64 logical)
    and each file's first chain.
    """
    with span("qoa.stage"):
        st = _stage_encode(files, mesh, state)
    states, snaps, words = _encode_run(st, mesh, chunk_frames)
    N = st.N
    snaps, words, state = (gather_chains(t) for t in (snaps, words, states))
    return (state[:, :N], snaps[..., :N], words[..., :N].view(np.uint64),
            st.offsets)


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


def _shard_tables(files, offsets: List[int], mesh: Mesh, n_chains: int):
    """Which shard assembles which file: a file whose chains lie in one
    shard of ``n_chains`` chains is assembled there, from its chains'
    place in the shard.  Returns (shard, file indices, table, bytes,
    frames) of every shard that holds a whole file, and the files whose
    chains straddle two or more shards."""
    C = np.array([d.channels for _, d in files], np.int64)
    offs = np.asarray(offsets, np.int64)
    first = offs // n_chains
    whole = first == (offs + C - 1) // n_chains
    plans = []
    for k in range(mesh.size):
        idx = np.flatnonzero(whole & (first == k))
        if len(idx):
            ds = [files[i][1] for i in idx]
            plans.append((k, idx.tolist(), *assemble.file_table(
                C[idx], [d.sample_rate for d in ds], [d.samples for d in ds],
                offs[idx] - k * n_chains)))
    return plans, np.flatnonzero(~whole).tolist()


def _straddling_pieces(d, off: int, n_chains: int, snaps, words):
    """A straddling file's chains, shard by shard: (snaps, words) device
    slices of its real frames, to be joined on the host."""
    F = -(-d.samples // fmt.QOA_FRAME_LEN)
    pieces = []
    for k in range(off // n_chains, (off + d.channels - 1) // n_chains + 1):
        lo = max(off, k * n_chains) - k * n_chains
        hi = min(off + d.channels, (k + 1) * n_chains) - k * n_chains
        pieces += [snaps[k][:F, :, lo:hi], words[k][:F, :, lo:hi]]
    return pieces


def _cut(buf: np.ndarray, offsets) -> List[bytes]:
    """One fetched buffer of streams laid back to back -> each stream's
    bytes, from its offset to the next one's."""
    mv = memoryview(buf)
    ends = [*offsets[1:], len(buf)]
    return [mv[a:b].tobytes() for a, b in zip(offsets, ends)]


def batch_encode(
    files: Sequence[tuple[np.ndarray, QoaDesc]],
    device=None,
    chunk_frames: int = 64,
    mesh: Optional[Mesh] = None,
) -> List[bytes]:
    """Encode many PCM streams as one batched chain axis on ``device``, or
    sharded over ``mesh``.

    Returns QOA bytes per file, each bit-exact with single-file encoding
    (chains are independent; zero-length padding windows are inert).  The
    streams are assembled on the device (``cuda_assemble``): each shard
    writes the bytes of the files whose chains it holds whole, and only
    bytes come back.  A file whose channels straddle two shards is
    assembled on the host from its fetched chains; the module integer
    ``host_assembled_files`` counts those.
    """
    global host_assembled_files
    on = _placement(device, mesh)
    if not files:
        return []
    with span("qoa.stage"):
        st = _stage_encode(files, on)
        n_chains = round_up(st.N, on.size) // on.size
        plans, straddling = _shard_tables(files, st.offsets, on, n_chains)
        tables = [put_arrays([t], on.devices[k])[0] for k, _, t, _, _ in plans]
    _, snaps, words = _encode_run(st, on, chunk_frames)
    with span("qoa.pipeline"):
        bufs = [cuda_assemble.assemble_streams(snaps[k], words[k], t, n_bytes, n_frames)
                for (k, _, _, n_bytes, n_frames), t in zip(plans, tables)]
        pieces = [_straddling_pieces(files[i][1], st.offsets[i], n_chains, snaps, words)
                  for i in straddling]
    fetched = fetch_arrays(bufs + [t for ps in pieces for t in ps])
    out: List[Optional[bytes]] = [None] * len(files)
    with span("qoa.assemble"):
        for (_, idx, table, _, _), buf in zip(plans, fetched):
            for i, data in zip(idx, _cut(buf, table[assemble.OFFSET].tolist())):
                out[i] = data
        pos = len(bufs)
        for i, ps in zip(straddling, pieces):
            got = fetched[pos : pos + len(ps)]
            pos += len(ps)
            d = files[i][1]
            out[i] = bs.assemble_stream_bytes(
                d.channels, d.sample_rate, d.samples,
                np.concatenate(got[0::2], axis=-1),
                np.concatenate(got[1::2], axis=-1).view(np.uint64))
        host_assembled_files += len(straddling)
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
    per-file assembly table), which pins them in device memory while the
    handle lives, and ``fn``, which runs decode -> relayout -> lens ->
    chunked encode -> stream assembly on them.  Calling the handle
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


def _transcode_pipeline(dstate, words_be, idx, samples, state, table, *,
                        W_enc: int, chunk: int, f_full: int, n_bytes: int,
                        n_frames: int):
    """Step 2 of a transcode, all on the staged tensors' device: decode ->
    relayout -> lens -> chunked encode -> every file's stream, assembled
    from the encoder's outputs by one launch.  Returns a one-tuple of the
    uint8 bytes tensor.  Chunks below ``f_full`` — where every window of
    every chain holds 20 samples — take the full-window kernel; the LMS
    carries across chunks on the device."""
    dec = cuda_decode.decode_chains_words(dstate, words_be)  # (W, 20, Nd)
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


def _assemble_transcode(offsets: List[int], buf: np.ndarray) -> List[bytes]:
    """Step 3: the fetched bytes of every file -> each file's bytes."""
    with span("qoa.assemble"):
        return _cut(buf, offsets)


def _stage_transcode(parsed, device, chunk_frames: int) -> TranscodeFusedHandle:
    """Step 1 of a transcode: stage the files' words, the relayout and the
    assembly table on the host and upload them to ``device``; returns the
    handle onto step 2."""
    words_be, dstate, doffs = _stage_decode(
        parsed, pin=torch.device(device).type == "cuda")
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
    file_samples = [int(p.samples_per_frame.sum()) for p in parsed]
    chans = [p.channels for p in parsed]
    samples = np.repeat(file_samples, chans)  # samples/channel of each encode chain
    metas = tuple(
        (p.n_frames, p.channels, doff, eoff)
        for p, doff, eoff in zip(parsed, doffs, eoffs)
    )
    table, n_bytes, n_frames = assemble.file_table(
        chans, [p.sample_rate for p in parsed], file_samples, eoffs)
    args = put_arrays(
        [dstate, words_be, _relayout_index(metas, F_max, Ne), samples,
         codec.initial_encoder_state(0, Ne), table],
        device,
    )
    fn = functools.partial(
        _transcode_pipeline, W_enc=W_enc, chunk=chunk_frames,
        f_full=int(samples.min()) // fmt.QOA_FRAME_LEN, n_bytes=n_bytes,
        n_frames=n_frames,
    )
    return TranscodeFusedHandle(
        fn, tuple(args),
        functools.partial(_assemble_transcode, table[assemble.OFFSET].tolist()))


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
    with span("qoa.stage"):
        groups = _file_groups(parsed, mesh.size)
    for dev, idx in zip(mesh.devices, groups):
        if idx:  # a device with no files launches nothing
            with span("qoa.stage"):
                h = _stage_transcode([parsed[i] for i in idx], dev, chunk_frames)
            with span("qoa.pipeline"):
                (buf,) = h()
            runs.append((idx, h, buf))
    fetched = fetch_arrays([buf for _, _, buf in runs])
    outs: List[Optional[bytes]] = [None] * len(parsed)
    for (idx, h, _), buf in zip(runs, fetched):
        for i, data in zip(idx, h.assemble(buf)):
            outs[i] = data
    return outs, [h for _, h, _ in runs]


def _transcode(streams, parsed, mesh: Mesh, chunk_frames: int, bucket,
               one_device: bool):
    """``batch_transcode`` on parsed streams -> (bytes per file, handle).
    Only the streams the device path cannot take pay the host pair; the
    rest still run the device pipeline, split into length buckets where
    ``bucket`` is set and the cost model finds a split worth it."""
    global host_pair_files
    outs: List[Optional[bytes]] = [None] * len(streams)
    good = []
    with span("qoa.host_pair"):
        for i, (d, p) in enumerate(zip(streams, parsed)):
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
            segs = _length_buckets([parsed[i].n_frames for i in good],
                                   [parsed[i].channels for i in good], e_mult,
                                   chunk_frames, overhead)
    handles = []
    for seg in segs or [range(len(good))]:
        idx = [good[k] for k in seg]
        sub, hs = _transcode_groups([parsed[i] for i in idx], mesh, chunk_frames)
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
        with span("qoa.parse"):
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
