"""Files as frame chains, and the frozen reference run over them.

A file of C channels and F frames is C x F chains, channel-major: chain
``base + c * F + f`` is channel c of frame f.  Chains hold 5,120 samples
but a file's last frame, and are laid out (256 windows, 20, chains) for
the reference encoder.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .generate import File
from .reference import codec as ref
from .reference import stream
from .reference.tables import FRAME_LEN, SLICE_LEN, SLICES_PER_FRAME

# chains the reference runs at once: bounds its device memory
BLOCK_CHAINS = 1 << 18


@dataclasses.dataclass
class Batch:
    files: List[File]
    base: np.ndarray  # first chain of each file, and the end
    nsamp: np.ndarray  # samples of each chain

    @property
    def chains(self) -> int:
        return int(self.base[-1])

    def frame_chains(self, i: int) -> np.ndarray:
        """(F, C) chain indices of file i."""
        f = self.files[i]
        return self.base[i] + np.arange(f.channels)[None, :] * f.frames + np.arange(f.frames)[:, None]


def batch(files: Sequence[File]) -> Batch:
    sizes = [f.channels * f.frames for f in files]
    nsamp = []
    for f in files:
        spf = np.full(f.frames, FRAME_LEN, np.int64)
        spf[-1] = f.samples - (f.frames - 1) * FRAME_LEN
        nsamp.append(np.tile(spf, f.channels))
    return Batch(list(files), np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64),
                 np.concatenate(nsamp) if nsamp else np.zeros(0, np.int64))


def chains_of_pcm(pcms: Sequence[torch.Tensor]) -> torch.Tensor:
    """(C, S) int16 tensors -> (256, 20, chains) int16, zero past each
    chain's samples."""
    rows = []
    for p in pcms:
        c, s = p.shape
        f = -(-s // FRAME_LEN)
        pad = torch.zeros((c, f * FRAME_LEN), dtype=torch.int16, device=p.device)
        pad[:, :s] = p
        rows.append(pad.view(c * f, FRAME_LEN))
    return torch.cat(rows).t().contiguous().view(SLICES_PER_FRAME, SLICE_LEN, -1)


def _encode_graphed(x: torch.Tensor, start: torch.Tensor, nsamp: np.ndarray, predict: str):
    """``reference.codec.encode_chains`` with each window's operations
    captured once in a CUDA graph and replayed: the same operations on the
    same tensors, without the host's cost of issuing each of them."""
    dev = x.device
    enc = ref.Encoder(dev, predict)
    n = x.shape[2]
    state = start.t().contiguous()
    xs = torch.empty((SLICE_LEN, n), dtype=x.dtype, device=dev)
    ln = torch.zeros(n, dtype=torch.int64, device=dev)
    nsamp_t = torch.as_tensor(nsamp, device=dev)
    graphs = {}

    def graph(masked: bool):
        if masked not in graphs:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                enc.window(state, xs, ln if masked else None)
            torch.cuda.current_stream(dev).wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out = enc.window(state, xs, ln if masked else None)
            graphs[masked] = (g, out)
        return graphs[masked]

    words = torch.zeros((n, SLICES_PER_FRAME), dtype=torch.int64, device=dev)
    used = int(-(-np.max(nsamp) // SLICE_LEN)) if n else 0
    for win in range(used):
        masked = ref.window_lengths(nsamp, win) is not None
        xs.copy_(x[win])
        if masked:
            torch.clamp(nsamp_t - SLICE_LEN * win, 0, SLICE_LEN, out=ln)
        g, (word, new) = graph(masked)
        g.replay()
        words[:, win] = word
        state.copy_(new)
    return words, state.t().contiguous()


def encode(x: torch.Tensor, start: torch.Tensor, nsamp: np.ndarray,
           predict: str = "int32"):
    """The reference encoder over every chain, in blocks.  Returns (words
    (N, 256) int64, end (N, 8) int32)."""
    n = x.shape[2]
    words = torch.empty((n, SLICES_PER_FRAME), dtype=torch.int64, device=x.device)
    end = torch.empty((n, 8), dtype=torch.int32, device=x.device)
    for a in range(0, n, BLOCK_CHAINS):
        b = min(a + BLOCK_CHAINS, n)
        if x.device.type == "cuda":
            words[a:b], end[a:b] = _encode_graphed(x[:, :, a:b], start[a:b], nsamp[a:b], predict)
        else:
            words[a:b], end[a:b] = ref.encode_chains(start[a:b], x[:, :, a:b], nsamp[a:b], predict)
    return words, end


def decode(start: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """The reference decoder over every chain, in blocks: (N, 5120) int16."""
    out = torch.empty((words.shape[0], FRAME_LEN), dtype=torch.int16, device=words.device)
    for a in range(0, words.shape[0], BLOCK_CHAINS):
        b = min(a + BLOCK_CHAINS, words.shape[0])
        out[a:b] = ref.decode_chains(start[a:b], words[a:b])
    return out


def file_words(b: Batch, i: int, words: np.ndarray) -> np.ndarray:
    """(F, 256, C) u64 slice words of file i from per-chain words."""
    return words[b.frame_chains(i)].transpose(0, 2, 1).view(np.uint64)


def streams_from_pcm(files: Sequence[File], pcms: Sequence[torch.Tensor]) -> List[bytes]:
    """QOA streams of the given PCM, every frame encoded by the reference
    from the encoder's initial state (each frame header carries its own
    LMS state, so such a stream is valid QOA and its frames encode side by
    side)."""
    b = batch(files)
    x = chains_of_pcm(pcms)
    words, end = encode(x, ref.initial_state(b.chains, x.device), b.nsamp)
    del x, end
    words = words.cpu().numpy()
    init = ref.initial_state(1, "cpu").numpy()[0]
    out = []
    for i, f in enumerate(files):
        states = np.broadcast_to(init, (f.frames, f.channels, 8))
        out.append(stream.assemble(f.channels, f.rate, f.samples, states, file_words(b, i, words)))
    return out


def decode_streams(files: Sequence[File], data: Sequence[bytes], device) -> Optional[torch.Tensor]:
    """The reference decode of each stream, as chains (256, 20, N) in the
    layout of ``batch(files)``; None when a stream is not the file it
    should be."""
    b = batch(files)
    start = np.zeros((b.chains, 8), np.int32)
    words = np.zeros((b.chains, SLICES_PER_FRAME), np.uint64)
    for i, (f, d) in enumerate(zip(files, data)):
        p = stream.parse(d)
        if p is None or (p.channels, p.rate, p.samples) != (f.channels, f.rate, f.samples) \
                or not stream.headers_valid(p):
            return None
        idx = b.frame_chains(i)
        start[idx] = p.states
        words[idx] = p.words.transpose(0, 2, 1)
    pcm = decode(torch.from_numpy(start).to(device), torch.from_numpy(words.view(np.int64)).to(device))
    return pcm.t().contiguous().view(SLICES_PER_FRAME, SLICE_LEN, -1)
