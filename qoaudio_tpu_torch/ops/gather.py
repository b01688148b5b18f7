"""The decode kernel's inputs from the QOA streams themselves: the plain
PyTorch version of ``csrc/qoa_gather.cu`` and the per-file table both
read.

A device group's streams lie back to back in one int64 buffer, each as
its bytes are (every fixed-layout stream is a whole number of u64 words,
so each starts 8-byte aligned).  A file is F x C decode chains from its
first chain on, chain f*C + c its frame f and channel c.  Frame f lies at
the file's first frame + f * (the full frame's bytes): the u64 frame
header, the 2C LMS words (history, then weights, of each channel) and
the slice words, window-major and channel-minor; every frame but a tail
has the full frame's windows, a tail its own.  The gather gives what
``parallel/corpus.py::_stage_decode`` gives from ``parse_file_arrays``:
the raw big-endian slice words int64 (W, N), zero past each chain's own
windows, and each chain's frame-start LMS int32 (8, N), its four history
then its four weight values, each sign-extended from 16 bits.

The table is int64 (``TABLE_ROWS``, n_files), one column per file, in
chain order: the byte offset of its first frame in the buffer, its full
frames, a full frame's bytes, channels, a full frame's windows, the tail
frame's windows (0 with no tail, and for a tail of no samples) and its
first chain.
"""

from __future__ import annotations

import numpy as np
import torch

OFFSET, FRAMES_FULL, FRAME_BYTES, CHANNELS, WINDOWS, TAIL_WINDOWS, CHAIN = range(7)
TABLE_ROWS = 7


def file_table(offsets, frames, frames_full, frame_bytes, channels, windows, tail_windows):
    """The table of files whose first frames lie at byte ``offsets`` of
    the buffer, with these frames (a tail included), full frames, full
    frame bytes, channels, windows a full frame and tail windows, their
    chains back to back in this order.  A tail may have no windows (a
    last frame of no samples): its chains still count, zero words and
    the frame's LMS.  Returns (table int64 (TABLE_ROWS, n), chains in
    all)."""
    table = np.empty((TABLE_ROWS, len(offsets)), np.int64)
    table[OFFSET] = offsets
    table[FRAMES_FULL] = frames_full
    table[FRAME_BYTES] = frame_bytes
    table[CHANNELS] = channels
    table[WINDOWS] = windows
    table[TAIL_WINDOWS] = tail_windows
    chains = np.asarray(frames, np.int64) * table[CHANNELS]
    table[CHAIN] = np.cumsum(chains) - chains
    return table, int(chains.sum())


def gather_chains(streams: torch.Tensor, table: torch.Tensor, n_windows: int,
                  n_chains: int):
    """Every chain of ``table``'s files from ``streams`` (int64, the
    streams back to back): (words_be int64 (n_windows, n_chains) raw
    big-endian, zero past each chain's windows; state int32
    (8, n_chains)), on the inputs' device.  One index a word, every
    field gathered at once."""
    dev = streams.device
    n = torch.arange(n_chains, dtype=torch.int64, device=dev)
    i = torch.searchsorted(table[CHAIN], n, right=True) - 1  # each chain's file
    C = table[CHANNELS][i]
    f = (n - table[CHAIN][i]) // C
    c = n - table[CHAIN][i] - f * C
    frame = table[OFFSET][i] // 8 + f * (table[FRAME_BYTES][i] // 8)  # its header word
    nw = torch.where(f < table[FRAMES_FULL][i], table[WINDOWS][i], table[TAIL_WINDOWS][i])
    w = torch.arange(n_windows, dtype=torch.int64, device=dev)[:, None]
    real = w < nw
    at = torch.where(real, frame + 1 + 2 * C + w * C + c, 0)
    words = torch.where(real, streams[at], 0)
    # LMS word 2c (history) and 2c + 1 (weights): four big-endian i16 each
    lms = streams.view(torch.uint8).view(-1, 8)[frame[:, None] + 1 + 2 * c[:, None]
                                                 + torch.arange(2, device=dev)]
    v = lms.reshape(n_chains, 8, 2).to(torch.int32)
    v = v[..., 0] * 256 + v[..., 1]
    state = (v - ((v & 0x8000) << 1)).T.contiguous()
    return words, state

