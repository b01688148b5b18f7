"""QOA streams from the encoder's outputs: the plain PyTorch version of
``csrc/qoa_assemble.cu`` and the per-file table both read.

The encoder leaves, per frame and chain, the frame-start LMS (snaps int32
(F, 8, N)) and the logical slice words (words int64 (F, W, N)), chain
minor.  A file is C consecutive chains from its first chain on, over its
own frames.  Its stream is the 8-byte file header (``qoaf``, u32 samples
a channel), then per frame the u64 frame header as
``format.pack_frame_header`` packs it, the 2C LMS words (history, then
weights, of each channel; each value truncated to 16 bits as
``bitstream.pack_lms`` does) and the frame's slice words, window-major
and channel-minor, the last frame with only its real windows; every word
big-endian.  This is ``bitstream.assemble_stream_bytes``, for many files
at once into one buffer.

Every stream is a whole number of u64 words, so the files lie back to
back, each 8-byte aligned; and every frame of a file but its last has the
full size, so a (file, frame) pair finds its offset with no scan.  The
table is int64 (``TABLE_ROWS``, n_files), one column per file, in output
order: its byte offset, first chain, channels, sample rate, samples a
channel, frames, and the frames of all files before it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import format as fmt

OFFSET, CHAIN, CHANNELS, RATE, SAMPLES, FRAMES, FIRST_FRAME = range(7)
TABLE_ROWS = 7


def stream_bytes(channels, samples) -> np.ndarray:
    """Byte size of each stream of ``channels`` x ``samples`` a channel
    (int64 arrays, elementwise)."""
    C = np.asarray(channels, np.int64)
    T = np.asarray(samples, np.int64)
    F = -(-T // fmt.QOA_FRAME_LEN)
    windows = -(-T // fmt.QOA_SLICE_LEN)  # over all frames
    return fmt.QOA_HEADER_SIZE + F * (8 + 16 * C) + 8 * windows * C


def file_table(channels, rates, samples, chains):
    """The table of files with these ``channels``, sample ``rates``,
    ``samples`` a channel and first ``chains``, back to back in this
    order.  Returns (table int64 (TABLE_ROWS, n), n_bytes, n_frames)."""
    C = np.asarray(channels, np.int64)
    T = np.asarray(samples, np.int64)
    sizes = stream_bytes(C, T)
    frames = -(-T // fmt.QOA_FRAME_LEN)
    table = np.empty((TABLE_ROWS, len(C)), np.int64)
    table[OFFSET] = np.cumsum(sizes) - sizes
    table[CHAIN] = chains
    table[CHANNELS] = C
    table[RATE] = rates
    table[SAMPLES] = T
    table[FRAMES] = frames
    table[FIRST_FRAME] = np.cumsum(frames) - frames
    return table, int(sizes.sum()), int(frames.sum())


def _lms_word(snaps: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """Four int32 values at flat indices ``at``, ``at + N``, ... (one per
    row of the snapshot) -> the u64 LMS word, each truncated to 16 bits."""
    N = snaps.shape[2]
    flat = snaps.reshape(-1)
    word = torch.zeros_like(at)
    for i in range(4):
        v = flat[at + i * N].to(torch.int64) & 0xFFFF
        word |= v << (48 - 16 * i)
    return word


def assemble_streams(snaps: torch.Tensor, words: torch.Tensor, table: torch.Tensor,
                     n_bytes: int, n_frames: int) -> torch.Tensor:
    """Every file of ``table`` as its QOA stream, back to back: uint8
    (n_bytes,) on the inputs' device.  snaps int32 (F, 8, N), words int64
    (F, W, N) logical, table int64 (TABLE_ROWS, n_files) from
    :func:`file_table` (``n_frames`` is the kernel's grid; here unused).
    One output word per element, every field gathered at once."""
    del n_frames
    dev = words.device
    _, W, N = words.shape
    k = torch.arange(n_bytes // 8, dtype=torch.int64, device=dev)
    start = table[OFFSET] // 8
    i = torch.searchsorted(start, k, right=True) - 1  # each word's file
    r = k - start[i]  # its word within the file
    C, chain, rate, T = table[CHANNELS][i], table[CHAIN][i], table[RATE][i], table[SAMPLES][i]
    full = 1 + 2 * C + fmt.QOA_SLICES_PER_FRAME * C  # words of a full frame
    q = (r - 1).clamp_min(0)  # word within the frames (the file header: 0)
    f = torch.minimum(q // full, table[FRAMES][i] - 1)
    q -= f * full  # word within frame f
    spc = torch.clamp(T - f * fmt.QOA_FRAME_LEN, max=fmt.QOA_FRAME_LEN)
    nw = -(-spc // fmt.QOA_SLICE_LEN)
    fsize = 8 + 16 * C + 8 * nw * C
    header = (((C & 0xFF) << 56) | ((rate & 0xFFFFFFFF) << 32)
              | ((spc & 0xFFFF) << 16) | (fsize & 0xFFFF))
    # LMS word q - 1 = 2c + (0 history, 1 weights); slice word s = w*C + c
    lq = torch.minimum((q - 1).clamp_min(0), 2 * C - 1)
    lms = _lms_word(snaps, (f * 8 + (lq & 1) * 4) * N + chain + (lq >> 1))
    s = (q - 1 - 2 * C).clamp_min(0)
    slices = words.reshape(-1)[(f * W + s // C) * N + chain + s % C]
    out = torch.where(q == 0, header, torch.where(q <= 2 * C, lms, slices))
    out = torch.where(r == 0, (fmt.QOA_MAGIC << 32) | (T & 0xFFFFFFFF), out)
    shifts = torch.arange(56, -8, -8, device=dev)  # big-endian bytes
    return ((out[:, None] >> shifts) & 0xFF).to(torch.uint8).reshape(-1)
