"""QOA constants and tables, derived from the specification's formulas
(https://qoaformat.org; the reference crate's ``src/lib.rs:12-27``)."""

from __future__ import annotations

import math

import numpy as np

SLICE_LEN = 20
SLICES_PER_FRAME = 256
FRAME_LEN = SLICE_LEN * SLICES_PER_FRAME  # 5120 samples per channel
MAGIC = b"qoaf"
NUM_SF = 16
INITIAL_WEIGHTS = (0, 0, -(1 << 13), 1 << 14)


def _round_away(x: float) -> int:
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


_SF = [_round_away((s + 1) ** 2.75) for s in range(NUM_SF)]
RECIPROCAL = np.array([((1 << 16) + sf - 1) // sf for sf in _SF], np.int32)
DEQUANT = np.array(
    [[_round_away(sf * m) for m in (0.75, -0.75, 2.5, -2.5, 4.5, -4.5, 7.0, -7.0)]
     for sf in _SF],
    np.int32,
)  # (16 scalefactors, 8 codes)
# the 3-bit code of a scaled residual clamped to [-8, 8], at index v + 8
QUANT = np.array(
    [min(2 * ((-v) // 2) + 1, 7) if v < 0 else min(2 * (v // 2), 6)
     for v in range(-8, 9)],
    np.int32,
)


def frame_words(channels: int, windows: int) -> int:
    """64-bit words of one frame: header, LMS state, slices."""
    return 1 + 2 * channels + windows * channels
