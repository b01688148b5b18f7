"""QOA format constants, quantization tables and header framing.

A copy of ``qoaudio_tpu/format.py``: the port imports nothing of the JAX
package, so it keeps its own host tier (tests/test_torch_host.py holds
every copy against its original).

This is the L1 layer of the framework (cf. reference survey: constants at
``src/lib.rs:12-19``, tables at ``src/lib.rs:22-27,831-864``,
header pack/unpack at ``src/lib.rs:217-225,448-452``, frame size at
``src/lib.rs:602-604``).

Everything here is host-side numpy.  The tables are *derived* from the QOA
specification formulas (https://qoaformat.org) rather than hard-coded, and are
pinned by golden tests in ``tests/test_format.py``.

A QOA stream, entirely big-endian:

* file header (8 B): magic ``qoaf`` + u32 total samples/channel
  (0 => streaming mode).
* frame: u64 header ``channels(8b) | sample_rate(24b) | samples_per_channel
  (16b) | frame_size_bytes(16b)``; then per channel 16 B of LMS state
  (4 x i16 history, 4 x i16 weights); then, for each 20-sample window, one
  u64 slice per channel (channel-major within the window).
* slice (u64): ``scalefactor(4b)`` then 20 x 3-bit residual codes, MSB first.
  A short final slice left-shifts its payload to the top bits.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Geometry constants (reference: src/lib.rs:12-19)
# ---------------------------------------------------------------------------

QOA_SLICE_LEN = 20
QOA_LMS_LEN = 4
QOA_HEADER_SIZE = 8
QOA_MAGIC = int.from_bytes(b"qoaf", "big")
MAX_SLICES_PER_CHANNEL_PER_FRAME = 256
QOA_SLICES_PER_FRAME = 256
QOA_FRAME_LEN = QOA_SLICES_PER_FRAME * QOA_SLICE_LEN  # 5120
QOA_MAX_CHANNELS = 8

QOA_NUM_SCALEFACTORS = 16

# Bytes of serialized LMS state per channel in a frame header.
QOA_LMS_STATE_BYTES = 2 * 8  # one u64 of history + one u64 of weights

# Encoder's initial LMS weights per channel (reference: src/lib.rs:346-352).
QOA_INITIAL_WEIGHTS = (0, 0, -(1 << 13), 1 << 14)


def _round_ties_away(x: float) -> int:
    """Round half away from zero (C's round()), used by the spec tables."""
    import math

    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


def _build_tables():
    """Derive the four static tables from the QOA spec formulas.

    * scalefactor_tab[s] = round((s+1)^2.75)
    * reciprocal_tab[s]  = ((1<<16) + sf - 1) // sf      (fixed point 1/sf)
    * dequant_tab[s][q]  = round(sf * [0.75,-0.75,2.5,-2.5,4.5,-4.5,7,-7][q])
    * quant_tab[r+8]     = 3-bit code for clamped scaled residual r in -8..8
    """
    sf_tab = [
        _round_ties_away((s + 1) ** 2.75) for s in range(QOA_NUM_SCALEFACTORS)
    ]
    reciprocal = [((1 << 16) + sf - 1) // sf for sf in sf_tab]
    dq_multipliers = [0.75, -0.75, 2.5, -2.5, 4.5, -4.5, 7.0, -7.0]
    dequant = [
        [_round_ties_away(sf * m) for m in dq_multipliers] for sf in sf_tab
    ]
    # quant code for scaled residual v in [-8, 8]:
    #   v < 0  -> odd codes 1,3,5,7 (magnitude), capped at 7
    #   v >= 0 -> even codes 0,2,4,6, capped at 6
    quant = []
    for v in range(-8, 9):
        if v < 0:
            quant.append(min(2 * ((-v) // 2) + 1, 7))
        else:
            quant.append(min(2 * (v // 2), 6))
    return (
        np.asarray(sf_tab, dtype=np.int32),
        np.asarray(reciprocal, dtype=np.int32),
        np.asarray(dequant, dtype=np.int32),
        np.asarray(quant, dtype=np.int32),
    )


# QOA_SCALEFACTOR_TAB is implicit in the reference (folded into the other
# tables); the remaining three mirror src/lib.rs:22-27 and :847-864.
QOA_SCALEFACTOR_TAB, QOA_RECIPROCAL_TAB, QOA_DEQUANT_TAB, QOA_QUANT_TAB = (
    _build_tables()
)

# Magnitudes of the dequant table: QOA_DEQUANT_TAB[s, q] ==
# sign(q) * QOA_DEQUANT_MAG[s, q >> 1] with sign +1 for even codes.  This
# 16x4 form is what the device kernels use (gather-free 4-term select).
QOA_DEQUANT_MAG = QOA_DEQUANT_TAB[:, 0::2].copy()


# ---------------------------------------------------------------------------
# Frame geometry (reference: src/lib.rs:602-604)
# ---------------------------------------------------------------------------

def qoa_frame_size(channels: int, slices: int) -> int:
    """Size in bytes of a frame: header + LMS state + slice words."""
    return 8 + QOA_LMS_LEN * 4 * channels + 8 * slices * channels


# ---------------------------------------------------------------------------
# Header pack / unpack (reference: src/lib.rs:217-225 and :448-452)
# ---------------------------------------------------------------------------

def pack_file_header(samples: int) -> bytes:
    return QOA_MAGIC.to_bytes(4, "big") + int(samples).to_bytes(4, "big")


def unpack_file_header(data: bytes) -> int:
    """Return total samples/channel; raise NotQoaFile on bad magic."""
    from .errors import NotQoaFile, IoError

    if len(data) < QOA_HEADER_SIZE:
        raise IoError("unexpected EOF reading file header")
    if int.from_bytes(data[:4], "big") != QOA_MAGIC:
        raise NotQoaFile()
    return int.from_bytes(data[4:8], "big")


def pack_frame_header(
    channels: int, sample_rate: int, samples_per_channel: int, frame_size: int
) -> int:
    """Pack the u64 frame header.

    Mirrors the reference exactly (src/lib.rs:448-452), including the
    behavior that an out-of-range sample rate ORs into the channel bits.
    """
    return (
        ((channels & 0xFF) << 56)
        | ((sample_rate & 0xFFFFFFFF) << 32)
        | ((samples_per_channel & 0xFFFF) << 16)
        | (frame_size & 0xFFFF)
    ) & 0xFFFFFFFFFFFFFFFF


def unpack_frame_header(word: int):
    """u64 -> (channels, sample_rate, samples_per_channel, frame_size)."""
    channels = (word >> 56) & 0xFF
    sample_rate = (word >> 32) & 0xFFFFFF
    samples_per_channel = (word >> 16) & 0xFFFF
    frame_size = word & 0xFFFF
    return channels, sample_rate, samples_per_channel, frame_size
