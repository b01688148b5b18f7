"""The card's peaks and the least time the QOA kernels' work could take.

The work is counted from the algorithm, on the shapes the benchmark made,
never from the program's machine code: a kernel that issues fewer
instructions raises its share of the bound and leaves the bound where it
is.

Operations are the integer operations of the frozen reference's
arithmetic (``reference/codec.py``), per sample of each chain:

decode, 28: the code's shift and mask (2); the dequantize lookup and its
  row offset (2); the 4-tap prediction, 4 multiplies, 3 adds and a shift
  (8); reconstruct, an add and a clamp of two compares (3); the LMS update,
  the delta's shift and per tap a compare, a select and an add (13).
encode, 16 x 57 + 4 = 916: for each of the 16 scalefactor candidates the
  prediction (8); the weights penalty, 4 multiplies, 3 adds, a shift, a
  subtract, a max and its square (11); the residual (1); the reciprocal
  division, a multiply, an add and a shift, then two sign clamps of two
  compares each, an add and a subtract (9); quantize, a clamp, an offset
  and a lookup (4); dequantize, an offset and a lookup (2); reconstruct (3);
  the error, its square and the rank's two adds (4); the LMS update (13);
  the code's shift and or into the slice word (2).  Per window of 20
  samples the argmin over the 16 candidates' (rank, first rank, scalefactor)
  and the gather of the winner's state, about 80, so 4 a sample.

Bytes: each input byte read once and each output byte written once.
Decode reads a slice word (8 bytes) per 20 samples and 16 bytes of LMS
state per frame of a channel, and writes 2 bytes a sample; encode reads 2
bytes a sample and writes the slice words and the state.

Peaks of one NVIDIA H100 SXM (data sheet; ``utils/roofline.py`` of the
program holds the same constants): 132 SMs, 128 int32 operations per SM
per clock (the ALU and FMA pipes together), 3.35 TB/s of HBM3.  The clock
is the SM clock read beside the window.
"""

from __future__ import annotations

SMS = 132
INT_OPS_PER_SM_PER_CLOCK = 128
HBM_BYTES_PER_S = 3.35e12
MAX_SM_CLOCK_MHZ = 1980.0  # the data sheet's boost clock, where none is read

DECODE_OPS_PER_SAMPLE = 28
ENCODE_OPS_PER_CANDIDATE_SAMPLE = 57
ENCODE_ARGMIN_OPS_PER_SAMPLE = 4
ENCODE_OPS_PER_SAMPLE = 16 * ENCODE_OPS_PER_CANDIDATE_SAMPLE + ENCODE_ARGMIN_OPS_PER_SAMPLE

SLICE_BYTES_PER_SAMPLE = 8 / 20
STATE_BYTES_PER_FRAME_CHAIN = 16
PCM_BYTES_PER_SAMPLE = 2


def int_ops_per_s(sm_clock_mhz: float) -> float:
    return SMS * INT_OPS_PER_SM_PER_CLOCK * sm_clock_mhz * 1e6


def _bound(ops: float, nbytes: float, sm_clock_mhz: float) -> float:
    return max(ops / int_ops_per_s(sm_clock_mhz), nbytes / HBM_BYTES_PER_S)


def decode_bound_s(samples: int, frame_chains: int, sm_clock_mhz: float) -> float:
    """Least seconds to decode ``samples`` (over all channels) held in
    ``frame_chains`` frames of a channel."""
    nbytes = (samples * (SLICE_BYTES_PER_SAMPLE + PCM_BYTES_PER_SAMPLE)
              + frame_chains * STATE_BYTES_PER_FRAME_CHAIN)
    return _bound(samples * DECODE_OPS_PER_SAMPLE, nbytes, sm_clock_mhz)


def encode_bound_s(samples: int, frame_chains: int, sm_clock_mhz: float) -> float:
    """Least seconds to encode ``samples`` into ``frame_chains`` frames of
    a channel, searching all 16 scalefactors."""
    nbytes = (samples * (SLICE_BYTES_PER_SAMPLE + PCM_BYTES_PER_SAMPLE)
              + frame_chains * STATE_BYTES_PER_FRAME_CHAIN)
    return _bound(samples * ENCODE_OPS_PER_SAMPLE, nbytes, sm_clock_mhz)
