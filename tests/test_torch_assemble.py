"""The port's stream assembly (``ops/assemble.py``, through the
``ops.cuda_assemble`` wrapper's CPU route) held byte for byte against
``bitstream.assemble_stream_bytes``, the host assembly of one file.

The inputs are the encoder's outputs as each caller lays them out:
``batch_encode`` (chains in input order, the chain axis padded to the
mesh's multiple, ``W_use`` windows) and ``batch_transcode`` (one chain a
channel, no padding, ``W_enc`` windows); and files with padding chains
between them.  Snapshots and words are random: the assembly copies and
packs them, whatever they hold.
"""

import zlib

import numpy as np
import pytest
import torch

from qoaudio_tpu_torch import bitstream as bs
from qoaudio_tpu_torch import format as fmt
from qoaudio_tpu_torch.ops import assemble, cuda_assemble

LENGTHS = (1, 19, 20, 5_119, 5_120, 5_121, 10_241)
# a last frame of 5,101-5,119 samples: 256 windows, like a full one
TAILS = (2 * 5_120 + 5_101, 5_120 + 5_110, 5_119 + 3 * 5_120)
MIXED = [(1, 44_100, 300), (2, 48_000, 5_197), (8, 22_050, 10_241),
         (1, 16_000, 5_120 + 5_110), (3, (1 << 24) + 5, 41), (2, 44_100, 20)]

CASES = (
    [(f"{c}ch-{t}-{caller}", [(c, 44_100, t)], caller, 0, False)
     for c in (1, 2, 8) for t in LENGTHS for caller in ("encode", "transcode")]
    + [(f"tail-{c}ch-{t}-{caller}", [(c, 44_100, t)], caller, 0, False)
       for c in (1, 2) for t in TAILS for caller in ("encode", "transcode")]
    + [(f"wide-weights-{c}ch-{caller}", [(c, 48_000, 10_241)], caller, 0, True)
       for c in (2, 8) for caller in ("encode", "transcode")]
    + [(f"mixed-{caller}", MIXED, caller, 0, True) for caller in ("encode", "transcode")]
    + [("mixed-padding-chains", MIXED, "transcode", 3, True),
       ("mixed-rate-over-24-bits", [(2, (1 << 31) + 3, 5_121), (1, 0xFFFFFFFF, 99)],
        "encode", 1, False)]
)


def _layout(files, caller: str, gap: int):
    """(F, W, N, first chain of each file) of ``caller``'s encoder
    outputs, with ``gap`` padding chains before each file."""
    F = max(-(-t // fmt.QOA_FRAME_LEN) for _, _, t in files)
    multi = any(t > fmt.QOA_FRAME_LEN for _, _, t in files)
    W = fmt.QOA_SLICES_PER_FRAME if multi else max(
        -(-t // fmt.QOA_SLICE_LEN) for _, _, t in files)
    chains, n = [], 0
    for c, _, _ in files:
        n += gap
        chains.append(n)
        n += c
    if caller == "encode":
        n = -(-n // 4) * 4  # a 4-device mesh's padding chains
    return F, W, n, chains


@pytest.mark.parametrize("name,files,caller,gap,wide", CASES, ids=[c[0] for c in CASES])
def test_assembly_equals_the_host_assembly(name, files, caller, gap, wide):
    F, W, N, chains = _layout(files, caller, gap)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    hi = 1 << 31 if wide else 1 << 15  # weights beyond the i16 range truncate
    snaps = rng.integers(-hi, hi, size=(F, 8, N)).astype(np.int32)
    words = rng.integers(-(1 << 63), 1 << 63, size=(F, W, N), dtype=np.int64)
    table, n_bytes, n_frames = assemble.file_table(
        [c for c, _, _ in files], [r for _, r, _ in files], [t for _, _, t in files], chains)
    before = cuda_assemble.launches
    out = cuda_assemble.assemble_streams(torch.from_numpy(snaps), torch.from_numpy(words),
                                         torch.from_numpy(table), n_bytes, n_frames)
    assert cuda_assemble.launches == before  # a CPU tensor runs the plain version
    assert out.dtype == torch.uint8 and out.shape == (n_bytes,)
    got = out.numpy().tobytes()
    ends = [*table[assemble.OFFSET][1:], n_bytes]
    assert n_frames == sum(-(-t // fmt.QOA_FRAME_LEN) for _, _, t in files)
    for (c, rate, t), j, a, b in zip(files, chains, table[assemble.OFFSET], ends):
        f = -(-t // fmt.QOA_FRAME_LEN)
        want = bs.assemble_stream_bytes(c, rate, t, snaps[:f, :, j : j + c],
                                        words[:f, :, j : j + c].view(np.uint64))
        assert got[a:b] == want, (c, rate, t)
