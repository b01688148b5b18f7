"""Wrapper of the CUDA decode kernel (``csrc/qoa_decode.cu``).

Replaces ``qoaudio_tpu/ops/pallas_decode.py::decode_chains_pallas``.  For
CPU tensors :func:`decode_chains_words` runs the plain version
(``ops/decode.py``); for CUDA tensors it launches the kernel on the
current stream or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from qoaudio_tpu import format as fmt

from . import _build
from . import decode as _plain

launches = 0


def decode_chains_words(state: torch.Tensor,
                        words_be: torch.Tensor) -> torch.Tensor:
    """Decode N chains from raw big-endian slice words.

    state: int32 (8, N) frame-start LMS; words_be: int64 (W, N) raw BE
    bit patterns.  Returns int16 (W, 20, N), untrimmed.
    """
    global launches
    device = _build.kernel_device(state, words_be)
    if device is None:
        return _plain.decode_chains_words(state, words_be)
    lib = _build.library()
    n_win, n_ch = words_be.shape
    _build.require(words_be, "words_be", torch.int64, (n_win, n_ch))
    _build.require(state, "state", torch.int32, (8, n_ch))
    out = torch.empty((n_win, fmt.QOA_SLICE_LEN, n_ch), dtype=torch.int16,
                      device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.qoa_decode_chains_cuda(
            words_be.data_ptr(), state.data_ptr(), n_win, n_ch,
            out.data_ptr(), stream,
        )
    _build.check(rc, "qoa_decode_chains_cuda")
    launches += 1
    return out
