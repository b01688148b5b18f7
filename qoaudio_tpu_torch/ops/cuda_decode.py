"""Wrappers of the CUDA decode kernel (``csrc/qoa_decode.cu``).

:func:`decode_chains_words` replaces
``qoaudio_tpu/ops/pallas_decode.py::decode_chains_pallas``;
:func:`decode_chains_variant` replaces the store-shape probe
``experiments/pallas_decode_variants.py::run_variant`` (one template: its
``"v0"`` is the production kernel).  For CPU tensors they run the plain
versions (``ops/decode.py``); for CUDA tensors they launch the kernel on
the current stream or raise.  ``launches`` and ``variant_launches`` count
kernel launches.
"""

from __future__ import annotations

import torch

from .. import format as fmt

from . import _build
from . import decode as _plain

launches = 0
variant_launches = 0
# the block sizes csrc/qoa_decode.cu compiles the probe for (each its own
# instantiation, with that launch bound)
VARIANT_THREADS = (64, 128, 256)


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


def decode_chains_variant(state: torch.Tensor, words_be: torch.Tensor,
                          mode: str, threads: int = 64) -> torch.Tensor:
    """The decode with store mode ``mode`` (``ops.decode.VARIANT_MODES``;
    contract of ``ops.decode.decode_chains_variant``), ``threads`` chains
    per block on the card (one of ``VARIANT_THREADS``; 64 is the
    production decode's block, and ``"v0"`` at 64 is its kernel).  Returns int16
    (W, 20, N), or int32 (W, 10, N) for ``"pack32"``; for ``"nostore"``
    only out[0, 0, :] is written on the card.
    """
    global variant_launches
    if mode not in _plain.VARIANT_MODES:
        raise ValueError(f"unknown store mode {mode!r}")
    if threads not in VARIANT_THREADS:
        raise ValueError(f"threads must be one of {VARIANT_THREADS}, got {threads}")
    device = _build.kernel_device(state, words_be)
    if device is None:
        return _plain.decode_chains_variant(state, words_be, mode)
    lib = _build.library()
    n_win, n_ch = words_be.shape
    _build.require(words_be, "words_be", torch.int64, (n_win, n_ch))
    _build.require(state, "state", torch.int32, (8, n_ch))
    if mode == "pack32":
        out = torch.empty((n_win, fmt.QOA_SLICE_LEN // 2, n_ch), dtype=torch.int32,
                          device=device)
    else:
        out = torch.empty((n_win, fmt.QOA_SLICE_LEN, n_ch), dtype=torch.int16,
                          device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.qoa_decode_variant_cuda(
            words_be.data_ptr(), state.data_ptr(), n_win, n_ch, out.data_ptr(),
            _plain.VARIANT_MODES.index(mode), threads, stream,
        )
    _build.check(rc, "qoa_decode_variant_cuda")
    variant_launches += 1
    return out
