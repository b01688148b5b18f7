"""Wrappers of the CUDA encode kernels (``csrc/qoa_encode.cu``).

Replace ``qoaudio_tpu/ops/pallas_encode.py::encode_frames_pallas`` and
``::encode_frames_pallas_full`` — one template in one source.  For CPU
tensors they run the plain versions (``ops/encode.py``); for CUDA tensors
they launch the kernel on the current stream or raise.
``masked_launches`` and ``full_launches`` count kernel launches.
:func:`chains_per_wave` reads how many chains one resident wave holds.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from . import encode as _plain

masked_launches = 0
full_launches = 0
_occupancy: dict = {}  # device -> (blocks per SM, SMs, chains per block)


def _launch(state, samples, lens: Optional[torch.Tensor], device):
    lib = _build.library()
    F, n_win, _, n_ch = samples.shape
    _build.require(samples, "samples", torch.int16, (F, n_win, 20, n_ch))
    _build.require(state, "state", torch.int32, (8, n_ch))
    if lens is not None:
        _build.require(lens, "lens", torch.int32, (F, n_win, n_ch))
    new_state = torch.empty((8, n_ch), dtype=torch.int32, device=device)
    snaps = torch.empty((F, 8, n_ch), dtype=torch.int32, device=device)
    words = torch.empty((F, n_win, n_ch), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if lens is None:
            rc = lib.qoa_encode_frames_full_cuda(
                samples.data_ptr(), state.data_ptr(), F, n_win, n_ch,
                new_state.data_ptr(), snaps.data_ptr(), words.data_ptr(), stream,
            )
        else:
            rc = lib.qoa_encode_frames_cuda(
                samples.data_ptr(), lens.data_ptr(), state.data_ptr(), F, n_win,
                n_ch, new_state.data_ptr(), snaps.data_ptr(), words.data_ptr(),
                stream,
            )
    _build.check(rc, "qoa_encode_frames_cuda")
    return new_state, snaps, words


def encode_frames(state: torch.Tensor, samples: torch.Tensor,
                  lens: torch.Tensor):
    """Encode F frames x N chains (contract of ``ops.encode.encode_frames``).

    state int32 (8, N); samples int16 (F, W, 20, N), zero past each
    window's length; lens int32 (F, W, N).  Returns (new_state (8, N),
    snaps (F, 8, N) int32, words (F, W, N) int64 logical).
    """
    global masked_launches
    device = _build.kernel_device(state, samples, lens)
    if device is None:
        return _plain.encode_frames(state, samples, lens)
    out = _launch(state, samples, lens, device)
    masked_launches += 1
    return out


def encode_frames_full(state: torch.Tensor, samples: torch.Tensor):
    """:func:`encode_frames` with every window full (no ``lens``)."""
    global full_launches
    device = _build.kernel_device(state, samples)
    if device is None:
        return _plain.encode_frames_full(state, samples)
    out = _launch(state, samples, None, device)
    full_launches += 1
    return out


def occupancy(device) -> tuple:
    """(resident encoder blocks per SM, SM count, chains per block) on the
    CUDA ``device``, from the CUDA occupancy calculator: the smaller of the
    masked and full variants, for their register and thread counts.
    Launches nothing."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"occupancy: {device} is not a CUDA device")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _occupancy:
        lib = _build.library()
        vals = [ctypes.c_int(0) for _ in range(3)]
        with torch.cuda.device(device):
            rc = lib.qoa_encode_occupancy(*(ctypes.byref(v) for v in vals))
        _build.check(rc, "qoa_encode_occupancy")
        _occupancy[device] = tuple(v.value for v in vals)
    return _occupancy[device]


def chains_per_wave(device) -> int:
    """Encode chains that run at once on the CUDA ``device``: resident
    blocks per SM x SMs x chains per block.  Past one wave, chains wait for
    a block to finish."""
    blocks, sms, chains = occupancy(device)
    return blocks * sms * chains
