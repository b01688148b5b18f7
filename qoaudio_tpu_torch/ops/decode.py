"""Plain PyTorch LMS decoder over frame x channel chains.

Port of ``qoaudio_tpu/ops/decode.py`` (``decode_chains``,
``decode_batch``), and of the store-shape probe
``experiments/pallas_decode_variants.py::run_variant``
(``decode_chains_variant``).  One code path
serves CPU and CUDA tensors: int32 add and mul wrap in torch, ``>>`` on
int32 is arithmetic, and a sum over the 4 LMS taps is taken mod 2^32 —
the reference's ``wrapping_*`` and shift semantics (src/lib.rs:797-828).
Dequantization is a lookup in the format's table, once per window, since
it does not depend on the LMS.  These are the plain versions that the CUDA
kernel in ``csrc/qoa_decode.cu`` is checked against, and what a CPU
tensor runs.  ``decode_batch`` and ``decode_chain_arrays`` take host arrays
to a device and back through the kernel's wrapper (``cuda_decode``): the
kernel on a CUDA device, the plain version on the CPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import bitstream as bs
from .. import format as fmt
from ..utils.transfer import fetch_arrays, put_arrays

from .layout import be_to_logical, frame_major, unpack_words

_I32 = torch.int32


def decode_chains(state: torch.Tensor, sf: torch.Tensor,
                  codes: torch.Tensor) -> torch.Tensor:
    """Decode all slice windows of N independent chains.

    state: int32 (8, N) initial LMS (history rows 0-3, weights 4-7);
    sf: (W, N) scalefactors; codes: (W, 20, N) 3-bit residual codes.
    Returns int16 (W, 20, N) reconstructed samples, untrimmed.
    """
    dev = state.device
    dq_tab = torch.as_tensor(fmt.QOA_DEQUANT_TAB.reshape(-1), device=dev
                             ).to(_I32)
    hist = state[0:4].to(_I32)
    wts = state[4:8].to(_I32)
    n_win = sf.shape[0]
    out = torch.empty((n_win, fmt.QOA_SLICE_LEN, state.shape[1]),
                      dtype=torch.int16, device=dev)
    for win in range(n_win):
        dqs = dq_tab[codes[win].long() + 8 * sf[win].long()]  # (20, N)
        for k in range(fmt.QOA_SLICE_LEN):
            pred = (wts * hist).sum(0, dtype=_I32) >> 13
            dq = dqs[k]
            recon = torch.clamp(pred + dq, -32768, 32767)
            out[win, k] = recon
            delta = dq >> 4
            wts = wts + torch.where(hist < 0, -delta, delta)
            hist = torch.cat([hist[1:], recon[None]])
    return out


def decode_chains_words(state: torch.Tensor,
                        words_be: torch.Tensor) -> torch.Tensor:
    """Decode N chains from raw big-endian slice words.

    state: int32 (8, N) frame-start LMS; words_be: int64 (W, N) raw BE
    bit patterns (``ParsedArrays.words_be`` viewed as int64; zero padding
    allowed).  Returns int16 (W, 20, N), untrimmed — the CUDA kernel's
    contract.
    """
    sf, codes = unpack_words(be_to_logical(words_be))
    return decode_chains(state, sf, codes)


def decode_chain_arrays(words_be: np.ndarray, state: np.ndarray, F: int,
                        C: int, device) -> np.ndarray:
    """Host chain arrays, decoded in ONE launch on ``device``.

    words_be: uint64 (W, N) raw big-endian slice words, state: int32
    (8, N), chain = frame * C + channel; chains past ``F * C`` are padding
    and dropped.  Returns the frames' untrimmed interleaved PCM, int16
    (F, W*20, C), on the host.
    """
    from . import cuda_decode  # it imports this module for the plain version

    words_d, state_d = put_arrays([words_be.view(np.int64), state], device)
    dec = cuda_decode.decode_chains_words(state_d, words_d)
    (pcm,) = fetch_arrays([frame_major(dec[:, :, : F * C], F, C)])
    return pcm


def decode_batch(batch: bs.FrameBatch, device,
                 pad_chains_to: Optional[int] = None,
                 pad_windows_to: Optional[int] = None) -> np.ndarray:
    """Decode a host FrameBatch on ``device`` -> int16 (F, W*20, C),
    untrimmed.

    ``pad_chains_to`` / ``pad_windows_to`` pad the chain / window axes with
    zero words (one launch shape for files of different sizes); the padded
    chains and trailing padded windows are dropped.
    """
    F, W, C = batch.sf.shape
    N = F * C
    Np = max(pad_chains_to or N, N)
    Wp = max(pad_windows_to or W, W)
    words_be, state = bs.batch_chain_arrays(batch)
    if (Wp, Np) != (W, N):
        words_p = np.zeros((Wp, Np), np.uint64)
        words_p[:W, :N] = words_be
        state_p = np.zeros((8, Np), np.int32)
        state_p[:, :N] = state
        words_be, state = words_p, state_p
    pcm = decode_chain_arrays(words_be, state, F, C, device)
    return pcm[:, : W * fmt.QOA_SLICE_LEN]


VARIANT_MODES = ("v0", "nostore", "storeonly", "stack", "pack32")


def decode_chains_variant(state: torch.Tensor, words_be: torch.Tensor,
                          mode: str) -> torch.Tensor:
    """The decode with one of the probe's five store shapes (the
    counterpart of ``run_variant``'s ``mode``); same inputs as
    :func:`decode_chains_words`.

    * ``v0``, ``stack``: the decoded samples, int16 (W, 20, N);
    * ``pack32``: int32 (W, 10, N), element j = (s[2j] & 0xFFFF) |
      (s[2j+1] << 16);
    * ``storeonly``: int16 (W, 20, N), out[w, k, n] = code k of word (w, n);
    * ``nostore``: int16 (W, 20, N) whose out[0, 0, :] is each chain's final
      h[3] (its last decoded sample); the rest is defined only here (0).
    """
    if mode not in VARIANT_MODES:
        raise ValueError(f"unknown store mode {mode!r}")
    if mode == "storeonly":
        return unpack_words(be_to_logical(words_be))[1].to(torch.int16)
    out = decode_chains_words(state, words_be)
    if mode == "pack32":
        pair = out.reshape(out.shape[0], fmt.QOA_SLICE_LEN // 2, 2, -1).to(torch.int64)
        v = (pair[:, :, 0] & 0xFFFF) | ((pair[:, :, 1] & 0xFFFF) << 16)
        return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)
    if mode == "nostore":
        last = torch.zeros_like(out)
        if out.shape[0]:
            last[0, 0] = out[-1, -1]
        return last
    return out


def unpack_pack32(packed: torch.Tensor) -> torch.Tensor:
    """``"pack32"`` output int32 (W, 10, N) -> the samples int16
    (W, 20, N) (the counterpart of the probe's ``unpack32``)."""
    v = packed.to(torch.int64)
    halves = torch.stack([v & 0xFFFF, (v >> 16) & 0xFFFF], 2)  # (W, 10, 2, N)
    halves = ((halves ^ 0x8000) - 0x8000).to(torch.int16)
    return halves.reshape(packed.shape[0], fmt.QOA_SLICE_LEN, packed.shape[2])
