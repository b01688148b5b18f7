"""Plain PyTorch LMS decoder over frame x channel chains.

Port of ``qoaudio_tpu/ops/decode.py`` (``decode_chains``).  One code path
serves CPU and CUDA tensors: int32 add and mul wrap in torch, ``>>`` on
int32 is arithmetic, and a sum over the 4 LMS taps is taken mod 2^32 —
the reference's ``wrapping_*`` and shift semantics (src/lib.rs:797-828).
Dequantization is a lookup in the format's table, once per window, since
it does not depend on the LMS.  This is the plain version that the CUDA
kernel in ``csrc/qoa_decode.cu`` is checked against, and what a CPU
tensor runs.
"""

from __future__ import annotations

import torch

from qoaudio_tpu import format as fmt

from .layout import be_to_logical, unpack_words

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
