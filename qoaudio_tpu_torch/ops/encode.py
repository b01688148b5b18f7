"""Plain PyTorch encoder: all 16 scalefactor candidates, bit-exact.

Port of ``qoaudio_tpu/ops/encode.py`` (``encode_frames``).  Each window
evaluates the 16 candidates as a (16, N) plane and keeps the lexicographic
argmin over (total rank, first-sample rank, sf) — the reference's sorted,
early-exit search picks the same candidate (SURVEY.md §3.3), and a full
tie goes to the lowest sf.

Ranks are int64 sums of err^2 and penalty^2: err^2 < 2^32 exactly,
penalty <= 8191, and 20 steps fit easily.  (The JAX package's two-limb
u32 ranks and biased compares exist only because Mosaic has no 64-bit
integers; they are not translated.)  All other arithmetic is int32 with
torch's wrapping add/mul and arithmetic ``>>``, as in the reference; a
sum over the 4 LMS taps is taken mod 2^32, which is the wrapping sum.
Quantize and dequantize are lookups in the format's tables.

This is the plain version the CUDA kernels in ``csrc/qoa_encode.cu`` are
checked against, and what a CPU tensor runs.  Every step is a handful of
whole-plane torch ops, so its cost is per-op overhead times
F x W x 20 steps.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import format as fmt

_NSF = fmt.QOA_NUM_SCALEFACTORS  # 16
_SLEN = fmt.QOA_SLICE_LEN  # 20
_I32 = torch.int32
_I64 = torch.int64
_I64_MAX = torch.iinfo(_I64).max


def _lane_constants(device):
    """Per-candidate constants: reciprocal (16, 1), flat dequant table
    with each candidate's row offset, the quant table over [-8, 8], and
    the sf bits of the u64 word."""
    recip = torch.tensor([int(v) for v in fmt.QOA_RECIPROCAL_TAB],
                         dtype=_I32, device=device)[:, None]
    dq_tab = torch.as_tensor(fmt.QOA_DEQUANT_TAB.reshape(-1), device=device
                             ).to(_I32)
    row8 = torch.arange(_NSF, dtype=_I64, device=device)[:, None] * 8
    quant_tab = torch.as_tensor(fmt.QOA_QUANT_TAB, device=device).to(_I64)
    sfbits = torch.arange(_NSF, dtype=_I64, device=device)[:, None] << 60
    return recip, dq_tab, row8, quant_tab, sfbits


def _encode_window(carry, x, length, consts):
    """One 20-sample window for N chains, all 16 candidates.

    carry: int32 (8, N); x: int32 (20, N) samples (zero past ``length``);
    length: int32 (N,) valid count, or None when every window is full.
    Returns (new_carry (8, N) int32, word (N,) int64 logical).
    """
    recip, dq_tab, row8, quant_tab, sfbits = consts
    n_ch = carry.shape[1]
    hist = carry[0:4, None, :].expand(4, _NSF, n_ch)  # (4, 16, N)
    wts = carry[4:8, None, :].expand(4, _NSF, n_ch)
    rank = torch.zeros((_NSF, n_ch), dtype=_I64, device=carry.device)
    first = rank
    word = sfbits.expand(_NSF, n_ch)

    for k in range(_SLEN):
        pred = (wts * hist).sum(0, dtype=_I32) >> 13
        ssum = (wts * wts).sum(0, dtype=_I32)
        pen = torch.clamp_min((ssum >> 18) - 0x8FF, 0).to(_I64)

        sample = x[k]
        residual = sample - pred
        # qoa_div: wrapping reciprocal multiply, +0.5 bias, then the
        # away-from-zero fix from BOTH signs (the multiply can wrap)
        n = (residual * recip + (1 << 15)) >> 16
        scaled = n + torch.clamp(residual, -1, 1) - torch.clamp(n, -1, 1)
        q = quant_tab[torch.clamp(scaled, -8, 8) + 8]  # (16, N) int64
        dq = dq_tab[q + row8]
        recon = torch.clamp(pred + dq, -32768, 32767)

        err = (sample - recon).to(_I64)
        inc = err * err + pen * pen
        delta = dq >> 4
        new_w = wts + torch.where(hist < 0, -delta, delta)
        new_h = torch.cat([hist[1:], recon[None]])
        if length is None:
            wts, hist = new_w, new_h
        else:
            active = length > k
            inc = torch.where(active, inc, 0)
            q = torch.where(active, q, 0)
            wts = torch.where(active, new_w, wts)
            hist = torch.where(active, new_h, hist)
        rank = rank + inc
        if k == 0:
            first = rank
        word = word | (q << (57 - 3 * k))

    # lexicographic argmin over (total, first, sf); ties -> lowest sf
    ok = rank == rank.min(0, keepdim=True).values
    fk = torch.where(ok, first, _I64_MAX)
    ok = ok & (fk == fk.min(0, keepdim=True).values)
    sf_idx = torch.arange(_NSF, device=carry.device)[:, None]
    pick = torch.where(ok, sf_idx, _NSF).min(0, keepdim=True).values  # (1, N)
    lms = torch.cat([hist, wts]).gather(1, pick.expand(8, 1, n_ch))
    return lms[:, 0], word.gather(0, pick)[0]


def _encode(state, samples, lens: Optional[torch.Tensor]):
    F, n_win = samples.shape[0], samples.shape[1]
    n_ch = samples.shape[3]
    dev = samples.device
    consts = _lane_constants(dev)
    carry = state.to(_I32)
    snaps = torch.empty((F, 8, n_ch), dtype=_I32, device=dev)
    words = torch.empty((F, n_win, n_ch), dtype=_I64, device=dev)
    for f in range(F):
        snaps[f] = carry
        for w in range(n_win):
            x = samples[f, w].to(_I32)
            length = None if lens is None else lens[f, w].to(_I32)
            carry, words[f, w] = _encode_window(carry, x, length, consts)
    return carry, snaps, words


def encode_frames(state: torch.Tensor, samples: torch.Tensor,
                  lens: torch.Tensor):
    """Encode F frames x N chains, chaining LMS across all windows.

    state: int32 (8, N); samples: int16 (F, W, 20, N), zero past each
    window's length; lens: int32 (F, W, N) valid samples per window (0 for
    padding, which passes the state through unchanged).
    Returns (new_state (8, N) int32, snaps (F, 8, N) int32 — the LMS at
    each frame start, words (F, W, N) int64 logical slice words).
    """
    return _encode(state, samples, lens)


def encode_frames_full(state: torch.Tensor, samples: torch.Tensor):
    """:func:`encode_frames` with every window full (20 valid samples)."""
    return _encode(state, samples, None)
