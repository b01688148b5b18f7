"""The QOA decoder and the 16-candidate encoder, plain PyTorch.

Both work on frame chains: one channel of one frame, 5,120 samples at
most, started from the LMS state its frame header carries.  Chains are
independent, so any number of them run side by side on any device, one
whole-tensor operation per step of the serial LMS recurrence.  An LMS
state is (8, chains) int32: history taps 0-3, then weights 0-3.

Integer arithmetic is int32 and wraps, as in the reference crate
(``src/lib.rs:606-617``): prediction, penalty, reciprocal division and the
weight update; a sum over the 4 taps in int32 is the wrapping sum.  The
encoder searches all 16 scalefactors of every 20-sample window and keeps
the candidate of least total rank (the sum over the window of the squared
error plus the squared weights penalty), ties going to the least rank of
the first sample, then to the lowest scalefactor.  That is the candidate
the reference's sorted search with early exit accepts.

``predict="float32"`` computes the 4-tap prediction in float32 instead of
wrapping int32.  It is no QOA encoder: it is the benchmark's control, the
lower precision that would tempt a faster kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .tables import DEQUANT, INITIAL_WEIGHTS, NUM_SF, QUANT, RECIPROCAL, SLICE_LEN

_I32, _I64 = torch.int32, torch.int64
_I64_MAX = torch.iinfo(_I64).max
_CODE_SHIFT = [57 - 3 * k for k in range(SLICE_LEN)]


def initial_state(n: int, device) -> torch.Tensor:
    """(n, 8) int32: history 0, the encoder's initial weights."""
    s = torch.zeros((n, 8), dtype=_I32, device=device)
    s[:, 4:] = torch.tensor(INITIAL_WEIGHTS, dtype=_I32, device=device)
    return s


def decode_chains(start: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """start (N, 8) int32; words (N, W) int64 slice words.  Returns the
    decoded samples (N, W * 20) int16, untrimmed."""
    n, n_win = words.shape
    dev = words.device
    dq_tab = torch.as_tensor(DEQUANT.reshape(-1), device=dev)
    shifts = torch.tensor(_CODE_SHIFT, dtype=_I64, device=dev)
    h = start[:, 0:4].t()
    w = start[:, 4:8].t()
    out = torch.empty((n_win, SLICE_LEN, n), dtype=torch.int16, device=dev)
    for win in range(n_win):
        word = words[:, win]
        row = ((word >> 60) & 15) * 8
        dqs = dq_tab[row[None, :] + ((word[None, :] >> shifts[:, None]) & 7)]
        for k in range(SLICE_LEN):
            dq = dqs[k]
            p = (w * h).sum(0, dtype=_I32) >> 13
            r = torch.clamp(p + dq, -32768, 32767)
            out[win, k] = r
            delta = dq >> 4
            w = w + torch.where(h < 0, -delta, delta)
            h = torch.cat([h[1:], r[None]])
    return out.permute(2, 0, 1).reshape(n, n_win * SLICE_LEN)


class Encoder:
    """The encoder's constants on one device, and one window of it."""

    def __init__(self, device, predict: str = "int32"):
        if predict not in ("int32", "float32"):
            raise ValueError(f"predict must be int32 or float32, got {predict!r}")
        self.predict = predict
        self.recip = torch.as_tensor(RECIPROCAL, device=device)[:, None]
        self.dq_tab = torch.as_tensor(DEQUANT.reshape(-1), device=device)
        self.quant = torch.as_tensor(QUANT, device=device).to(_I64)
        self.row8 = torch.arange(NUM_SF, dtype=_I64, device=device)[:, None] * 8
        self.sfbits = torch.arange(NUM_SF, dtype=_I64, device=device)[:, None] << 60
        self.sf_idx = torch.arange(NUM_SF, dtype=_I64, device=device)[:, None]

    def _prediction(self, h, w):
        if self.predict == "int32":
            return (w * h).sum(0, dtype=_I32) >> 13
        s = (w.to(torch.float32) * h.to(torch.float32)).sum(0)
        return torch.floor(s / 8192.0).to(_I32)

    def window(self, state: torch.Tensor, x: torch.Tensor,
               length: Optional[torch.Tensor]):
        """One window of every chain.  state (8, N) int32; x (20, N)
        samples; length (N,) valid samples of this window, or None when
        all 20 are.  Returns (word (N,) int64 slice word, state (8, N))."""
        n = x.shape[1]
        h = state[0:4, None, :].expand(4, NUM_SF, n)
        w = state[4:8, None, :].expand(4, NUM_SF, n)
        rank = torch.zeros((NUM_SF, n), dtype=_I64, device=x.device)
        first = rank
        word = self.sfbits.expand(NUM_SF, n)
        for k in range(SLICE_LEN):
            p = self._prediction(h, w)
            pen = torch.clamp_min(((w * w).sum(0, dtype=_I32) >> 18) - 0x8FF, 0).to(_I64)
            s = x[k].to(_I32)
            r = s - p
            m = (r * self.recip + (1 << 15)) >> 16
            scaled = m + torch.clamp(r, -1, 1) - torch.clamp(m, -1, 1)
            q = self.quant[(torch.clamp(scaled, -8, 8) + 8).to(_I64)]
            dq = self.dq_tab[q + self.row8]
            recon = torch.clamp(p + dq, -32768, 32767)
            err = (s - recon).to(_I64)
            inc = err * err + pen * pen
            delta = dq >> 4
            w2 = w + torch.where(h < 0, -delta, delta)
            h2 = torch.cat([h[1:], recon[None]])
            if length is None:
                w, h = w2, h2
            else:
                on = length > k
                inc = torch.where(on, inc, 0)
                q = torch.where(on, q, 0)
                w = torch.where(on, w2, w)
                h = torch.where(on, h2, h)
            rank = rank + inc
            if k == 0:
                first = rank
            word = word | (q << _CODE_SHIFT[k])
        # least (total rank, first rank, scalefactor)
        ok = rank == rank.min(0, keepdim=True).values
        fk = torch.where(ok, first, _I64_MAX)
        ok = ok & (fk == fk.min(0, keepdim=True).values)
        pick = torch.where(ok, self.sf_idx, NUM_SF).min(0, keepdim=True).values  # (1, N)
        lms = torch.cat([h, w]).gather(1, pick[None].expand(8, 1, n))[:, 0]
        return word.gather(0, pick)[0], lms


def window_lengths(nsamp: np.ndarray, win: int) -> Optional[np.ndarray]:
    """Valid samples of window ``win`` of each chain; None when all 20."""
    ln = np.clip(np.asarray(nsamp, np.int64) - SLICE_LEN * win, 0, SLICE_LEN)
    return None if bool((ln == SLICE_LEN).all()) else ln


def encode_chains(start: torch.Tensor, x: torch.Tensor, nsamp: np.ndarray,
                  predict: str = "int32"):
    """Encode N frame chains.

    start (N, 8) int32 LMS at each chain's start; x (W, 20, N) int16
    samples; nsamp (N,) host integers, the samples of each chain.  Returns
    (words (N, W) int64 slice words, end (N, 8) int32 LMS after each
    chain's last sample).  Words past a chain's last window are undefined.
    """
    enc = Encoder(x.device, predict)
    n_win, _, n = x.shape
    used = int(-(-np.max(nsamp) // SLICE_LEN)) if n else 0
    state = start.t().contiguous()
    words = torch.zeros((n, n_win), dtype=_I64, device=x.device)
    for win in range(used):
        ln = window_lengths(nsamp, win)
        length = None if ln is None else torch.as_tensor(ln, device=x.device)
        words[:, win], state = enc.window(state, x[win], length)
    return words, state.t().contiguous()
