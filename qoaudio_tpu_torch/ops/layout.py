"""Word and state layouts shared by the plain ops, the kernels and the tests.

The port carries every u64 slice word as an **int64 bit pattern**: PyTorch
has no uint32 shifts, compares or min on the CPU, and int64 holds a whole
word.  int64 ``>>`` is arithmetic, so every right shift of a word is
followed by a mask.  Two word forms occur:

* raw big-endian words, as they sit in a stream's bytes
  (``ParsedArrays.words_be``) — what the decode kernel reads and
  byteswaps itself;
* logical words (the u64 value, sf in bits 60-63, code k in bits
  57-3k..59-3k) — what the encoder emits.

The JAX package's Pallas kernels split logical words into u32 halves;
``words_from_halves`` / ``halves_from_words`` convert.  LMS state keeps the
JAX package's ``(8, N)`` int32 layout: rows 0-3 history, rows 4-7 weights.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF


def words_from_halves(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Logical u32 halves ``(..., N)`` (any integer dtype holding values
    in [0, 2^32)) -> int64 bit patterns of the logical u64 words."""
    hi = hi.to(torch.int64) & _MASK32
    lo = lo.to(torch.int64) & _MASK32
    return (hi << 32) | lo


def halves_from_words(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 logical words -> (hi, lo) int64 tensors in [0, 2^32)."""
    return (words >> 32) & _MASK32, words & _MASK32


def byteswap64(words: torch.Tensor) -> torch.Tensor:
    """Reverse the 8 bytes of every int64 element (an involution)."""
    w = words.to(torch.int64).contiguous()
    b = w.view(torch.uint8).reshape(*w.shape, 8).flip(-1).contiguous()
    return b.view(torch.int64).reshape(w.shape)


def be_to_logical(words_be: torch.Tensor) -> torch.Tensor:
    """Raw big-endian words (int64 bit patterns) -> logical words."""
    return byteswap64(words_be)


def logical_to_be(words: torch.Tensor) -> torch.Tensor:
    """Logical words -> raw big-endian words (int64 bit patterns)."""
    return byteswap64(words)


def unpack_words(logical: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Logical words ``(W, N)`` -> (sf ``(W, N)``, codes ``(W, 20, N)``)
    int32."""
    sf = ((logical >> 60) & 0xF).to(torch.int32)
    shifts = torch.arange(57, -3, -3, device=logical.device, dtype=torch.int64)
    codes = (logical[:, None, :] >> shifts[None, :, None]) & 7
    return sf, codes.to(torch.int32)
