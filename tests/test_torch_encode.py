"""The port's encoder (qoaudio_tpu_torch.ops.encode) against the JAX package.

Exact comparisons of words, snapshots and carried state against the XLA
kernel ``qoaudio_tpu.ops.encode.encode_frames`` and against the Pallas
encode kernel's window body run directly on the CPU (it is pure jax
outside the pallas_call plumbing, as tests/test_pallas_interpret.py runs
it).  Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qoaudio_tpu import codec
from qoaudio_tpu.ops.encode import encode_frames as jax_encode_frames
from qoaudio_tpu_torch.ops import cuda_encode
from qoaudio_tpu_torch.ops.encode import encode_frames, encode_frames_full
from qoaudio_tpu_torch.ops.layout import words_from_halves


def _random_windows(seed, F, W, N, masked):
    """Random PCM over the full int16 range, carry in +-65536, random
    lengths (or all 20), samples past each length zeroed."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-32768, 32768, size=(F, W, 20, N)).astype(np.int16)
    if masked:
        lens = rng.integers(0, 21, size=(F, W, N)).astype(np.int32)
    else:
        lens = np.full((F, W, N), 20, np.int32)
    x = np.where(np.arange(20)[None, None, :, None] < lens[:, :, None, :], x, 0)
    carry = rng.integers(-65536, 65536, size=(8, N)).astype(np.int32)
    return x.astype(np.int16), lens, carry


def _jax_words(hi, lo):
    return words_from_halves(
        torch.from_numpy(np.array(hi)), torch.from_numpy(np.array(lo))
    ).numpy()


def _run_port(x, lens, carry, full):
    t = [torch.from_numpy(a) for a in (x, lens, carry)]
    if full:
        out = encode_frames_full(t[2], t[0])
    else:
        out = encode_frames(t[2], t[0], t[1])
    return [o.numpy() for o in out]


@pytest.mark.parametrize(
    "F, W, masked, full, seed",
    [
        (1, 1, False, True, 5),  # one full window, full variant
        (1, 1, True, False, 7),  # one window, random lengths
        (2, 4, True, False, 11),  # F=2 x W=4, random lengths
        (2, 4, False, True, 13),  # F=2 x W=4, full variant
    ],
)
def test_plain_encoder_matches_xla_kernel(F, W, masked, full, seed):
    N = 64
    x, lens, carry = _random_windows(seed, F, W, N, masked)
    w_state, w_snaps, w_hi, w_lo = jax_encode_frames(carry, x, lens)
    state, snaps, words = _run_port(x, lens, carry, full)
    assert state.dtype == np.int32 and words.dtype == np.int64
    assert np.array_equal(state, np.asarray(w_state))
    assert np.array_equal(snaps, np.asarray(w_snaps))
    assert np.array_equal(words, _jax_words(w_hi, w_lo))


def _pallas_window_body(x_i16, lens_or_none, carry):
    from qoaudio_tpu.ops.pallas_encode import _lane_constants, _window_body

    B = carry.shape[1]
    sfbits, recip, mags = _lane_constants(B)
    length = (
        None if lens_or_none is None else jnp.asarray(lens_or_none).reshape(1, B)
    )
    new_carry, wh, wl = _window_body(
        jnp.asarray(x_i16, jnp.int32), length, jnp.asarray(carry),
        sfbits, recip, mags,
    )
    return np.asarray(new_carry), _jax_words(wh, wl)


@pytest.mark.parametrize("masked", [False, True])
def test_plain_encoder_matches_pallas_window_body(masked):
    B = 128
    x, lens, carry = _random_windows(17 if masked else 19, 1, 1, B, masked)
    want_carry, want_words = _pallas_window_body(
        x[0, 0], lens[0, 0] if masked else None, carry
    )
    state, snaps, words = _run_port(x, lens, carry, full=not masked)
    assert np.array_equal(snaps[0], carry)
    assert np.array_equal(words[0, 0], want_words)
    assert np.array_equal(state, want_carry)


def test_plain_encoder_real_stream_windows(fixture_bytes):
    """Real music windows (the fixture's first frame, one window per
    chain) through the port and the Pallas window body."""
    out = codec.decode_all(fixture_bytes)
    x_all, _, _ = codec.layout_pcm(
        out.samples, out.num_channels, out.samples_per_channel
    )
    B = 128
    x = np.zeros((1, 1, 20, B), np.int16)
    for j in range(B):
        x[0, 0, :, j] = x_all[0, j % x_all.shape[1], :, j % 2]
    st = codec.initial_encoder_state(2, B)
    want_carry, want_words = _pallas_window_body(x[0, 0], None, st)
    lens = np.full((1, 1, B), 20, np.int32)
    state, _, words = _run_port(x, lens, st, full=True)
    assert np.array_equal(words[0, 0], want_words)
    assert np.array_equal(state, want_carry)


def test_full_equals_masked_at_full_lengths():
    x, lens, carry = _random_windows(23, 2, 4, 32, masked=False)
    a = _run_port(x, lens, carry, full=True)
    b = _run_port(x, lens, carry, full=False)
    for u, v in zip(a, b):
        assert np.array_equal(u, v)


def test_zero_length_windows_pass_state_through():
    x, lens, carry = _random_windows(29, 1, 3, 16, masked=False)
    lens[:] = 0
    x[:] = 0
    state, snaps, words = _run_port(x, lens, carry, full=False)
    assert np.array_equal(state, carry)
    assert np.array_equal(snaps[0], carry)
    assert not words.any()  # sf 0, all codes 0


def test_wrappers_take_plain_versions_on_cpu():
    x, lens, carry = _random_windows(31, 1, 2, 8, masked=True)
    t = [torch.from_numpy(a) for a in (x, lens, carry)]
    before = (cuda_encode.masked_launches, cuda_encode.full_launches)
    for got, want in zip(
        cuda_encode.encode_frames(t[2], t[0], t[1]),
        encode_frames(t[2], t[0], t[1]),
    ):
        assert torch.equal(got, want)
    for got, want in zip(
        cuda_encode.encode_frames_full(t[2], t[0]), encode_frames_full(t[2], t[0])
    ):
        assert torch.equal(got, want)
    assert (cuda_encode.masked_launches, cuda_encode.full_launches) == before
