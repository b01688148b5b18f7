"""The port's encoder (qoaudio_tpu_torch.ops.encode) against the JAX package.

Exact comparisons of words, snapshots and carried state against the XLA
kernel ``qoaudio_tpu.ops.encode.encode_frames`` and against the Pallas
encode kernel's window body run directly on the CPU (it is pure jax
outside the pallas_call plumbing, as tests/test_pallas_interpret.py runs
it), and the CUDA kernel's rewritten step, written out in numpy, against
the plain encoder.  Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qoaudio_tpu import codec
from qoaudio_tpu.ops.encode import encode_frames as jax_encode_frames
from qoaudio_tpu_torch import format as port_fmt
from qoaudio_tpu_torch.ops import cuda_encode
from qoaudio_tpu_torch.ops import encode as plain
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


# ---------------------------------------------------------------------------
# The CUDA kernel's rewritten step (csrc/qoa_encode.cu::run_window) in
# numpy: the prediction taken incrementally, qoa_div's product as one
# multiply-add after the prediction and its sign fix as max/min and a
# clamp, the dequantized value picked by PRMT from packed 16-bit
# magnitudes, and the rank split into a 64-bit err^2 sum and a uint32
# penalty^2 sum.  Held against the plain encoder's window
# (ops/encode.py::_encode_window), candidate by candidate.
# ---------------------------------------------------------------------------


def _w32(v):
    """int64 -> the int32 it wraps to, kept as int64."""
    return ((np.asarray(v, np.int64) + (1 << 31)) % (1 << 32)) - (1 << 31)


def _prmt(lo, hi, sel):
    """PTX prmt.b32 (default mode) on uint32 values held in int64."""
    src = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    out = np.zeros(np.broadcast(lo, sel).shape, np.int64)
    for n in range(4):
        nib = (sel >> (4 * n)) & 0xF
        byte = ((src >> ((nib & 7) * 8).astype(np.uint64)) & np.uint64(0xFF)).astype(np.int64)
        byte = np.where(nib & 8, np.where(byte & 0x80, 0xFF, 0), byte)
        out |= byte << (8 * n)
    return _w32(out)


def _candidates():
    """(recip, pos01, pos23, neg01, neg23) per lane, each (16, 1) int64."""
    v = port_fmt.QOA_SCALEFACTOR_TAB.astype(np.int64)
    m = [(3 * v + 2) >> 2, (5 * v + 1) >> 1, (9 * v + 1) >> 1, 7 * v]
    assert np.array_equal(np.stack(m, 1), port_fmt.QOA_DEQUANT_MAG)

    def pack16(a, b):
        return (a & 0xFFFF) | ((b << 16) & 0xFFFFFFFF)

    col = [port_fmt.QOA_RECIPROCAL_TAB.astype(np.int64), pack16(m[0], m[1]),
           pack16(m[2], m[3]), pack16(-m[0], -m[1]), pack16(-m[2], -m[3])]
    return [c[:, None] for c in col]


def _scaled(x, pred, recip):
    """qoa_div as the kernel writes it: p = pred * -recip + (x * recip +
    2^15), then nq - sgn(nq) + sgn(residual) as max(nq - 1, 0) +
    min(nq + 1, 0) + clamp(x - pred, -1, 1)."""
    nq = _w32(pred * -recip + x * recip + 32768) >> 16
    return np.maximum(nq - 1, 0) + np.minimum(nq + 1, 0) + np.clip(x - pred, -1, 1)


def _dequantize(scaled, cand):
    """(code, dq) as the kernel picks them: sign, index, one PRMT."""
    _, pos01, pos23, neg01, neg23 = cand
    neg = (scaled < 0).astype(np.int64)
    idx = np.minimum(np.abs(scaled) >> 1, 3)
    dq = _prmt(np.where(neg == 1, neg01, pos01), np.where(neg == 1, neg23, pos23),
               idx * 0x2222 + 0x9910)
    return idx * 2 + neg, dq


def _kernel_window(h, w, pred, x, length):
    """One window, 16 lanes x N chains, as the kernel runs it.  h, w: (4,
    16, N); pred (16, N); x (20, N); length (N,) or None.  Returns the
    lanes' h, w, pred, total and first ranks and words, each lane's own."""
    cand = _candidates()
    h, w = [r.copy() for r in h], [r.copy() for r in w]
    n = x.shape[1]
    err_sum = np.zeros((16, n), np.int64)
    pen_sum = np.zeros((16, n), np.int64)
    first = err_sum
    hi = np.broadcast_to(np.arange(16, dtype=np.int64)[:, None] << 28, (16, n)).copy()
    lo = np.zeros((16, n), np.int64)
    for k in range(20):
        active = np.ones(n, bool) if length is None else length > k
        sg = [np.where(r < 0, -1, 1) for r in h]
        a = _w32(sum(_w32(w[i] * h[i + 1]) for i in range(3)))
        b = _w32(sum(sg[i] * h[i + 1] for i in range(3)))
        pen = np.maximum((_w32(sum(_w32(r * r) for r in w)) >> 18) - 0x8FF, 0)
        code, dq = _dequantize(_scaled(x[k], pred, cand[0]), cand)
        recon = np.clip(pred + dq, -32768, 32767)
        delta = dq >> 4
        w3 = _w32(w[3] + sg[3] * delta)
        nxt = _w32(a + _w32(delta * b) + _w32(w3 * recon)) >> 13
        new_w = [_w32(w[i] + sg[i] * delta) for i in range(3)] + [w3]
        new_h = h[1:] + [recon]
        # the incremental prediction is the direct one, exactly
        assert np.array_equal(nxt, _w32(sum(_w32(new_w[i] * new_h[i]) for i in range(4))) >> 13)
        err = x[k] - recon
        err_sum = err_sum + np.where(active, err * err, 0)
        pen_sum = pen_sum + np.where(active, pen * pen, 0)
        assert pen_sum.max() < 1 << 31  # the kernel's uint32 sum
        code = np.where(active, code, 0)
        if k < 9:
            hi = hi + (code << (25 - 3 * k))
        elif k == 9:
            hi, lo = hi + (code >> 2), lo + ((code << 30) & 0xFFFFFFFF)
        else:
            lo = lo + (code << (57 - 3 * k))
        h = [np.where(active, u, v) for u, v in zip(new_h, h)]
        w = [np.where(active, u, v) for u, v in zip(new_w, w)]
        pred = np.where(active, nxt, pred)
        if k == 0:
            first = err_sum + pen_sum
    words = (hi.astype(np.uint64) << np.uint64(32) | lo.astype(np.uint64)).view(np.int64)
    return h, w, pred, err_sum + pen_sum, first, words


def _plain_window(carry, x, length, sf=None):
    """ops/encode.py::_encode_window; with ``sf`` every lane is that
    candidate, so the window returns candidate ``sf``'s own result."""
    recip, dq_tab, row8, quant_tab, sfbits = plain._lane_constants("cpu")
    if sf is not None:
        recip, row8, sfbits = (t[sf : sf + 1].expand(16, 1) for t in (recip, row8, sfbits))
    length = None if length is None else torch.from_numpy(length.astype(np.int32))
    c, word = plain._encode_window(torch.from_numpy(carry), torch.from_numpy(x.astype(np.int32)),
                                   length, (recip, dq_tab, row8, quant_tab, sfbits))
    return c.numpy(), word.numpy()


def _states(seed, n, regime):
    rng = np.random.default_rng(seed)
    if regime == "wrap":  # weights over all of int32: the dot, qoa_div
        w = rng.integers(-(1 << 31), 1 << 31, size=(4, n))  # and the update wrap
        h = rng.integers(-32768, 32768, size=(4, n))
    else:
        w = rng.integers(-65536, 65536, size=(4, n))
        h = rng.integers(-65536, 65536, size=(4, n))
    return np.concatenate([h, w]).astype(np.int32)


@pytest.mark.parametrize("regime", ["random", "wrap"])
@pytest.mark.parametrize("short", [False, True])
def test_kernel_step_form_matches_plain_window(regime, short):
    N, W = 48, 3
    rng = np.random.default_rng(101 + 2 * short + (regime == "wrap"))
    carry = _states(7 + short, N, regime)
    for win in range(W):
        x = rng.integers(-32768, 32768, size=(20, N))
        length = rng.integers(0, 21, size=N) if short else None
        if short:
            x = np.where(np.arange(20)[:, None] < length, x, 0)
        c64 = carry.astype(np.int64)
        h = [np.broadcast_to(c64[i], (16, N)) for i in range(4)]
        w = [np.broadcast_to(c64[4 + i], (16, N)) for i in range(4)]
        pred = np.broadcast_to(_w32(sum(_w32(c64[4 + i] * c64[i]) for i in range(4))) >> 13,
                               (16, N))
        kh, kw, _, total, first, words = _kernel_window(h, w, pred, x, length)
        lanes = np.stack(kh + kw)  # (8, 16, N)
        for sf in range(16):  # every candidate's own LMS and word
            c_sf, word_sf = _plain_window(carry, x, length, sf)
            assert np.array_equal(lanes[:, sf], c_sf), (regime, short, win, sf)
            assert np.array_equal(words[sf], word_sf), (regime, short, win, sf)
        # the argmin over (total, first, sf) picks the plain window's winner
        pick = np.lexsort((np.arange(16)[:, None].repeat(N, 1), first, total), axis=0)[0]
        want_carry, want_word = _plain_window(carry, x, length)
        got_carry = lanes[:, pick, np.arange(N)]
        assert np.array_equal(got_carry, want_carry)
        assert np.array_equal(words[pick, np.arange(N)], want_word)
        carry = want_carry.astype(np.int32)


def test_kernel_quantizer_form_over_every_scaled_value():
    scaled = np.arange(-(1 << 15) - 2, (1 << 15) + 3, dtype=np.int64)[None, :]
    code, dq = _dequantize(scaled, _candidates())
    want_code = port_fmt.QOA_QUANT_TAB[np.clip(scaled, -8, 8) + 8].astype(np.int64)
    assert np.array_equal(code, np.broadcast_to(want_code, code.shape))
    want_dq = port_fmt.QOA_DEQUANT_TAB.astype(np.int64)[np.arange(16)[:, None], want_code]
    assert np.array_equal(dq, want_dq)


def test_kernel_qoa_div_sign_fix_over_every_residual():
    # |residual| < 2^15 + 2^18 (|s| <= 2^15, |pred| < 2^18): sf 0 and 1 wrap
    residual = np.arange(-(1 << 18) - (1 << 15), (1 << 18) + (1 << 15) + 1, dtype=np.int64)
    x = np.random.default_rng(3).integers(-32768, 32768, size=residual.shape)
    for recip in port_fmt.QOA_RECIPROCAL_TAB.astype(np.int64):
        nq = _w32(residual * recip + 32768) >> 16
        want = nq + np.sign(residual) - np.sign(nq)
        assert np.array_equal(_scaled(x, x - residual, recip), want), recip
