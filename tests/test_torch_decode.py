"""The port's decoder (qoaudio_tpu_torch.ops.decode) against the JAX package.

QOA is an integer codec, so every comparison is exact.  Inputs are made
with numpy from a seed and handed to both packages.  The Pallas decode
kernel runs under the TPU interpreter on the CPU, as
tests/test_pallas_interpret.py runs it; the CUDA kernel's wrapper takes
the plain version for CPU tensors (the kernel itself is compared on the
card by tests/test_torch_cuda.py and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package is the reference)

from qoaudio_tpu import bitstream as bs
from qoaudio_tpu import native
from qoaudio_tpu.ops.decode import decode_chains as jax_decode_chains
from qoaudio_tpu_torch import format as port_fmt
from qoaudio_tpu_torch.ops import cuda_decode
from qoaudio_tpu_torch.ops.decode import decode_chains, decode_chains_words

from test_torch_encode import _prmt, _w32  # uint32 wrap and PTX prmt.b32 in numpy


def _wrap_regime_words(seed, W, N):
    """Random logical words over every sf, and LMS state far out of the
    audio range, so the prediction dot and weight updates wrap."""
    rng = np.random.default_rng(seed)
    wl = rng.integers(0, 1 << 63, size=(W, N), dtype=np.int64).astype(
        np.uint64
    ) | (rng.integers(0, 16, size=(W, N), dtype=np.uint64) << np.uint64(60))
    st = rng.integers(-32768, 32768, size=(8, N)).astype(np.int32)
    return wl, st


def _fixture_words(fixture_bytes, W, N):
    pa = bs.parse_file_arrays(fixture_bytes)
    assert pa is not None
    wl = np.zeros((W, N), np.uint64)
    st = np.zeros((8, N), np.int32)
    k = min(N, pa.words_be.shape[1])
    wl[:, :k] = pa.words_be[:W, :k].byteswap()
    st[:, :k] = pa.state[:, :k]
    return wl, st


def _chains(kind, fixture_bytes, W, N):
    if kind == "wrap":
        return _wrap_regime_words(3, W, N)
    return _fixture_words(fixture_bytes, W, N)


def _torch_words_be(wl):
    return torch.from_numpy(wl.byteswap().view(np.int64))


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_decode_chains_matches_jax(seed):
    rng = np.random.default_rng(seed)
    W, N = 6, 48
    st = rng.integers(-65536, 65536, size=(8, N)).astype(np.int32)
    sf = rng.integers(0, 16, size=(W, N)).astype(np.int32)
    codes = rng.integers(0, 8, size=(W, 20, N)).astype(np.int32)
    want = np.asarray(jax_decode_chains(st, sf, codes))
    got = decode_chains(
        torch.from_numpy(st), torch.from_numpy(sf), torch.from_numpy(codes)
    )
    assert got.dtype == torch.int16 and tuple(got.shape) == (W, 20, N)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["wrap", "fixture"])
def test_decode_chains_words_matches_pallas_interpreted(kind, fixture_bytes):
    from jax.experimental.pallas import tpu as pltpu

    from qoaudio_tpu.ops.pallas_decode import LANES, decode_chains_pallas

    subs, wblk = 8, 8
    W, N = wblk, subs * LANES
    wl, st = _chains(kind, fixture_bytes, W, N)
    hi = (wl >> np.uint64(32)).astype(np.uint32)
    lo = (wl & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(decode_chains_pallas(st, hi, lo, subs=subs, wblk=wblk))
    got = decode_chains_words(torch.from_numpy(st), _torch_words_be(wl))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["wrap", "fixture"])
def test_decode_chains_words_matches_native(kind, fixture_bytes):
    if not native.available():
        pytest.skip("native engine unavailable")
    W, N = (32, 96) if kind == "wrap" else (256, 936)
    wl, st = _chains(kind, fixture_bytes, W, N)
    want = native.decode_chains(wl.byteswap(), st)
    got = decode_chains_words(torch.from_numpy(st), _torch_words_be(wl))
    assert np.array_equal(got.numpy(), want)


def test_wrapper_takes_plain_version_on_cpu():
    wl, st = _wrap_regime_words(9, 4, 40)
    before = cuda_decode.launches
    got = cuda_decode.decode_chains_words(torch.from_numpy(st), _torch_words_be(wl))
    want = decode_chains_words(torch.from_numpy(st), _torch_words_be(wl))
    assert torch.equal(got, want)
    assert cuda_decode.launches == before  # nothing launched on the CPU


# ---------------------------------------------------------------------------
# The CUDA kernel's step (csrc/qoa_decode.cu) in numpy, with explicit
# uint32 wrap: the codes unpacked from the word's two 32-bit halves, the
# magnitude picked by one PRMT over the scalefactor's four magnitudes
# packed 16 bits each and signed by a multiply, the weights updated by a
# sign multiply, and the prediction carried from step to step.  Held
# sample for sample against the plain decoder and the JAX package's.
# ---------------------------------------------------------------------------


def _kernel_dequant(wl):
    """The 20 dequantized residuals (20, N) of logical words (N,) uint64,
    as the kernel takes them: sf and the codes from constant shifts of the
    two halves (code 9 by a funnel shift across them; the bits above a
    code are left in place), the magnitude by one PRMT, the sign by a
    multiply with 1 - 2 * (code & 1)."""
    hi = (wl >> np.uint64(32)).astype(np.int64)
    lo = (wl & np.uint64(0xFFFFFFFF)).astype(np.int64)
    v = port_fmt.QOA_SCALEFACTOR_TAB.astype(np.int64)[hi >> 28]
    m = [(3 * v + 2) >> 2, (5 * v + 1) >> 1, (9 * v + 1) >> 1, 7 * v]
    m01 = (m[0] & 0xFFFF) | ((m[1] << 16) & 0xFFFFFFFF)
    m23 = (m[2] & 0xFFFF) | ((m[3] << 16) & 0xFFFFFFFF)
    dq = []
    for k in range(20):
        if k < 9:
            c = hi >> (25 - 3 * k)
        elif k == 9:
            c = ((hi << 2) & 0xFFFFFFFF) | (lo >> 30)
        else:
            c = lo >> (57 - 3 * k)
        mag = _prmt(m01, m23, (c & 6) * 0x1111 + 0x9910)
        dq.append(_w32(mag * _w32((c & 1) * 0xFFFFFFFE + 1)))
    return np.stack(dq)


def _kernel_decode(st, wl):
    """decode_chains_words as the kernel steps it.  st (8, N) int32, wl
    (W, N) logical uint64.  Returns (W, 20, N) int16."""
    c = st.astype(np.int64)
    h, w = [c[i] for i in range(4)], [c[4 + i] for i in range(4)]
    s = [(x >> 31) | 1 for x in h]  # each sample's sign, taken once
    pred = _w32(sum(_w32(w[i] * h[i]) for i in range(4))) >> 13  # only here a 4-tap dot
    out = np.zeros((wl.shape[0], 20, wl.shape[1]), np.int16)
    for win in range(wl.shape[0]):
        dq = _kernel_dequant(wl[win])
        for k in range(20):
            delta = dq[k] >> 4
            wn = [_w32(s[i] * delta + w[i]) for i in range(4)]
            older = _w32(wn[0] * h[1])
            older = _w32(wn[1] * h[2] + older)
            older = _w32(wn[2] * h[3] + older)
            # the same sum from the state at step start (the encoder's form)
            a = _w32(sum(_w32(w[i] * h[i + 1]) for i in range(3)))
            b = _w32(sum(s[i] * h[i + 1] for i in range(3)))
            assert np.array_equal(older, _w32(a + _w32(delta * b)))
            x = pred + dq[k]
            assert np.abs(x).max() < 1 << 19  # |pred| <= 2^18, |dq| < 2^14
            r = np.clip(x, -32768, 32767)
            pred = _w32(wn[3] * r + older) >> 13
            out[win, k] = r
            h, w, s = h[1:] + [r], wn, s[1:] + [(r >> 31) | 1]
            # the sign that is carried is the sample's, and the carried
            # prediction is the direct 4-tap dot of the new state, exactly
            assert all(np.array_equal(u, np.where(t < 0, -1, 1)) for u, t in zip(s, h))
            assert np.array_equal(pred, _w32(sum(_w32(w[i] * h[i]) for i in range(4))) >> 13)
    return out


def _int32_weight_words(seed, W, N):
    """Random words over every sf; history over int16 and weights over all
    of int32: the dot and the weight update wrap at every step."""
    rng = np.random.default_rng(seed)
    wl, _ = _wrap_regime_words(seed, W, N)
    st = np.concatenate([rng.integers(-32768, 32768, size=(4, N)),
                         rng.integers(-(1 << 31), 1 << 31, size=(4, N))]).astype(np.int32)
    return wl, st


def _every_code_words():
    """16 x 8 x 20 one-window chains: every scalefactor with every code in
    every slot, the other slots random."""
    rng = np.random.default_rng(41)
    sf, code, slot = (a.reshape(-1) for a in np.meshgrid(
        np.arange(16), np.arange(8), np.arange(20), indexing="ij"))
    codes = rng.integers(0, 8, size=(20, sf.size))
    codes[slot, np.arange(sf.size)] = code
    wl = sf.astype(np.uint64) << np.uint64(60)
    for k in range(20):
        wl |= codes[k].astype(np.uint64) << np.uint64(57 - 3 * k)
    st = rng.integers(-32768, 32768, size=(8, sf.size)).astype(np.int32)
    return wl[None], st, (sf, codes)


def _kernel_step_inputs(kind, fixture_bytes):
    if kind == "random":
        rng = np.random.default_rng(5)
        wl, _ = _wrap_regime_words(5, 6, 64)
        return wl, rng.integers(-65536, 65536, size=(8, 64)).astype(np.int32)
    if kind == "wrap":
        return _int32_weight_words(6, 6, 64)
    if kind == "fixture":
        return _fixture_words(fixture_bytes, 24, 40)
    wl, st, _ = _every_code_words()
    return wl, st


@pytest.mark.parametrize("kind", ["random", "wrap", "fixture", "every_code"])
def test_kernel_step_form_matches_plain_and_jax(kind, fixture_bytes):
    """Tolerance 0: an integer codec."""
    wl, st = _kernel_step_inputs(kind, fixture_bytes)
    got = _kernel_decode(st, wl)
    want = decode_chains_words(torch.from_numpy(st), _torch_words_be(wl)).numpy()
    assert np.array_equal(got, want)
    sf = (wl >> np.uint64(60)).astype(np.int32)
    codes = np.stack([((wl >> np.uint64(57 - 3 * k)) & np.uint64(7)).astype(np.int32)
                      for k in range(20)], 1)
    assert np.array_equal(got, np.asarray(jax_decode_chains(st, sf, codes)))


def test_kernel_step_form_matches_pallas_interpreted_wrap():
    """The kernel's step against the Pallas kernel under the interpreter,
    from weights over all of int32."""
    from jax.experimental.pallas import tpu as pltpu

    from qoaudio_tpu.ops.pallas_decode import LANES, decode_chains_pallas

    subs, wblk = 8, 8
    wl, st = _int32_weight_words(8, wblk, subs * LANES)
    hi = (wl >> np.uint64(32)).astype(np.uint32)
    lo = (wl & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(decode_chains_pallas(st, hi, lo, subs=subs, wblk=wblk))
    assert np.array_equal(_kernel_decode(st[:, :96], wl[:, :96]), want[:, :, :96])
    got = decode_chains_words(torch.from_numpy(st), _torch_words_be(wl))
    assert np.array_equal(got.numpy(), want)


def test_kernel_dequantizer_over_every_scalefactor_and_code():
    wl, _, (sf, codes) = _every_code_words()
    want = port_fmt.QOA_DEQUANT_TAB.astype(np.int64)[sf[None, :], codes]
    assert np.array_equal(_kernel_dequant(wl[0]), want)
    assert np.abs(want).max() == 7 * 2048 < 1 << 15  # fits the packed 16 bits


@pytest.mark.parametrize("W, N", [(1, 4097), (1, 1), (3, 65)])
def test_plain_decode_ragged_shapes_match_native(W, N):
    """The shapes the card's ragged check uses (N not a multiple of a
    block, one window), from weights over all of int32."""
    if not native.available():
        pytest.skip("native engine unavailable")
    wl, st = _int32_weight_words(W + N, W, N)
    got = decode_chains_words(torch.from_numpy(st), _torch_words_be(wl))
    assert np.array_equal(got.numpy(), native.decode_chains(wl.byteswap(), st))
