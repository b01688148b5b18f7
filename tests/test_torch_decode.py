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
from qoaudio_tpu_torch.ops import cuda_decode
from qoaudio_tpu_torch.ops.decode import decode_chains, decode_chains_words


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
